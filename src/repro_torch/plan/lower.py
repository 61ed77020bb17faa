"""Lowering bridge: a :class:`repro_torch.core.dataflow.Graph` → a
:class:`repro_torch.core.perfsim.Sim` task DAG.

Counterpart of ``repro/plan/lower.py``, copied in the same floating-point
operation order, so a graph lowers to the same tasks and makespan in both
packages. The MoE ops (``route``, ``a2a_ffn``, ``unroute``,
``bwd_a2a_ffn``) lower here although the port's model path has no MoE
period yet (ROADMAP A10).

This is what puts the perfsim cost model *in the optimization loop* (the
"compute-aware" half of the paper's title): any post-pass-2 graph — sublayer,
whole block, multi-block period, microbatch-split period — lowers to COMP /
WF / WB tasks whose durations come from GEMM FLOP counts and the Fig.-10
per-direction byte accounting (:func:`repro_torch.core.perfsim.dir_bytes`), so the
search in :mod:`repro_torch.plan.search` can score candidate schedules by simulated
makespan instead of a greedy topological heuristic.

Shape propagation tracks GLOBAL logical shapes per value (the perfsim ``m``
convention: a collective's payload is the full gathered activation's bytes);
GEMM FLOPs are global too and divided by the TP degree at task-emission time,
exactly like :func:`repro_torch.core.perfsim.schedule_phases`. Local math the cost
model cannot see inside (``custom`` / ``route`` / ``unroute``) lowers to a
zero-duration COMP task — it keeps the dependency structure and costs nothing,
which is conservative for *ranking* schedules because it is identical across
candidates. Per-node FLOP hints (``comp_hints``) override that default.

The chunk-granularity lowering mirrors ``schedule_phases``' CAIS branch: wire
chains free-run with cross-phase continuity, ``serial_frac`` of each chunk's
compute trails its arriving data, and ``overlap_asym`` interleaves its RS and
AG sides chunk-by-chunk on the shared WF/WB resources — which is precisely
why an up-dominated RS paired with a down-dominated AG beats two serial
collectives, and what the search exploits when it picks pairings.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import dataflow as df
from repro_torch.core import perfsim as ps
from repro_torch.core.perfsim import COMP, WB, WF, Fabric, Policy, Sim

# Backend name → perfsim schedule policy. "cais" is the paper's chunked
# bidirectional schedule; "barrier" is the monolithic NVLS-style phase
# structure; anything unknown falls back to barrier (the conservative model).
_POLICIES = {
    "cais": ps.BASELINES["CAIS"],
    "barrier": ps.BASELINES["SP-NVLS"],
}


def policy_for_backend(backend: str, num_chunks: Optional[int] = None
                       ) -> Policy:
    """The perfsim :class:`Policy` modelling a collective backend, with an
    optional per-collective chunk override."""
    import dataclasses

    p = _POLICIES.get(backend, _POLICIES["barrier"])
    if num_chunks:
        p = dataclasses.replace(p, chunks=int(num_chunks))
    return p


def fabric_from_hw(hw, n: int, mxu_eff: float = 0.55,
                   n_outer: int = 1) -> Fabric:
    """A perfsim fabric from a :class:`repro_torch.hw.HWSpec` — the bridge the
    ``tp.sp_period`` planner path uses so the cost model and the α-β
    coordination planner read the same target-hardware numbers.
    ``n_outer > 1`` builds a two-tier fabric for a hierarchical 2D-TP mesh:
    the inter-node tier reads the spec's DCN α-β terms, so the planner can
    price (and chunk) each tier separately (docs/topology.md)."""
    f = Fabric(n=n, bw=hw.ici_bw, alpha=hw.hop_latency,
               peak=hw.peak_flops, mxu_eff=mxu_eff)
    if n_outer > 1:
        import dataclasses
        f = dataclasses.replace(
            f, n_outer=int(n_outer),
            bw2=getattr(hw, "dcn_bw", hw.ici_bw),
            alpha2=getattr(hw, "dcn_latency", hw.hop_latency))
    return f


def synthesize_shapes(g: df.Graph, batch: int = 8, seq: int = 512,
                      model_dim: int = 1024
                      ) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """Default (value_shapes, weight_shapes) for a graph whose real shapes
    are unknown (``dataflow.optimize(planner="perfsim")`` called outside the
    model path): every graph input is a (batch, seq, model_dim) activation
    and every GEMM is square. Uniform sizes still rank *pairings* correctly
    on symmetric graphs — the ranking then depends only on schedule
    structure, which is what the planner decides."""
    value_shapes = {}
    weight_shapes: Dict[str, tuple] = {}
    for n in g.nodes:
        if n.op == "input":
            value_shapes[n.name] = (batch, seq, model_dim)
        for w in n.weights:
            weight_shapes.setdefault(w, (model_dim, model_dim))
    return value_shapes, weight_shapes


@dataclass
class _State:
    """Wire/compute chain continuity across phases (schedule_phases' wdep /
    gdep), plus the value → exit-task map the node walk threads through."""

    wdep: Dict[str, Optional[int]] = field(
        default_factory=lambda: {WF: None, WB: None})
    gdep: Optional[int] = None
    exits: Dict[str, Tuple[int, ...]] = field(default_factory=dict)


class Lowering:
    """One lowering of a graph onto a :class:`Sim`.

    Parameters
    ----------
    fabric / policy:
        The cost model (``fabric.n`` is the TP ring size).
    value_shapes:
        Global logical shape per graph ``input`` value.
    weight_shapes:
        Global logical shape per weight key (2-D entries are GEMM weights;
        1-D norm scales are ignored for FLOPs).
    dtype_bytes:
        Activation element size (payload bytes = prod(shape) · dtype_bytes).
    num_chunks:
        Per-collective chunk override (None → ``policy.chunks``). On a
        two-tier fabric an ``(inner, outer)`` pair sets a DIFFERENT chunk
        count per tier — the per-axis chunking the planner sweeps.
    comp_hints:
        Optional node-name → global FLOPs for fn-carrying local math.
    """

    def __init__(self, fabric: Fabric, policy: Policy,
                 value_shapes: Dict[str, tuple],
                 weight_shapes: Dict[str, tuple],
                 dtype_bytes: int = 4,
                 num_chunks=None,
                 comp_hints: Optional[Dict[str, float]] = None):
        self.f = fabric
        self.p = policy
        self.value_shapes = dict(value_shapes)
        self.weight_shapes = dict(weight_shapes)
        self.dtype_bytes = int(dtype_bytes)
        if isinstance(num_chunks, (tuple, list)):
            self.chunks = int(num_chunks[0] or policy.chunks)
            self.chunks_outer = int(num_chunks[-1] or policy.chunks)
        else:
            self.chunks = int(num_chunks or policy.chunks)
            self.chunks_outer = self.chunks
        self.comp_hints = dict(comp_hints or {})

    # -- shape/cost helpers -------------------------------------------------

    def _bytes(self, shape: tuple) -> float:
        return float(math.prod(shape)) * self.dtype_bytes

    def _gemm_flops(self, in_shape: tuple, wkeys: Sequence[str]) -> float:
        """Σ 2·(tokens)·din·dout over the GEMM (2-D) weights of a fused op."""
        tokens = math.prod(in_shape[:-1])
        total = 0.0
        for k in wkeys:
            w = self.weight_shapes.get(k)
            if w is not None and len(w) == 2:
                total += 2.0 * tokens * w[0] * w[1]
        return total

    def _gemm_outs(self, in_shape: tuple, wkeys: Sequence[str]) -> list:
        return [in_shape[:-1] + (w[1],)
                for k in wkeys
                if (w := self.weight_shapes.get(k)) is not None
                and len(w) == 2]

    # -- task emission ------------------------------------------------------

    def _comp(self, sim: Sim, st: _State, flops: float, deps) -> List[int]:
        dur = flops / self.f.n / (self.f.peak * self.f.mxu_eff) \
            * self.p.compute_mult
        return [sim.add(COMP, dur, tuple(deps))]

    def _legs(self, coll: str, m: float) -> List[tuple]:
        """The per-tier wire legs of one collective:
        ``(coll, payload, ring, bw, alpha, chunks, carries_compute)``.
        Single-tier fabrics emit one leg. Two-tier fabrics decompose the
        way the hierarchical backends execute (docs/topology.md): AG =
        inter-node exchange then intra-node gather; RS = intra-node scatter
        then inter-node exchange; AR = intra-RS → inter-AR → intra-AG. The
        inter-node leg moves 1/n_inner of the gathered payload on the
        (bw2, alpha2) tier with its own chunk count. The fused GEMM always
        rides the compute-adjacent INNER leg."""
        f = self.f
        if not f.two_tier:
            return [(coll, m, f.n, f.bw, f.alpha, self.chunks, True)]
        n_in = f.n_inner
        a2 = f.alpha2 if f.alpha2 is not None else f.alpha

        def inner(cl, comp):
            return (cl, m, n_in, f.bw, f.alpha, self.chunks, comp)

        def outer(cl):
            return (cl, m / n_in, f.n_outer, f.bw2, a2,
                    self.chunks_outer, False)

        if coll == "ag":
            return [outer("ag"), inner("ag", True)]
        if coll == "rs":
            return [inner("rs", True), outer("rs")]
        return [inner("rs", True), outer("ar"), inner("ag", False)]

    def _leg_phase(self, sim: Sim, st: _State, flops: float, m: float,
                   coll: str, n: int, bw: float, alpha: float, chunks: int,
                   deps: Sequence[int]) -> List[int]:
        """One wire leg (+ its riding GEMM compute, if any) under the
        policy's granularity. Returns the exit task ids."""
        f, p = self.f, self.p
        t_comp = flops / f.n / (f.peak * f.mxu_eff) * p.compute_mult
        bf, bb = ps.dir_bytes(p, coll, m, n)

        if p.granularity == "barrier":
            g = sim.add(COMP, t_comp, tuple(deps))
            fb = f if (bw == f.bw and alpha == f.alpha) else \
                ps.replace(f, bw=bw, alpha=alpha)
            ws = ps._emit_barrier_wire(sim, bf, bb, fb, p, (g,),
                                       chunks=max(1, n - 1))
            return ws or [g]

        # chunk granularity (cais): wire chains free-run with continuity
        # across phases; serial_frac of per-chunk compute trails its data
        c = chunks
        last: List[int] = []
        for _ in range(c):
            ws: List[int] = []
            for res, b in ((WF, bf), (WB, bb)):
                if b <= 0:
                    continue
                wdeps = ([st.wdep[res]] if st.wdep[res] is not None
                         else list(deps))
                w = sim.add(res, b / c / bw + alpha, wdeps)
                st.wdep[res] = w
                ws.append(w)
            gs = sim.add(COMP, p.serial_frac * t_comp / c, ws or list(deps))
            g = sim.add(COMP, (1 - p.serial_frac) * t_comp / c,
                        [gs] + ([st.gdep] if st.gdep is not None else []))
            st.gdep = g
            last = [g] + ws
        return last

    def _phase(self, sim: Sim, st: _State, flops: float, m: float,
               coll: Optional[str], deps: Sequence[int]) -> List[int]:
        """One (GEMM, adjacent collective) unit — the perfsim Phase — under
        the policy's granularity, decomposed into per-tier legs on a
        two-tier fabric. Returns the exit task ids."""
        if coll is None:
            return self._comp(sim, st, flops, deps)
        out = list(deps)
        for lcoll, lm, ln, lbw, lalpha, lc, carries in self._legs(coll, m):
            out = self._leg_phase(sim, st, flops if carries else 0.0, lm,
                                  lcoll, ln, lbw, lalpha, lc, out)
        return out

    def _overlap_phases(self, sim: Sim, st: _State,
                        sides: List[Tuple[float, float, str]],
                        deps: Sequence[int]) -> List[int]:
        """Co-scheduled phases (overlap_asym): chunk s of every side is
        emitted before chunk s+1 of any, so the sides' complementary wire
        directions interleave on the shared WF/WB resources — the Fig. 9e
        asymmetric overlap. Under barrier granularity the sides just
        serialize (a barrier backend cannot overlap them)."""
        f, p = self.f, self.p
        if p.granularity == "barrier":
            out: List[int] = []
            for flops, m, coll in sides:
                out += self._phase(sim, st, flops, m, coll, deps)
            return out
        # Two-tier fabric: only the compute-adjacent INNER legs interleave
        # (ring n_inner); an AG side's inter-node exchange precedes its
        # chunks, an RS/AR side's trails them — the outer tier cannot be
        # chunk-interleaved by an intra-node merge table.
        two = f.two_tier
        n_ring = f.n_inner if two else f.n
        side_deps: List[List[int]] = [list(deps) for _ in sides]
        inner_colls: List[str] = []
        for i, (flops, m, coll) in enumerate(sides):
            inner_colls.append("rs" if (two and coll == "ar") else coll)
            if two and coll == "ag":
                side_deps[i] = list(self._leg_phase(
                    sim, st, 0.0, m / n_ring, "ag", f.n_outer, f.bw2,
                    f.alpha2 if f.alpha2 is not None else f.alpha,
                    self.chunks_outer, side_deps[i]))
        c = self.chunks
        gdeps: List[Optional[int]] = [st.gdep] * len(sides)
        last: List[int] = []
        for _ in range(c):
            step: List[int] = []
            for i, (flops, m, coll) in enumerate(sides):
                t_comp = flops / f.n / (f.peak * f.mxu_eff) * p.compute_mult
                bf, bb = ps.dir_bytes(p, inner_colls[i], m, n_ring)
                ws: List[int] = []
                for res, b in ((WF, bf), (WB, bb)):
                    if b <= 0:
                        continue
                    wdeps = ([st.wdep[res]] if st.wdep[res] is not None
                             else side_deps[i])
                    w = sim.add(res, b / c / f.bw + f.alpha, wdeps)
                    st.wdep[res] = w
                    ws.append(w)
                gs = sim.add(COMP, p.serial_frac * t_comp / c,
                             ws or side_deps[i])
                g = sim.add(COMP, (1 - p.serial_frac) * t_comp / c,
                            [gs] + ([gdeps[i]] if gdeps[i] is not None
                                    else []))
                gdeps[i] = g
                step += [g] + ws
            last = step
        st.gdep = max(g for g in gdeps if g is not None) \
            if any(g is not None for g in gdeps) else st.gdep
        if two:
            a2 = f.alpha2 if f.alpha2 is not None else f.alpha
            for i, (flops, m, coll) in enumerate(sides):
                if coll not in ("rs", "ar"):
                    continue
                dep = [gdeps[i]] if gdeps[i] is not None else list(deps)
                t = self._leg_phase(sim, st, 0.0, m / n_ring,
                                    "rs" if coll == "rs" else "ar",
                                    f.n_outer, f.bw2, a2,
                                    self.chunks_outer, dep)
                if coll == "ar":
                    t = self._leg_phase(sim, st, 0.0, m, "ag", n_ring,
                                        f.bw, f.alpha, self.chunks, t)
                last = last + list(t)
        return last

    # -- the node walk ------------------------------------------------------

    def lower(self, g: df.Graph) -> Sim:
        """Emit the whole graph (nodes in topo order) onto a fresh Sim."""
        sim = Sim()
        st = _State()
        shapes = dict(self.value_shapes)
        nodes = df._topo(list(g.nodes), g.outputs)

        def deps_of(n: df.Node) -> List[int]:
            out: List[int] = []
            for v in n.inputs:
                out += st.exits.get(v, ())
            return out

        def set_exits(n: df.Node, tids: Sequence[int],
                      out_shapes: Sequence[tuple]):
            for v, s in zip(n.outputs, out_shapes):
                shapes[v] = s
                st.exits[v] = tuple(tids)

        for n in nodes:
            if n.op == "input":
                if n.name not in shapes:
                    raise KeyError(
                        f"lowering needs a value shape for graph input "
                        f"{n.name!r}")
                st.exits[n.name] = ()
                continue
            deps = deps_of(n)
            ins = [shapes[v] for v in n.inputs]
            x = ins[0]

            if n.op in ("gemm_col", "gemm_row"):
                outs = self._gemm_outs(x, n.weights) or [x]
                t = self._comp(sim, st, self._gemm_flops(x, n.weights), deps)
                set_exits(n, t, outs)
            elif n.op in ("allgather", "reduce_scatter", "allreduce"):
                coll = {"allgather": "ag", "reduce_scatter": "rs",
                        "allreduce": "ar"}[n.op]
                t = self._phase(sim, st, 0.0, self._bytes(x), coll, deps)
                set_exits(n, t, [x])
            elif n.op in ("layernorm", "add", "residual", "custom",
                          "route", "unroute"):
                t = self._comp(sim, st, self.comp_hints.get(n.name, 0.0),
                               deps)
                set_exits(n, t, [x] * len(n.outputs))
            elif n.op == "a2a_ffn":
                # expert all-to-all: dispatch + combine each move the send
                # buffer once per direction (ar-like both-direction traffic)
                t = self._phase(sim, st,
                                self.comp_hints.get(n.name, 0.0),
                                self._bytes(x), "ar", deps)
                set_exits(n, t, [x])
            elif n.op == "bwd_a2a_ffn":
                # adjoint expert all-to-all: the grad dispatch carries the
                # send buffer AND the output cotangent (2× the forward
                # payload per direction), the combine returns the chunk
                # cotangents; the expert-VJP FLOPs come from comp_hints
                # (tp._bwd_planner doubles the forward hint for adj. nodes)
                m = self._bytes(x) + self._bytes(ins[1])
                t = self._phase(sim, st,
                                self.comp_hints.get(n.name, 0.0), m,
                                "ar", deps)
                set_exits(n, t, [x] + [self.weight_shapes.get(k, x)
                                       for k in n.weights])
            elif n.op in ("ag_gemm", "ag_gemm_multi"):
                outs = self._gemm_outs(x, n.weights) or [x]
                t = self._phase(sim, st, self._gemm_flops(x, n.weights),
                                self._bytes(x), "ag", deps)
                set_exits(n, t, outs)
            elif n.op in ("gemm_rs", "gemm_ar"):
                outs = self._gemm_outs(x, n.weights) or [x]
                coll = "rs" if n.op == "gemm_rs" else "ar"
                t = self._phase(sim, st, self._gemm_flops(x, n.weights),
                                self._bytes(outs[0]), coll, deps)
                set_exits(n, t, outs)
            elif n.op == "bwd_ag_gemm":
                # adjoint of gemm_rs (docs/training.md): AG the seq-sharded
                # cotangent (payload = the full gathered cotangent, same
                # convention as ag_gemm), GEMM against the transposed
                # weight; the gathered cotangent re-exposes for dw consumers
                outs = self._gemm_outs(x, n.weights) or [x]
                t = self._phase(sim, st, self._gemm_flops(x, n.weights),
                                self._bytes(x), "ag", deps)
                set_exits(n, t, outs + [x])
            elif n.op in ("fused_rs_ln_ag", "fused_rs_ln_ag_multi",
                          "fused_rs_ln"):
                # weights = (w1, scale, *w2s): the RS-side GEMM, the norm
                # scale, then the AG-side GEMM weights (absent in
                # fused_rs_ln). Phase 1: gemm→RS of z; phase 2: AG→gemms.
                w1 = n.weights[0]
                z = self._gemm_outs(x, (w1,))
                z_shape = z[0] if z else x
                t1 = self._phase(sim, st, self._gemm_flops(x, (w1,)),
                                 self._bytes(z_shape), "rs", deps)
                if n.op == "fused_rs_ln":
                    set_exits(n, t1, [z_shape, z_shape])
                else:
                    w2s = n.weights[2:]
                    outs = self._gemm_outs(z_shape, w2s) or [z_shape]
                    t2 = self._phase(sim, st,
                                     self._gemm_flops(z_shape, w2s),
                                     self._bytes(z_shape), "ag", t1)
                    set_exits(n, t2, outs + [z_shape])
            elif n.op == "overlap_asym":
                # inputs = (x_rs, x_ag); weights = (w_rs, *w_ags)
                x_rs, x_ag = ins[0], ins[1]
                w_rs, w_ags = n.weights[0], n.weights[1:]
                rs_out = self._gemm_outs(x_rs, (w_rs,))
                rs_shape = rs_out[0] if rs_out else x_rs
                ag_outs = self._gemm_outs(x_ag, w_ags) or [x_ag]
                t = self._overlap_phases(
                    sim, st,
                    [(self._gemm_flops(x_rs, (w_rs,)),
                      self._bytes(rs_shape), "rs"),
                     (self._gemm_flops(x_ag, w_ags),
                      self._bytes(x_ag), "ag")],
                    deps)
                set_exits(n, t, [rs_shape] + ag_outs)
            else:
                raise ValueError(f"lowering does not know op {n.op!r}")
        return sim


def lower_graph(g: df.Graph, fabric: Fabric, policy: Policy,
                value_shapes: Optional[Dict[str, tuple]] = None,
                weight_shapes: Optional[Dict[str, tuple]] = None,
                dtype_bytes: int = 4,
                num_chunks=None,
                comp_hints: Optional[Dict[str, float]] = None) -> Sim:
    """Convenience wrapper: lower ``g`` with (possibly synthesized) shapes."""
    if value_shapes is None or weight_shapes is None:
        vs, ws = synthesize_shapes(g)
        value_shapes = {**vs, **(value_shapes or {})}
        weight_shapes = {**ws, **(weight_shapes or {})}
    return Lowering(fabric, policy, value_shapes, weight_shapes,
                    dtype_bytes, num_chunks, comp_hints).lower(g)


def simulate(g: df.Graph, fabric: Fabric, policy: Policy,
             **kw) -> float:
    """Simulated makespan (seconds) of graph ``g`` under the cost model."""
    makespan, _ = lower_graph(g, fabric, policy, **kw).run()
    return makespan
