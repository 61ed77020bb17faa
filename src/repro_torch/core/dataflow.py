"""Graph-level dataflow optimizer (paper §III-C) and graph-built backward.

Counterpart of ``repro/core/dataflow.py``: the same IR (``Node``/``Graph``
over the same op vocabulary, ``VALID_OPS``), the same fusion passes — pass 1
``fuse_compute_aware``, pass 1b ``fuse_shared_gather``, pass 2
``fuse_sublayer_chain``, pass 3 ``pair_asymmetric`` (the greedy
nearest-independent-pair-first policy) — and an executor that runs a graph
on one rank of a :class:`repro_torch.sharding.TPGroup`, dispatching every
fused collective op through a :class:`repro_torch.core.backends.
CollectiveBackend`. The passes are pure Python and copied, so ``optimize``
gives the same node list as ``repro``'s on the same graph; the module
docstring of ``repro/core/dataflow.py`` documents each op and pass.

The backward vocabulary is here too and copied the same way:
``ADJOINTS``, ``build_training_graph`` (every branch, MoE and
``gemm_ar``/``gemm_col`` included), so its node lists equal ``repro``'s, and
the derived weights (``"w^T"``, ``"a+b^T"``) as views of the local shards.
The adjoints' local math differentiates the node's fn with
``torch.autograd.grad``; every GEMM of the backward goes through
:func:`repro_torch.core.primitives.mm` with the transposed operands read
where they lie (``_dw`` is ``mm(actᵀ, gout)``, ``_gemm_t`` ``mm(gy, wᵀ)``).

Pass 3 takes the greedy policy or a planner: ``optimize(g, planner=...)``
with ``"perfsim"`` or a :class:`repro_torch.plan.search.PerfsimPlanner`
scores candidate pairings by simulated makespan (:mod:`repro_torch.plan`),
and ``pair_asymmetric(g, pairing=...)`` replays a decided pairing. The
expert all-to-all ``a2a_ffn`` and its adjoint ``bwd_a2a_ffn`` run through
the backend's ``a2a_expert_ffn`` / ``grad_a2a_expert_ffn``; the adjoint
takes the per-row expert VJP from the node fn's ``vjp`` attribute where it
has one (the period graph's expert fn, whose backward GEMMs go through the
matmul kernel), and from ``torch.autograd`` of the fn otherwise. So does a
``custom`` node's adjoint. ``expert_ar`` is the expert FFN of the replicated
activation layout: each rank's experts on the routed rows, their partial
output completed by one all-reduce; its adjoint all-reduces the partial
cotangents of its inputs.

Tensor layout conventions per value: ``seq`` (B, S_loc, d)
sequence-sharded · ``feat`` (B, S, d_loc) feature-sharded · ``full``
(B, S, d) replicated.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.primitives import CAISConfig, mm, rows_vjp

# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------

#        op            inputs                weights         out layout
# input                ()                    —               declared
# gemm_col             (x: full)             w (d, F/n)      feat
# gemm_row             (x: feat)             w (d/n, F)      partial-full
# allgather            (x: seq)              —               full
# reduce_scatter       (x: partial-full)     —               seq
# allreduce            (x: partial-full)     —               full
# layernorm            (x: any)              scale (d,)      same
# add / residual       (a, b) same layout    —               same
# custom               (any...)              (w...)          fn-defined
# route                (xn: seq)             (router,)       (send, combine,
#                                                             aux)
# unroute              (eout, combine, xn)   —               seq
# a2a_ffn              (send,)               (expert ws...)  send-shaped
# expert_ar            (xn: full, dispatch,  (expert ws...)  full (this rank's
#                       combine)                              experts' partial
#                                                             sum, all-reduced)
# --- fused (produced by optimize) ---
# ag_gemm              (x: seq)              w               feat
# ag_gemm_multi        (x: seq)              (w...)          feat per weight
# gemm_rs              (x: feat)             w               seq
# gemm_ar              (x: feat)             w               full
# fused_rs_ln_ag       (x: feat[, res:seq])  (w1, scale, w2) feat (+ seq z)
# fused_rs_ln_ag_multi (x: feat[, res:seq])  (w1, scale, w...) feat per w
#                                                             (+ seq z)
# fused_rs_ln          (x: feat[, res:seq])  (w1, scale)     (seq zn, seq z)
# overlap_asym         (x_rs: feat, x_ag: seq) (w_rs, w_ag...) (seq, feat...)
# bwd_ag_gemm          (dy: seq)             wT (d, F/n)     (feat dx, full dy)
# bwd_a2a_ffn          (send, dy) send-shaped (expert ws...)  (d_send, dw...)

VALID_OPS = {
    "input", "gemm_col", "gemm_row", "allgather", "reduce_scatter",
    "allreduce", "layernorm", "add", "residual", "custom",
    "route", "unroute", "a2a_ffn", "expert_ar",
    "ag_gemm", "ag_gemm_multi", "gemm_rs", "gemm_ar", "fused_rs_ln_ag",
    "fused_rs_ln_ag_multi", "fused_rs_ln", "overlap_asym",
    "bwd_ag_gemm", "bwd_a2a_ffn",
}

# The declared adjoint vocabulary, as ``repro``'s: each forward op the
# model's graph functions can leave in a period graph after passes 1/1b/2
# maps to the IR ops its adjoint emits (``repro/core/dataflow.py``
# documents each entry). Raw collectives and pass-3 ``overlap_asym`` have
# none.
ADJOINTS = {
    "input": (),
    "add": (), "residual": (),              # gradient fan-out, no new nodes
    "layernorm": ("custom",),               # norm VJP (local math)
    "custom": ("custom",),                  # VJP of the node's fn (its
    #                                         declared ``vjp`` where it has
    #                                         one)
    "route": ("custom",),                   # VJP of the routing closure
    "unroute": ("custom",),                 # the route adjoint's dual
    "a2a_ffn": ("bwd_a2a_ffn",),            # reverse expert all-to-all
    "expert_ar": ("custom", "allreduce"),   # the fn's declared VJP, the
    #                                         replicated cotangent taken as
    #                                         it is, the partial d(xn) and
    #                                         d(combine) all-reduced
    "ag_gemm": ("custom", "gemm_rs", "allgather"),
    "ag_gemm_multi": ("custom", "gemm_rs", "allgather"),
    "gemm_rs": ("bwd_ag_gemm", "custom"),
    "gemm_ar": ("custom",),                 # replicated out: local dx/dw
    "gemm_col": ("gemm_ar", "custom"),      # grad allreduce through w^T
    "fused_rs_ln_ag": ("custom", "gemm_rs", "bwd_ag_gemm", "allgather"),
    "fused_rs_ln_ag_multi": ("custom", "gemm_rs", "bwd_ag_gemm",
                             "allgather"),
    "fused_rs_ln": ("custom", "bwd_ag_gemm"),
}

# local-math ops whose semantics live in the node's `fn`
_FN_OPS = ("custom", "route", "unroute")

# cotangent-seed inputs of a training graph (``d.<value>``) and per-use
# weight-gradient values (``dw.<adjoint>.<weight>``); pass 3 ranks a
# training graph's cross-direction pairs first, as ``repro`` does
_D_PREFIX = "d."
_DW_PREFIX = "dw."


class GraphError(ValueError):
    """A malformed dataflow graph: unknown op, cycle, missing producer…
    Always names the offending node/value."""


@dataclass(frozen=True)
class Node:
    name: str
    op: str
    inputs: Tuple[str, ...] = ()
    weights: Tuple[str, ...] = ()   # keys into the weights dict
    outputs: Tuple[str, ...] = ()   # multi-output fused ops; default (name,)
    fn: Optional[Callable] = None   # local math for fn-carrying ops

    def __post_init__(self):
        if self.op not in VALID_OPS:
            raise GraphError(
                f"node {self.name!r} has unknown dataflow op {self.op!r}; "
                f"valid ops: {sorted(VALID_OPS)}")
        if not self.outputs:
            object.__setattr__(self, "outputs", (self.name,))


@dataclass
class Graph:
    nodes: List[Node]
    outputs: Tuple[str, ...]
    # lazily-built adjacency index shared by node_producing / consumers /
    # reaches. Passes never mutate a Graph in place (every rewrite builds a
    # fresh Graph), so the cache stays valid for the instance's lifetime.
    _idx: Optional[Tuple[Dict[str, Node], Dict[str, List[Node]],
                         Dict[str, Node]]] = field(
        default=None, init=False, repr=False, compare=False)

    def _index(self):
        if self._idx is None:
            producer: Dict[str, Node] = {}
            consumers: Dict[str, List[Node]] = {}
            by_name: Dict[str, Node] = {}
            for n in self.nodes:
                by_name[n.name] = n
                for v in n.outputs:
                    producer[v] = n
                for v in n.inputs:
                    consumers.setdefault(v, []).append(n)
            self._idx = (producer, consumers, by_name)
        return self._idx

    def node_producing(self, value: str) -> Optional[Node]:
        return self._index()[0].get(value)

    def consumers(self, value: str) -> List[Node]:
        return list(self._index()[1].get(value, ()))

    def reaches(self, src: str, dst: str) -> bool:
        """Is there a dependency path from node `src` to node `dst`?
        O(V+E) per query over the shared adjacency index."""
        _, consumers_of, by_name = self._index()
        seen, stack = set(), [src]
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            for v in by_name[cur].outputs:
                stack.extend(c.name for c in consumers_of.get(v, ()))
        return False

    def validate(self) -> "Graph":
        """Raise :class:`GraphError` (naming the offender) on missing
        producers, duplicate producers, unknown graph outputs, or cycles."""
        _topo(self.nodes, self.outputs)
        return self


# ---------------------------------------------------------------------------
# Fusion passes
# ---------------------------------------------------------------------------


def _single_consumer(g: Graph, value: str,
                     allow_output: bool = False) -> Optional[Node]:
    """The unique consumer of `value`, or None. A value listed in the graph
    outputs counts as externally consumed unless ``allow_output`` (used when
    the fused op re-exposes the value, e.g. fused_rs_ln_ag's z output)."""
    cs = g.consumers(value)
    if not allow_output and value in g.outputs:
        return None
    return cs[0] if len(cs) == 1 else None


def fuse_compute_aware(g: Graph) -> Graph:
    """Pass 1: align collectives with the adjacent GEMM's memory semantics."""
    nodes = list(g.nodes)
    changed = True
    while changed:
        changed = False
        for n in nodes:
            if n.op == "allgather":
                c = _single_consumer(g, n.name)
                if c is not None and c.op == "gemm_col":
                    fused = Node(c.name, "ag_gemm", n.inputs, c.weights)
                    nodes = [x for x in nodes if x.name not in (n.name, c.name)]
                    nodes.append(fused)
                    g = Graph(_topo(nodes, g.outputs), g.outputs)
                    nodes = list(g.nodes)
                    changed = True
                    break
            if n.op == "gemm_row":
                c = _single_consumer(g, n.name)
                if c is not None and c.op in ("reduce_scatter", "allreduce"):
                    op = "gemm_rs" if c.op == "reduce_scatter" else "gemm_ar"
                    fused = Node(c.name, op, n.inputs, n.weights)
                    nodes = [x for x in nodes if x.name not in (n.name, c.name)]
                    nodes.append(fused)
                    g = Graph(_topo(nodes, g.outputs), g.outputs)
                    nodes = list(g.nodes)
                    changed = True
                    break
    return Graph(_topo(nodes, g.outputs), g.outputs)


def fuse_shared_gather(g: Graph) -> Graph:
    """Pass 1b: an ``allgather`` consumed by *several* ``gemm_col`` nodes
    (fused QKV, gate+up) becomes one ``ag_gemm_multi``: the activation
    circulates the ring once and every weight consumes each arriving chunk
    (the multi-weight pull alignment the hand-fused sub-layers used)."""
    nodes = list(g.nodes)
    for n in nodes:
        if n.op != "allgather" or n.name in g.outputs:
            continue
        cs = g.consumers(n.name)
        if len(cs) < 2 or any(c.op != "gemm_col" for c in cs):
            continue
        fused = Node("+".join(c.name for c in cs), "ag_gemm_multi",
                     n.inputs,
                     tuple(w for c in cs for w in c.weights),
                     outputs=tuple(c.name for c in cs))
        drop = {n.name} | {c.name for c in cs}
        nodes = [x for x in nodes if x.name not in drop] + [fused]
        return fuse_shared_gather(Graph(_topo(nodes, g.outputs), g.outputs))
    return g


def fuse_sublayer_chain(g: Graph) -> Graph:
    """Pass 2: gemm_rs → [add|residual] → layernorm → ag_gemm[_multi] ⇒ one
    pipeline. The post-add value may have *several* consumers (in a
    whole-block graph it feeds both the next LN and the next residual add;
    in a period graph the block→block seam looks the same): the fused op
    re-exposes it, so only the layernorm leg is swallowed.

    MoE variant: when the normed value feeds a ``route`` node instead of a
    gather (attention-out RS → residual → LN → router), the gather-less
    prefix fuses into ``fused_rs_ln``, which re-exposes BOTH the normed
    value (for route/unroute/dense-residual consumers) and z."""
    nodes = list(g.nodes)
    for rs in list(nodes):
        if rs.op != "gemm_rs":
            continue
        # rs's value may escape as a graph output — the fused op re-exposes it
        nxt = _single_consumer(g, rs.name, allow_output=True)
        residual = None
        add_node = None
        if nxt is not None and nxt.op in ("add", "residual"):
            if rs.name in g.outputs:
                # the fused op re-exposes only the post-add z — a graph that
                # also exports the pre-add value must keep the chain unfused
                continue
            other = [v for v in nxt.inputs if v != rs.name]
            residual = other[0] if other else None
            add_node = nxt
            # z = rs + residual is re-exposed by the fused op, so it may be a
            # graph output or feed several consumers — fuse along the (one)
            # layernorm among them
            lns = [c for c in g.consumers(nxt.name) if c.op == "layernorm"]
            nxt = lns[0] if len(lns) == 1 else None
        if nxt is None or nxt.op != "layernorm":
            continue
        ln = nxt
        ins = rs.inputs + ((residual,) if residual else ())
        z_name = (add_node or rs).name
        drop = {rs.name, ln.name} | ({add_node.name} if add_node else set())
        ag = _single_consumer(g, ln.name)
        if ag is not None and ag.op in ("ag_gemm", "ag_gemm_multi"):
            if ag.op == "ag_gemm":
                fused = Node(ag.name, "fused_rs_ln_ag", ins,
                             rs.weights + ln.weights + ag.weights,
                             outputs=(ag.name, z_name))
            else:
                fused = Node(ag.name, "fused_rs_ln_ag_multi", ins,
                             rs.weights + ln.weights + ag.weights,
                             outputs=ag.outputs + (z_name,))
            drop.add(ag.name)
        elif any(c.op == "route" for c in g.consumers(ln.name)):
            # the normed value feeds an expert router (and usually also the
            # unroute scatter / a dense-residual MLP) — fuse the RS + add +
            # norm and re-expose the normed value under its old name
            fused = Node(ln.name, "fused_rs_ln", ins,
                         rs.weights + ln.weights,
                         outputs=(ln.name, z_name))
        else:
            continue
        nodes = [x for x in nodes if x.name not in drop] + [fused]
        return fuse_sublayer_chain(Graph(_topo(nodes, g.outputs), g.outputs))
    return Graph(_topo(nodes, g.outputs), g.outputs)


def _input_ancestors(g: Graph, nodes: List[Node]) -> Dict[str, frozenset]:
    """Node name → the set of graph ``input`` nodes it transitively depends
    on. Two nodes belong to the same microbatch *chain* iff these sets
    intersect: merged microbatch fragments each hang off their own input
    (``mb{i}.x``), so cross-chain sets are disjoint while a fork inside one
    chain shares its input ancestor. ``nodes`` must be in topo order."""
    anc: Dict[str, frozenset] = {}
    for n in nodes:
        if n.op == "input":
            anc[n.name] = frozenset((n.name,))
            continue
        s = frozenset()
        for v in n.inputs:
            p = g.node_producing(v)
            if p is not None:
                s |= anc[p.name]
        anc[n.name] = s
    return anc


def asymmetric_candidates(g: Graph) -> List[Tuple[Node, Node]]:
    """Every legal pass-3 pair of ``g``, ranked nearest-independent-first.

    A candidate is a (gemm_rs, ag_gemm[_multi]) pair with no dependency path
    either way AND disjoint ``input``-ancestor sets (the chain-id guard: the
    overlap primitive runs its streams in lockstep, so two collectives fed
    by the same microbatch's data — dependency-free only because of a fork —
    must never pair). Ranking: topological distance, ties broken by earliest
    topo position and then by node names — the greedy pass takes the head of
    this list.

    Cotangent-seed inputs (``d.*``) of a training graph rank
    cross-direction pairs first in ``repro``; a forward graph has none, so
    that key never separates two of its candidates."""
    nodes = _topo(list(g.nodes), g.outputs)
    order = {n.name: i for i, n in enumerate(nodes)}
    chain = _input_ancestors(g, nodes)
    seeds = frozenset(n.name for n in nodes
                      if n.op == "input" and n.name.startswith(_D_PREFIX))

    def is_bwd(name: str) -> bool:
        return bool(chain[name] & seeds)

    cands = []
    for a in nodes:
        if a.op != "gemm_rs":
            continue
        for b in nodes:
            if b.op not in ("ag_gemm", "ag_gemm_multi") or b.name == a.name:
                continue
            if chain[a.name] & chain[b.name]:
                continue
            if g.reaches(a.name, b.name) or g.reaches(b.name, a.name):
                continue
            key = (0 if seeds and is_bwd(a.name) != is_bwd(b.name) else 1,
                   abs(order[a.name] - order[b.name]),
                   min(order[a.name], order[b.name]), a.name, b.name)
            cands.append((key, a, b))
    cands.sort(key=lambda t: t[0])
    return [(a, b) for _, a, b in cands]


def apply_pair(g: Graph, a: Node, b: Node) -> Graph:
    """Fuse one (gemm_rs, ag_gemm[_multi]) candidate into ``overlap_asym``."""
    fused = Node(f"{a.name}+{b.name}", "overlap_asym",
                 a.inputs + b.inputs, a.weights + b.weights,
                 outputs=(a.name,) + b.outputs)
    nodes = [x for x in g.nodes if x.name not in (a.name, b.name)]
    nodes.append(fused)
    return Graph(_topo(nodes, g.outputs), g.outputs)


def pair_asymmetric(g: Graph,
                    pairing: Optional[Sequence[Tuple[str, str]]] = None
                    ) -> Graph:
    """Pass 3: co-schedule independent gemm_rs + ag_gemm[_multi] pairs so
    their complementary ring directions share the links each step (e.g. one
    microbatch's FFN-out RS against another's attention-in gather).

    Default policy (deterministic, nearest-independent-pair-first): fuse the
    head of :func:`asymmetric_candidates` and repeat until no independent
    pair remains, so a merged microbatch/period graph co-schedules the
    *adjacent* seam rather than an arbitrary first match.

    With an explicit ``pairing`` — an ordered sequence of (gemm_rs name,
    ag_gemm name), a planner decision (:mod:`repro_torch.plan.search`) —
    the pass applies exactly those pairs, in order. Each named pair must
    still be a legal candidate when its turn comes (earlier fusions change
    the dependency structure); an illegal pair raises :class:`GraphError`,
    so a stale cached plan fails loudly rather than silently reordering."""
    if pairing is not None:
        for rs_name, ag_name in pairing:
            cand = {(a.name, b.name): (a, b)
                    for a, b in asymmetric_candidates(g)}
            if (rs_name, ag_name) not in cand:
                raise GraphError(
                    f"planner pairing ({rs_name!r}, {ag_name!r}) is not a "
                    f"legal independent pair of this graph")
            g = apply_pair(g, *cand[(rs_name, ag_name)])
        return g
    cands = asymmetric_candidates(g)
    if not cands:
        return Graph(_topo(list(g.nodes), g.outputs), g.outputs)
    return pair_asymmetric(apply_pair(g, *cands[0]))


def optimize(g: Graph, asymmetric: bool = True, planner=None) -> Graph:
    """Run passes 1 → 1b → 2 → 3. ``planner`` drives pass 3's pairing order:

    - ``None`` / ``"greedy"`` — the deterministic nearest-independent-first
      policy (the default);
    - ``"perfsim"`` — a :class:`repro_torch.plan.search.PerfsimPlanner` with
      synthesized shapes: candidate pairings are scored by simulated
      makespan over the perfsim cost model and the argmin wins;
    - any object with a ``pair(g) -> Graph`` method — e.g. a PerfsimPlanner
      carrying the real shapes/topology (the ``tp.sp_period`` path).
    """
    g = fuse_compute_aware(g)
    g = fuse_shared_gather(g)
    g = fuse_sublayer_chain(g)
    if asymmetric:
        if planner is None or planner == "greedy":
            g = pair_asymmetric(g)
        else:
            if planner == "perfsim":
                from repro_torch.plan import PerfsimPlanner
                planner = PerfsimPlanner()
            g = planner.pair(g)
    return g


def _topo(nodes: List[Node], outputs) -> List[Node]:
    """Stable topological order by value availability.

    Raises :class:`GraphError` naming the offending node/value on duplicate
    producers, unknown graph outputs, inputs with no producer, or cycles."""
    produced: Dict[str, str] = {}
    for n in nodes:
        for v in n.outputs:
            if v in produced and produced[v] != n.name:
                raise GraphError(
                    f"value {v!r} is produced by both node {produced[v]!r} "
                    f"and node {n.name!r}")
            produced[v] = n.name
    for o in outputs:
        if o not in produced:
            raise GraphError(
                f"graph output {o!r} is not produced by any node")
    avail = set()
    ordered = [n for n in nodes if n.op == "input"]
    for n in ordered:
        avail |= set(n.outputs)
    pending = [n for n in nodes if n.op != "input"]
    while pending:
        ready = [n for n in pending if all(v in avail for v in n.inputs)]
        if not ready:
            # stalled — diagnose: a consumed value nobody produces, or a cycle
            for n in pending:
                missing = [v for v in n.inputs if v not in produced]
                if missing:
                    raise GraphError(
                        f"node {n.name!r} consumes value {missing[0]!r}, "
                        f"which no node produces")
            cyc = ", ".join(sorted(n.name for n in pending))
            raise GraphError(
                f"cycle in dataflow graph involving nodes: {cyc}")
        ready_ids = {id(n) for n in ready}
        for n in ready:
            ordered.append(n)
            avail |= set(n.outputs)
        pending = [n for n in pending if id(n) not in ready_ids]
    return ordered


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def execute(g: Graph, values: Dict[str, torch.Tensor],
            weights: Dict[str, torch.Tensor], group=None,
            cais: CAISConfig = CAISConfig(), norm: str = "rmsnorm",
            backend=None):
    """Evaluate the graph. With ``group`` (a
    :class:`repro_torch.sharding.TPGroup`) the values and weights are this
    rank's local shards per the layout conventions, and every fused
    collective op dispatches through ``backend`` (an instance or registry
    name, default ``"cais"``). Without it, collectives degenerate to the
    identity and plain math (the single-device reference). Every GEMM goes
    through :func:`repro_torch.kernels.ops.matmul`."""
    from repro_torch.core.backends import get_backend
    from repro_torch.models.layers import apply_norm

    env = dict(values)
    dist = group is not None
    be = get_backend(backend if backend is not None else "cais")

    def seam(ins, w1, scale):
        """The single-device reference of a fused RS→(+res)→LN seam."""
        z = mm(ins[0], w1)
        if len(ins) > 1:
            z = z + ins[1]
        return apply_norm(norm, z, scale), z

    for n in g.nodes:
        if n.op == "input":
            continue
        ins = [env[v] for v in n.inputs]
        ws = [weights[k] for k in n.weights]
        if n.op in ("gemm_col", "gemm_row"):
            env[n.name] = mm(ins[0], ws[0])
        elif n.op == "allgather":
            env[n.name] = group.all_gather(ins[0], 1) if dist else ins[0]
        elif n.op == "reduce_scatter":
            env[n.name] = group.reduce_scatter(ins[0], 1) if dist else ins[0]
        elif n.op == "allreduce":
            env[n.name] = group.all_reduce(ins[0]) if dist else ins[0]
        elif n.op == "layernorm":
            env[n.name] = apply_norm(norm, ins[0], ws[0])
        elif n.op in ("add", "residual"):
            env[n.name] = ins[0] + ins[1]
        elif n.op in _FN_OPS:
            res = n.fn(*ins, *ws)
            if len(n.outputs) > 1:
                for name, val in zip(n.outputs, res):
                    env[name] = val
            else:
                env[n.outputs[0]] = res
        elif n.op == "expert_ar":
            y = n.fn(*ins, *ws)
            env[n.name] = group.all_reduce(y) if dist else y
        elif n.op == "a2a_ffn":
            fn = (lambda chunk, _n=n, _ws=tuple(ws): _n.fn(chunk, *_ws))
            env[n.name] = (be.a2a_expert_ffn(ins[0], fn, group, cais)
                           if dist else torch.stack([fn(r) for r in ins[0]]))
        elif n.op == "ag_gemm":
            env[n.name] = (be.ag_gemm(ins[0], ws[0], group, cais)
                           if dist else mm(ins[0], ws[0]))
        elif n.op == "ag_gemm_multi":
            outs = (be.ag_gemm_multi(ins[0], tuple(ws), group, cais)
                    if dist else tuple(mm(ins[0], w) for w in ws))
            for name, val in zip(n.outputs, outs):
                env[name] = val
        elif n.op == "gemm_rs":
            env[n.name] = (be.gemm_rs(ins[0], ws[0], group, cais)
                           if dist else mm(ins[0], ws[0]))
        elif n.op == "gemm_ar":
            env[n.name] = (be.gemm_ar(ins[0], ws[0], group, cais)
                           if dist else mm(ins[0], ws[0]))
        elif n.op in ("fused_rs_ln_ag", "fused_rs_ln_ag_multi"):
            w1, scale, ws2 = ws[0], ws[1], tuple(ws[2:])
            res = ins[1] if len(ins) > 1 else None
            if dist and n.op == "fused_rs_ln_ag":
                out, z = be.fused_rs_ln_ag(ins[0], w1, scale, ws2[0], group,
                                           cais, norm=norm, residual=res)
                outs = (out,)
            elif dist:
                outs, z = be.fused_rs_ln_ag_multi(ins[0], w1, scale, ws2,
                                                  group, cais, norm=norm,
                                                  residual=res)
            else:
                zn, z = seam(ins, w1, scale)
                outs = tuple(mm(zn, w) for w in ws2)
            for name, val in zip(n.outputs, tuple(outs) + (z,)):
                env[name] = val
        elif n.op == "fused_rs_ln":
            w1, scale = ws
            res = ins[1] if len(ins) > 1 else None
            if dist:
                zn, z = be.fused_rs_ln(ins[0], w1, scale, group, cais,
                                       norm=norm, residual=res)
            else:
                zn, z = seam(ins, w1, scale)
            env[n.outputs[0]], env[n.outputs[1]] = zn, z
        elif n.op == "overlap_asym":
            w_rs, ag_ws = ws[0], tuple(ws[1:])
            if dist:
                rs_out, ag_out = be.overlap_asymmetric(
                    (ins[0], w_rs),
                    (ins[1], ag_ws if len(ag_ws) > 1 else ag_ws[0]),
                    group, cais)
                ag_outs = ag_out if len(ag_ws) > 1 else (ag_out,)
            else:
                rs_out = mm(ins[0], w_rs)
                ag_outs = tuple(mm(ins[1], w) for w in ag_ws)
            for name, val in zip(n.outputs, (rs_out,) + tuple(ag_outs)):
                env[name] = val
        elif n.op == "bwd_ag_gemm":
            # adjoint of gemm_rs: gather the seq-sharded cotangent, GEMM with
            # the transposed weight; the gathered cotangent is re-exposed for
            # the weight-gradient GEMM (outputs (d_x, dy_full))
            dx_, dyf = (be.grad_ag_gemm(ins[0], ws[0], group, cais)
                        if dist else (mm(ins[0], ws[0]), ins[0]))
            env[n.outputs[0]], env[n.outputs[1]] = dx_, dyf
        elif n.op == "bwd_a2a_ffn":
            # adjoint of a2a_ffn: re-dispatch (send row, cotangent row)
            # pairs to the expert owners, the per-row VJP of the expert fn
            # there, d(recv) back to the senders; the owner keeps its local
            # expert-weight grads. outputs = (d_send, dw...)
            row_vjp = _row_vjp(n.fn, tuple(ws))
            dsend, dws_ = (be.grad_a2a_expert_ffn(ins[0], ins[1], row_vjp,
                                                  group, cais)
                           if dist else rows_vjp(ins[0], ins[1], row_vjp))
            for name, val in zip(n.outputs, (dsend,) + tuple(dws_)):
                env[name] = val
        else:
            raise ValueError(n.op)
    return tuple(env[o] for o in g.outputs)



# ---------------------------------------------------------------------------
# Canonical sub-layer graphs (paper Fig. 12, L1–L4)
# ---------------------------------------------------------------------------


def sublayer_graph() -> Graph:
    """[GEMM (row) → RS] → LN → [AG → GEMM (col)] — the L1–L4 shape:
    e.g. L2 = second FFN layer → LayerNorm → input projection."""
    return Graph(
        nodes=[
            Node("x", "input"),
            Node("g1", "gemm_row", ("x",), ("w1",)),
            Node("rs", "reduce_scatter", ("g1",)),
            Node("ln", "layernorm", ("rs",), ("scale",)),
            Node("ag", "allgather", ("ln",)),
            Node("g2", "gemm_col", ("ag",), ("w2",)),
        ],
        outputs=("g2",),
    )


def merge_graphs(graphs: Sequence[Graph],
                 prefixes: Optional[Sequence[str]] = None,
                 share_weights: bool = False) -> Graph:
    """Disjoint union of several graphs with value/node renaming — e.g. two
    microbatches of the same transformer block, or consecutive *different*
    blocks of a period, so cross-graph passes (``pair_asymmetric``) can
    co-schedule collectives across them.

    Weight keys are prefixed exactly like values by default, so merging
    graphs of different blocks cannot silently alias ``wq``/``w_up``/…
    across blocks. Pass ``share_weights=True`` for the same-params
    microbatch case: weight keys are left unrenamed and every merged copy
    reads one shared weights dict. Duplicate prefixes would make the
    renaming collide (unintended weight-key/value aliasing) and raise
    :class:`GraphError` up front."""
    if prefixes is None:
        prefixes = [f"mb{i}." for i in range(len(graphs))]
    if len(prefixes) != len(graphs):
        raise GraphError(
            f"merge_graphs got {len(graphs)} graphs but "
            f"{len(prefixes)} prefixes")
    if len(set(prefixes)) != len(prefixes):
        dup = sorted(p for p in set(prefixes) if list(prefixes).count(p) > 1)
        raise GraphError(
            f"merge_graphs got duplicate prefix {dup[0]!r}: node and weight "
            f"renaming would collide across the merged graphs")
    nodes: List[Node] = []
    outs: List[str] = []
    for g, p in zip(graphs, prefixes):
        for n in g.nodes:
            nodes.append(dataclasses.replace(
                n, name=p + n.name,
                inputs=tuple(p + v for v in n.inputs),
                outputs=tuple(p + v for v in n.outputs),
                weights=(n.weights if share_weights
                         else tuple(p + w for w in n.weights))))
        outs.extend(p + o for o in g.outputs)
    return Graph(nodes, tuple(outs))


def dual_sublayer_graph() -> Graph:
    """Two independent sub-chains (e.g. two microbatches / fwd+bwd): the
    optimizer pairs the RS of one with the AG-GEMM of the other."""
    return Graph(
        nodes=[
            Node("xa", "input"),
            Node("xb", "input"),
            Node("ga", "gemm_row", ("xa",), ("wa",)),
            Node("rsa", "reduce_scatter", ("ga",)),
            Node("agb", "allgather", ("xb",)),
            Node("gb", "gemm_col", ("agb",), ("wb",)),
        ],
        outputs=("rsa", "gb"),
    )


# ---------------------------------------------------------------------------
# Backward: training graphs (declared adjoints per fused forward op)
# ---------------------------------------------------------------------------
#
# build_training_graph takes a forward graph that has been through passes
# 1/1b/2 (NOT pass 3 — overlap_asym has no adjoint; the caller runs pass 3
# on the *merged* result so it can pair forward against backward
# collectives) and appends adjoint nodes in reverse topological order. The
# builder works at the fused-op level on purpose: pass 2 re-exposes every
# activation the adjoints need (z, the normed value is recomputable from z,
# q/k/v/o/h are plain graph values), whereas differentiating the primitive
# graph would hang extra non-gemm consumers off every allgather and block
# passes 1b/2 from fusing the forward at all.
#
# Derived weight keys: adjoints reference transposed (and, for shared
# gathers, concatenated) forward weights as new keys ``"w^T"`` /
# ``"wa+wb^T"``. These are *local-shard* transforms — the transpose of a
# column shard IS that device's shard of the row-sharded transpose — so
# :func:`derived_weights` materializes them inside shard_map from the local
# forward shards, with no extra mesh arguments.


def grad_input_name(value: str) -> str:
    """Name of the ``input`` node seeding the cotangent of forward output
    ``value`` in a training graph."""
    return _D_PREFIX + value


def supports_backward(g: Graph) -> bool:
    """True iff every node's op has a declared adjoint (:data:`ADJOINTS`):
    the dense vocabulary, MoE routing, ``expert_ar`` and
    ``gemm_ar``/``gemm_col``. Raw
    collectives and pass-3 ``overlap_asym`` have none."""
    return all(n.op in ADJOINTS for n in g.nodes)


@dataclass(frozen=True)
class TrainingGraph:
    """A forward graph with its graph-built backward appended.

    ``graph.outputs`` = the input cotangents (one per forward ``input``
    node that gradients reach, in forward declaration order) followed by
    every per-use weight-gradient value. ``dweights`` groups the latter by
    forward weight key: shared-weight chains (microbatch copies of one
    block) each contribute one value per use, and the caller sums each
    group (then all-reduces replicated-weight grads over the ring)."""
    graph: Graph
    grad_inputs: Tuple[str, ...]          # cotangent seeds ("d." + output)
    dx: Dict[str, str]                    # fwd input value -> grad value
    dweights: Dict[str, Tuple[str, ...]]  # weight key -> grad values (sum)


def _leaf(t: torch.Tensor) -> torch.Tensor:
    """A fresh autograd leaf holding ``t``'s values (floating tensors)."""
    return t.detach().requires_grad_(t.is_floating_point())


def _norm_vjp(norm: str) -> Callable:
    def vjp_fn(x, gy, scale):
        from repro_torch.models.layers import apply_norm
        with torch.enable_grad():
            xx, ss = _leaf(x), _leaf(scale)
            return torch.autograd.grad(apply_norm(norm, xx, ss), (xx, ss),
                                       gy)     # (d_x, d_scale)
    return vjp_fn


def _norm_fwd(norm: str) -> Callable:
    def fwd_fn(x, scale):
        from repro_torch.models.layers import apply_norm
        return apply_norm(norm, x, scale)
    return fwd_fn


def _fn_vjp(fn: Callable, k_in: int, k_w: int,
            mask: Tuple[bool, ...]) -> Callable:
    """Adjoint of a ``custom`` node's fn. Called as
    ``vjp(*fwd_inputs, *present_cotangents, *fwd_weights)`` (the executor's
    ``fn(*ins, *ws)`` convention); absent cotangents (outputs no gradient
    reaches) are zero-filled against the recomputed primals, and an input
    the fn does not reach gets a zero gradient, as ``jax.vjp`` gives."""
    def vjp_fn(*args):
        cots = args[k_in:len(args) - k_w] if k_w else args[k_in:]
        ws = args[len(args) - k_w:] if k_w else ()
        with torch.enable_grad():
            prim = tuple(_leaf(t) for t in args[:k_in] + tuple(ws))
            outs = fn(*prim)
            outs = (outs,) if len(mask) == 1 else tuple(outs)
            it = iter(cots)
            cot = tuple(next(it) if m else torch.zeros_like(o)
                        for m, o in zip(mask, outs))
            pairs = [(o, c) for o, c in zip(outs, cot) if o.requires_grad]
            diff = [t for t in prim if t.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], diff, [c for _, c in pairs],
                allow_unused=True) if pairs and diff else ())
        grads = tuple(
            (next(got, None) if t.requires_grad else None) for t in prim)
        grads = tuple(torch.zeros_like(t) if g is None else g
                      for g, t in zip(grads, prim))
        return grads if len(grads) > 1 else grads[0]
    vjp_fn.wrapped = fn       # what the adjoint recomputes (launch counts)
    return vjp_fn


def _row_vjp(fn: Callable, ws: tuple) -> Callable:
    """The per-row VJP ``(chunk, gy) -> (d_chunk, dw_tuple)`` of an
    ``a2a_ffn`` node's fn ``fn(chunk, *ws)``: ``fn.vjp(chunk, gy, *ws)``
    where the fn brings one, else ``torch.autograd.grad`` of the fn."""
    own = getattr(fn, "vjp", None)
    if own is not None:
        return lambda chunk, gy: own(chunk, gy, *ws)
    vjp = _fn_vjp(fn, 1, len(ws), (True,))

    def row(chunk, gy):
        grads = vjp(chunk, gy, *ws)
        return grads[0], tuple(grads[1:])
    return row


def _concat_last(*gs):
    return torch.cat(gs, dim=-1)


def _dw(act, gout):
    """Per-use weight gradient: contract activation (B, S, in) against the
    output cotangent (B, S, out) over batch×seq → (in, out), as one
    ``mm(actᵀ, gout)`` over the folded B·S rows (actᵀ read where it lies)."""
    a = act.reshape(-1, act.shape[-1])
    if not a.is_contiguous():
        a = a.contiguous()
    g = gout.reshape(-1, gout.shape[-1])
    if not g.is_contiguous():
        g = g.contiguous()
    return mm(a.T, g)


def _gemm_t(gy, wT):
    """dx leg of a plain GEMM adjoint: cotangent @ transposed weight."""
    return mm(gy, wT)


def build_training_graph(g: Graph, norm: str = "rmsnorm") -> TrainingGraph:
    """Append the graph-built backward to forward graph ``g`` (which must be
    post-pass-1/1b/2 and pre-pass-3; see the section comment above).

    Every forward output gets a cotangent seed ``input`` node
    (:func:`grad_input_name`); adjoints are emitted per the declared
    :data:`ADJOINTS` vocabulary in reverse topo order, accumulating fan-out
    gradients through ``add`` nodes. The result is ONE graph containing
    both directions — run :func:`optimize` on it so pass 3 can pair a
    backward grad reduce-scatter against an independent chain's forward
    gather (the fwd/bwd cross-chain ``overlap_asym`` the paper targets)."""
    bad = sorted({n.op for n in g.nodes if n.op not in ADJOINTS})
    if bad:
        raise GraphError(
            f"no declared adjoint for op {bad[0]!r}; gate on "
            f"supports_backward()")
    fwd = _topo(list(g.nodes), g.outputs)
    nodes: List[Node] = list(fwd)
    contrib: Dict[str, List[str]] = {}
    dweights: Dict[str, List[str]] = {}
    grad_inputs = tuple(grad_input_name(o) for o in g.outputs)
    for o, gi in zip(g.outputs, grad_inputs):
        nodes.append(Node(gi, "input"))
        contrib.setdefault(o, []).append(gi)

    def finalize(v: str) -> Optional[str]:
        # sum the contributions to d(v); None if no gradient reaches v
        parts = contrib.get(v)
        if not parts:
            return None
        acc = parts[0]
        for i, p in enumerate(parts[1:]):
            nm = f"dsum{i}.{v}"
            nodes.append(Node(nm, "add", (acc, p)))
            acc = nm
        return acc

    def take(v: str, grad: str) -> None:
        contrib.setdefault(v, []).append(grad)

    def add_dw(w: str, grad: str) -> None:
        dweights.setdefault(w, []).append(grad)

    def grad_rs(n: Node, gys: List[str], an: str, xn: str) -> str:
        # shared d(gathered-input) leg of ag_gemm[_multi] and the fused ops:
        # concat the per-weight cotangents and reduce-scatter them through
        # the transposed (concatenated) weight — the grad reduce-scatter
        if len(gys) > 1:
            cat = f"dcat.{n.name}"
            nodes.append(Node(f"adj.cat.{n.name}", "custom", tuple(gys),
                              outputs=(cat,), fn=_concat_last))
        else:
            cat = gys[0]
        out = f"d.{xn}@{an}"
        nodes.append(Node(out, "gemm_rs", (cat,),
                          ("+".join(n.weights[-len(gys):]) + "^T",)))
        return out

    dx: Dict[str, str] = {}
    for n in reversed(fwd):
        an = f"adj.{n.name}"
        if n.op == "input":
            dxv = finalize(n.name)
            if dxv is not None:
                dx[n.name] = dxv
        elif n.op in ("add", "residual"):
            gy = finalize(n.name)
            if gy is not None:
                for v in n.inputs:
                    take(v, gy)
        elif n.op == "layernorm":
            gy = finalize(n.name)
            if gy is None:
                continue
            xin, scale = n.inputs[0], n.weights[0]
            nodes.append(Node(
                an, "custom", (xin, gy), (scale,),
                outputs=(f"d.{xin}@{an}", f"{_DW_PREFIX}{an}.{scale}"),
                fn=_norm_vjp(norm)))
            take(xin, f"d.{xin}@{an}")
            add_dw(scale, f"{_DW_PREFIX}{an}.{scale}")
        elif n.op in _FN_OPS:
            # custom, route, unroute: the VJP of the node's local fn. For
            # route the output triple is (send, combine, aux) — the aux
            # load-balance statistic is a first-class graph output, so its
            # cotangent (seeded from d.<aux>) rides the same VJP into the
            # router-logit gradients. A one-output fn may declare its VJP
            # (``fn.vjp(*ins, gy, *ws)``, one grad an input and a weight),
            # e.g. one whose GEMMs go through the matmul kernel, which
            # torch.autograd cannot differentiate
            gys = [finalize(v) for v in n.outputs]
            if all(q is None for q in gys):
                continue
            have = tuple(q for q in gys if q is not None)
            mask = tuple(q is not None for q in gys)
            outs = (tuple(f"d.{v}@{an}" for v in n.inputs)
                    + tuple(f"{_DW_PREFIX}{an}.{w}" for w in n.weights))
            vjp = getattr(n.fn, "vjp", None)
            if vjp is None:
                vjp = _fn_vjp(n.fn, len(n.inputs), len(n.weights), mask)
            elif len(n.outputs) != 1:
                raise GraphError(f"node {n.name!r}: a declared vjp needs a "
                                 f"one-output fn")
            nodes.append(Node(an, "custom", n.inputs + have, n.weights,
                              outputs=outs, fn=vjp))
            for v in n.inputs:
                take(v, f"d.{v}@{an}")
            for w in n.weights:
                add_dw(w, f"{_DW_PREFIX}{an}.{w}")
        elif n.op == "a2a_ffn":
            gy = finalize(n.name)
            if gy is None:
                continue
            sn = n.inputs[0]
            dsend = f"d.{sn}@{an}"
            dw_names = tuple(f"{_DW_PREFIX}{an}.{w}" for w in n.weights)
            nodes.append(Node(an, "bwd_a2a_ffn", (sn, gy), n.weights,
                              outputs=(dsend,) + dw_names, fn=n.fn))
            take(sn, dsend)
            for w, dwn in zip(n.weights, dw_names):
                add_dw(w, dwn)
        elif n.op == "expert_ar":
            # y = psum(this rank's experts on the routed rows) is
            # replicated, so its cotangent is taken as it is; the fn's
            # declared VJP gives this rank's partial d(xn) and d(combine)
            # and its experts' weight grads, and the two input cotangents
            # are all-reduced (Megatron's f/g pair, whose GEMM instance is
            # gemm_col's grad all-reduce through wᵀ). So the route node
            # upstream gets complete cotangents. The dispatch mask carries
            # none.
            gy = finalize(n.name)
            if gy is None:
                continue
            xin, mask_v, comb = n.inputs
            part = (f"dpart.{xin}@{an}", f"dmask.{mask_v}@{an}",
                    f"dpart.{comb}@{an}")
            dw_names = tuple(f"{_DW_PREFIX}{an}.{w}" for w in n.weights)
            nodes.append(Node(an, "custom", n.inputs + (gy,), n.weights,
                              outputs=part + dw_names, fn=n.fn.vjp))
            for v, pv in ((xin, part[0]), (comb, part[2])):
                nodes.append(Node(f"d.{v}@{an}", "allreduce", (pv,)))
                take(v, f"d.{v}@{an}")
            for w, dwn in zip(n.weights, dw_names):
                add_dw(w, dwn)
        elif n.op in ("ag_gemm", "ag_gemm_multi"):
            gys = [finalize(v) for v in n.outputs]
            if all(q is None for q in gys):
                continue
            if any(q is None for q in gys):
                raise GraphError(
                    f"partial cotangents for shared gather {n.name!r}: "
                    f"every output of an ag_gemm_multi must be consumed")
            xn = n.inputs[0]
            take(xn, grad_rs(n, gys, an, xn))
            # weight grads re-gather the seq-sharded input (Megatron-style
            # recompute of the gathered activation — a raw IR allgather so
            # the planner sees and costs it)
            xg = f"xg.{n.name}"
            nodes.append(Node(xg, "allgather", (xn,)))
            for w, gy in zip(n.weights, gys):
                nodes.append(Node(f"adj.dw.{n.name}.{w}", "custom",
                                  (xg, gy),
                                  outputs=(f"{_DW_PREFIX}{an}.{w}",),
                                  fn=_dw))
                add_dw(w, f"{_DW_PREFIX}{an}.{w}")
        elif n.op == "gemm_rs":
            gy = finalize(n.name)
            if gy is None:
                continue
            hin, w1 = n.inputs[0], n.weights[0]
            dh, dyf = f"d.{hin}@{an}", f"dfull.{n.name}"
            nodes.append(Node(an, "bwd_ag_gemm", (gy,), (w1 + "^T",),
                              outputs=(dh, dyf)))
            take(hin, dh)
            nodes.append(Node(f"adj.dw.{n.name}.{w1}", "custom",
                              (hin, dyf),
                              outputs=(f"{_DW_PREFIX}{an}.{w1}",), fn=_dw))
            add_dw(w1, f"{_DW_PREFIX}{an}.{w1}")
        elif n.op == "gemm_ar":
            # y = psum(x_feat @ w_row) is replicated, so the adjoint is
            # purely local: dx = dy @ w^T lands feature-sharded, dw is the
            # local row-shard's contraction — no collective either way
            # (decode/ragged S, incl. S=1: nothing here depends on S).
            gy = finalize(n.name)
            if gy is None:
                continue
            hin, w1 = n.inputs[0], n.weights[0]
            dh = f"d.{hin}@{an}"
            nodes.append(Node(an, "custom", (gy,), (w1 + "^T",),
                              outputs=(dh,), fn=_gemm_t))
            take(hin, dh)
            nodes.append(Node(f"adj.dw.{n.name}.{w1}", "custom",
                              (hin, gy),
                              outputs=(f"{_DW_PREFIX}{an}.{w1}",), fn=_dw))
            add_dw(w1, f"{_DW_PREFIX}{an}.{w1}")
        elif n.op == "gemm_col":
            # sequence-parallel-off layout: x is replicated, y = x @ w_col
            # is feature-sharded. dx needs the cross-shard sum — emitted as
            # a backward ``gemm_ar`` (grad allreduce through w^T, dispatched
            # via the backend); dw is local per column shard.
            gy = finalize(n.name)
            if gy is None:
                continue
            xin, w1 = n.inputs[0], n.weights[0]
            dxv = f"d.{xin}@{an}"
            nodes.append(Node(dxv, "gemm_ar", (gy,), (w1 + "^T",)))
            take(xin, dxv)
            nodes.append(Node(f"adj.dw.{n.name}.{w1}", "custom",
                              (xin, gy),
                              outputs=(f"{_DW_PREFIX}{an}.{w1}",), fn=_dw))
            add_dw(w1, f"{_DW_PREFIX}{an}.{w1}")
        elif n.op in ("fused_rs_ln_ag", "fused_rs_ln_ag_multi"):
            gs, z = n.outputs[:-1], n.outputs[-1]
            gys = [finalize(v) for v in gs]
            dz_ext = finalize(z)
            if all(q is None for q in gys) and dz_ext is None:
                continue
            if any(q is None for q in gys):
                raise GraphError(
                    f"partial cotangents for fused seam {n.name!r}: every "
                    f"gather output must be consumed")
            hin = n.inputs[0]
            res = n.inputs[1] if len(n.inputs) > 1 else None
            w1, scale = n.weights[0], n.weights[1]
            # d(zn): the grad reduce-scatter through the w2 leg
            dzn = grad_rs(n, gys, an, f"zn.{n.name}")
            # norm VJP: d(z) from d(zn) (needs z, re-exposed by pass 2)
            dz_n, dscale = f"dznorm.{n.name}", f"{_DW_PREFIX}{an}.{scale}"
            nodes.append(Node(f"adj.ln.{n.name}", "custom", (z, dzn),
                              (scale,), outputs=(dz_n, dscale),
                              fn=_norm_vjp(norm)))
            add_dw(scale, dscale)
            if dz_ext is not None:
                dz = f"dz.{n.name}"
                nodes.append(Node(dz, "add", (dz_n, dz_ext)))
            else:
                dz = dz_n
            if res is not None:
                take(res, dz)
            # grad all-gather back through the RS leg
            dh, dyf = f"d.{hin}@{an}", f"dfull.{n.name}"
            nodes.append(Node(an, "bwd_ag_gemm", (dz,), (w1 + "^T",),
                              outputs=(dh, dyf)))
            take(hin, dh)
            nodes.append(Node(f"adj.dw.{n.name}.{w1}", "custom",
                              (hin, dyf),
                              outputs=(f"{_DW_PREFIX}{an}.{w1}",), fn=_dw))
            add_dw(w1, f"{_DW_PREFIX}{an}.{w1}")
            # w2 grads: recompute zn from the re-exposed z, re-gather it
            znr, zg = f"znr.{n.name}", f"zg.{n.name}"
            nodes.append(Node(znr, "custom", (z,), (scale,),
                              fn=_norm_fwd(norm)))
            nodes.append(Node(zg, "allgather", (znr,)))
            for w, gy in zip(n.weights[2:], gys):
                nodes.append(Node(f"adj.dw.{n.name}.{w}", "custom",
                                  (zg, gy),
                                  outputs=(f"{_DW_PREFIX}{an}.{w}",),
                                  fn=_dw))
                add_dw(w, f"{_DW_PREFIX}{an}.{w}")
        elif n.op == "fused_rs_ln":
            # the MoE router seam (no trailing gather): outputs (zn, z).
            # d(zn) arrives from the route/unroute/dense-residual adjoints,
            # d(z) from the next block's residual skip; norm VJP joins them
            # and the RS leg's adjoint (bwd_ag_gemm) carries dz back.
            znv, z = n.outputs
            dzn = finalize(znv)
            dz_ext = finalize(z)
            if dzn is None and dz_ext is None:
                continue
            hin = n.inputs[0]
            res = n.inputs[1] if len(n.inputs) > 1 else None
            w1, scale = n.weights[0], n.weights[1]
            if dzn is not None:
                dz_n = f"dznorm.{n.name}"
                dscale = f"{_DW_PREFIX}{an}.{scale}"
                nodes.append(Node(f"adj.ln.{n.name}", "custom", (z, dzn),
                                  (scale,), outputs=(dz_n, dscale),
                                  fn=_norm_vjp(norm)))
                add_dw(scale, dscale)
                if dz_ext is not None:
                    dz = f"dz.{n.name}"
                    nodes.append(Node(dz, "add", (dz_n, dz_ext)))
                else:
                    dz = dz_n
            else:
                dz = dz_ext
            if res is not None:
                take(res, dz)
            dh, dyf = f"d.{hin}@{an}", f"dfull.{n.name}"
            nodes.append(Node(an, "bwd_ag_gemm", (dz,), (w1 + "^T",),
                              outputs=(dh, dyf)))
            take(hin, dh)
            nodes.append(Node(f"adj.dw.{n.name}.{w1}", "custom",
                              (hin, dyf),
                              outputs=(f"{_DW_PREFIX}{an}.{w1}",), fn=_dw))
            add_dw(w1, f"{_DW_PREFIX}{an}.{w1}")
        else:  # pragma: no cover — ADJOINTS gate above is exhaustive
            raise GraphError(f"unhandled adjoint for op {n.op!r}")

    fwd_inputs = [n.name for n in fwd if n.op == "input"]
    dx_outs = tuple(dx[v] for v in fwd_inputs if v in dx)
    dw_outs = tuple(v for vals in dweights.values() for v in vals)
    tg = Graph(nodes, dx_outs + dw_outs).validate()
    return TrainingGraph(tg, grad_inputs, dx,
                         {k: tuple(v) for k, v in dweights.items()})


def derived_weight_keys(g: Graph) -> List[str]:
    """The transposed/concatenated weight keys (suffix ``"^T"``) a training
    graph references beyond the forward weights, in first-use order."""
    seen, out = set(), []
    for n in g.nodes:
        for w in n.weights:
            if w.endswith("^T") and w not in seen:
                seen.add(w)
                out.append(w)
    return out


def derived_weights(g: Graph, weights: Dict) -> Dict:
    """Extend ``weights`` with the derived keys of ``g``: ``"w^T"`` is the
    transpose of this rank's shard ``weights["w"]``, a view; ``"a+b^T"``
    concatenates the named shards along their last axis first (the
    shared-gather layout), then transposes the result (a view of the
    concatenation). Local transforms only: the transpose of a column shard
    IS this rank's shard of the row-sharded transpose."""
    out = dict(weights)
    for key in derived_weight_keys(g):
        parts = key[:-2].split("+")
        w = (out[parts[0]] if len(parts) == 1 else
             torch.cat([out[p] for p in parts], dim=-1))
        out[key] = w.T
    return out


def derived_weight_shapes(g: Graph, shapes: Dict) -> Dict:
    """Shape-level twin of :func:`derived_weights` for the planner: maps the
    derived keys to (out, in)-transposed / concat-then-transposed shapes."""
    out = dict(shapes)
    for key in derived_weight_keys(g):
        parts = key[:-2].split("+")
        d = out[parts[0]][0]
        f = sum(out[p][-1] for p in parts)
        out[key] = (f, d)
    return out
