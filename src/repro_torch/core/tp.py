"""Tensor-parallel period execution on a :class:`repro_torch.sharding.TPGroup`.

Counterpart of the dense training-forward part of ``repro/core/tp.py``.
Every block of a ``cfg.layer_pattern`` period is built into ONE dataflow
graph (:mod:`repro_torch.core.dataflow`), optimized (passes 1/1b/2/3) and
executed on this rank, every fused collective dispatched through a
:class:`repro_torch.core.backends.CollectiveBackend`. With ≥2 blocks pass 2
fuses the block→block seams; ``num_microbatches`` splits the batch into
independent chains merged into the same graph, which gives pass 3 the
cross-chain pairs it turns into ``overlap_asym``.

Each rank holds only its shard of each TP weight (:func:`param_shard_dim`):
QKV and up/gate by columns, the out and down projections by rows, norms
replicated; K/V replicate when ``num_kv_heads % tp != 0``. Activations
between periods are sequence-sharded (B, S/tp, d), or, in the
replicated-activation layout (``seq_sharded=False``: decode S=1 and ragged
S % tp != 0, which cannot shard the sequence), whole on every rank: the
graph then has no gather and its out/down projections end in an allreduce,
which pass 1 fuses to ``gemm_ar``.

Serving over the ring (:func:`sp_serve_period`) runs a period of a mixed
prefill/decode step as one graph in that layout, the paged KV pools and
block tables riding through each attention core node.

The backward of a period is graph-built, as ``repro``'s ``jax.custom_vjp``
under ``TPConfig(graph_backward=True)``: :class:`_PeriodFunction` saves only
(x, weights); its backward builds the training graph of the pass-2-fused
period (:func:`repro_torch.core.dataflow.build_training_graph`), runs pass 3
on the merged forward+backward graph (so one chain's backward grad
reduce-scatter may pair with another chain's forward gather), executes it
on this rank, sums each weight's per-use grads and all-reduces those that
are partial over the ring (:func:`replicated_weights`: in the replicated
layout every rank sees the whole batch and sequence, so only replicated
wk/wv, read a few heads a rank, are).

Not here yet: the MoE period (ROADMAP A10), the perfsim planner (A13), and
``graph_backward=False`` on a ring (A15: JAX falls back to autodiff of the
executed forward, through its collectives; the port has no autodiff through
the ring collectives).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Union

import torch

from repro_torch.core import coordination
from repro_torch.core import dataflow as df
from repro_torch.core import primitives as prim
from repro_torch.core.backends import (CAISBackend, CollectiveBackend,
                                       get_backend)
from repro_torch.core.primitives import CAISConfig
from repro_torch.hw import H100, HWSpec
from repro_torch.sharding import TPGroup


@dataclass(frozen=True)
class TPContext:
    """Group + collective backend + chunking config for explicit TP.

    ``backend`` may be a registry name or a :class:`CollectiveBackend`
    instance. ``num_microbatches`` is the period-graph batch split (int, or
    ``"auto"`` to size it from the α-β model via
    :func:`repro_torch.core.coordination.plan_microbatches`). ``hw`` is the
    α-β target the planners read (the H100 by default)."""

    group: TPGroup
    backend: Union[str, CollectiveBackend] = "cais"
    cais: CAISConfig = CAISConfig()
    num_microbatches: Union[int, str] = 1
    planner: str = "greedy"
    hw: HWSpec = H100
    graph_backward: bool = True

    def __post_init__(self):
        object.__setattr__(self, "backend", get_backend(self.backend))
        if self.planner != "greedy":
            raise NotImplementedError(f"planner {self.planner!r} is not "
                                      "ported yet (ROADMAP A13)")
        if self.cais.hw is None:
            object.__setattr__(
                self, "cais", dataclasses.replace(self.cais, hw=self.hw))

    @classmethod
    def from_config(cls, tp, group: TPGroup, hw: HWSpec = H100
                    ) -> "TPContext":
        """The construction path from :class:`repro_torch.runtime.TPConfig`
        to an execution context."""
        return cls(group=group, backend=tp.mode,
                   cais=CAISConfig(num_chunks=tp.chunks,
                                   bidirectional=tp.bidirectional),
                   num_microbatches=tp.microbatches, planner=tp.planner,
                   hw=hw, graph_backward=tp.graph_backward)

    @property
    def mode(self) -> str:
        return self.backend.name

    @property
    def tp(self) -> int:
        return self.group.size

    @property
    def route_ring(self) -> int:
        """The expert-sharding ring: the whole (flat) TP ring."""
        return self.tp


@dataclass(frozen=True)
class SPOptions:
    """Keyword options of the ``sp_*`` entry points (``opts=SPOptions(...)``
    or the fields as direct keywords). ``seq_sharded=False`` is the
    replicated-activation (decode/ragged) layout; ``prefix_len``
    (prefix-LM) is not ported yet and raises; JAX's ``window`` belongs to
    the per-sub-layer ``sp_attention``, which is not ported."""

    prefix_len: int = 0
    norm_kind: str = "rmsnorm"
    seq_sharded: bool = True
    num_microbatches: Union[int, str, None] = None


def _sp_opts(opts: Optional[SPOptions], legacy: dict) -> SPOptions:
    """Fold direct-keyword options into an :class:`SPOptions`."""
    opts = opts if opts is not None else SPOptions()
    if legacy:
        bad = sorted(set(legacy) - set(SPOptions.__dataclass_fields__))
        if bad:
            raise TypeError(f"unknown sp_* option {bad[0]!r}")
        opts = dataclasses.replace(opts, **legacy)
    return opts


# ---------------------------------------------------------------------------
# Weight sharding
# ---------------------------------------------------------------------------


def param_shard_dim(name: str, cfg, tp: int) -> Optional[int]:
    """The dimension along which parameter ``name`` (a key of the port's
    ``LM`` state dict) is split over a TP ring of ``tp``, or None where it
    is replicated: the specs of the period-graph fragment, ``(None, M)``
    columns for wq/wk/wv/w_up/w_gate, ``(M, None)`` rows for wo/w_down."""
    if tp <= 1 or not name.startswith("blocks."):
        return None
    leaf = name.split(".", 2)[2]
    if leaf in ("mixer.wq", "ffn.w_up", "ffn.w_gate"):
        return 1
    if leaf in ("mixer.wk", "mixer.wv"):
        return 1 if cfg.num_kv_heads % tp == 0 else None
    if leaf in ("mixer.wo", "ffn.w_down"):
        return 0
    return None


# ---------------------------------------------------------------------------
# Block graph fragments
# ---------------------------------------------------------------------------


def _ffn_chain_nodes(src: str, out: str, has_gate: bool, act: str,
                     tag: str = "", p: str = "",
                     seq_sharded: bool = True) -> list:
    """AG → GEMM(up[, gate]) → act[(·)] → GEMM(down) → RS nodes from value
    ``src`` to value ``out``; ``tag`` uniquifies node names inside a larger
    graph and ``p`` namespaces node names and weight keys. With
    ``seq_sharded=False`` (replicated activation) there is no gather and
    the chain ends in an allreduce."""
    from repro_torch.models.layers import activation

    ag, up, gate, h, down = (f"{p}agx{tag}", f"{p}up{tag}", f"{p}gate{tag}",
                             f"{p}h{tag}", f"{p}down{tag}")
    nodes = [df.Node(ag, "allgather", (src,))] if seq_sharded else []
    gin = ag if seq_sharded else src
    nodes.append(df.Node(up, "gemm_col", (gin,), (p + "w_up",)))
    if has_gate:
        nodes.append(df.Node(gate, "gemm_col", (gin,), (p + "w_gate",)))
        nodes.append(df.Node(h, "custom", (up, gate),
                             fn=lambda u, g: activation(act, g) * u))
    else:
        nodes.append(df.Node(h, "custom", (up,),
                             fn=lambda u: activation(act, u)))
    nodes += [df.Node(down, "gemm_row", (h,), (p + "w_down",)),
              df.Node(out, "reduce_scatter" if seq_sharded else "allreduce",
                      (down,))]
    return nodes


def _attention_block_nodes(core_fn: Callable, p: str = "", src: str = "x",
                           seq_sharded: bool = True) -> list:
    """src → LN1 → [AG →] QKV → core → out-GEMM → RS|AR → +src residual
    (value ``{p}r1``); with ``seq_sharded=False`` no gather, and the
    out-projection reduces with an allreduce."""
    nodes = [df.Node(f"{p}ln1", "layernorm", (src,), (f"{p}scale1",))]
    if seq_sharded:
        nodes.append(df.Node(f"{p}agx1", "allgather", (f"{p}ln1",)))
    gin = f"{p}agx1" if seq_sharded else f"{p}ln1"
    return nodes + [
        df.Node(f"{p}q", "gemm_col", (gin,), (f"{p}wq",)),
        df.Node(f"{p}k", "gemm_col", (gin,), (f"{p}wk",)),
        df.Node(f"{p}v", "gemm_col", (gin,), (f"{p}wv",)),
        df.Node(f"{p}o", "custom", (f"{p}q", f"{p}k", f"{p}v"), fn=core_fn),
        df.Node(f"{p}proj", "gemm_row", (f"{p}o",), (f"{p}wo",)),
        df.Node(f"{p}rs1", "reduce_scatter" if seq_sharded else "allreduce",
                (f"{p}proj",)),
        df.Node(f"{p}r1", "residual", (f"{p}rs1", src)),
    ]


def _dense_block_nodes(core_fn: Callable, has_gate: bool, act: str,
                       p: str = "", src: str = "x",
                       seq_sharded: bool = True):
    """One dense block as a graph fragment: returns (nodes, out_value)."""
    nodes = _attention_block_nodes(core_fn, p, src, seq_sharded) + [
        df.Node(f"{p}ln2", "layernorm", (f"{p}r1",), (f"{p}scale2",)),
    ] + _ffn_chain_nodes(f"{p}ln2", f"{p}rs2", has_gate, act, tag="2",
                         p=p, seq_sharded=seq_sharded) + [
        df.Node(f"{p}r2", "residual", (f"{p}rs2", f"{p}r1")),
    ]
    return nodes, f"{p}r2"


def dense_block_graph(core_fn: Callable, has_gate: bool, act: str
                      ) -> df.Graph:
    """One Graph for a whole dense transformer block; after ``optimize()``
    the attention-out RS, residual, LN2 and FFN-in gather are one
    ``fused_rs_ln_ag[_multi]`` (pass 2)."""
    nodes, out = _dense_block_nodes(core_fn, has_gate, act)
    return df.Graph([df.Node("x", "input")] + nodes, outputs=(out,))


def dense_period_graph(core_fns: Sequence[Callable], has_gate: bool,
                       act: str) -> df.Graph:
    """One Graph for a PERIOD of dense blocks (one core_fn per block),
    chained through per-block ``b{i}.`` namespaces, so pass 2 also fuses
    the block→block seams."""
    nodes = [df.Node("x", "input")]
    src = "x"
    for i, core_fn in enumerate(core_fns):
        ns, src = _dense_block_nodes(core_fn, has_gate, act, p=f"b{i}.",
                                     src=src)
        nodes += ns
    return df.Graph(nodes, outputs=(src,))


def _local_heads(cfg, tp: int):
    """(query heads, kv heads) a rank of a ring of ``tp`` holds: Hkv/tp kv
    heads when they shard, all Hkv when they replicate."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    return max(H // tp, 1), (max(Hkv // tp, 1) if Hkv % tp == 0 else Hkv)


def _rank_kv(k: torch.Tensor, v: torch.Tensor, cfg, tp: int, rank: int):
    """With replicated KV, the kv heads (dim 2) the rank's q heads use, made
    contiguous for the flash kernel (head sharding is contiguous, so they
    are one run); sharded KV passes through."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    if Hkv % tp == 0:
        return k, v
    g = H // Hkv                        # q heads per kv head
    H_loc = max(H // tp, 1)
    need = max(H_loc // g, 1)
    start = (rank * H_loc) // g
    return (k[:, :, start:start + need].contiguous(),
            v[:, :, start:start + need].contiguous())


def _attention_core_fn(cfg, tp: int, window: int = 0, rank: int = 0
                       ) -> Callable:
    """The local attention math (rope, KV head slicing, the flash core,
    head reshape) as the closure of a ``custom`` node. q/k/v arrive over
    the full sequence (gathered, or replicated) with this rank's heads; with
    replicated KV the rank slices the kv heads its q heads use."""
    from repro_torch.models.attention import attention_core
    from repro_torch.models.layers import apply_rope

    dh = cfg.resolved_head_dim
    H_loc, Hkv_loc = _local_heads(cfg, tp)

    def core(q, k, v):        # one flash_attention call (core.flash_calls)
        B_, S = q.shape[0], q.shape[1]
        pos = torch.arange(S, dtype=torch.int32,
                           device=q.device).expand(B_, S).contiguous()
        q = apply_rope(q.reshape(B_, S, H_loc, dh), pos, cfg.rope_theta)
        k = apply_rope(k.reshape(B_, S, Hkv_loc, dh), pos, cfg.rope_theta)
        k, v = _rank_kv(k, v.reshape(B_, S, Hkv_loc, dh), cfg, tp, rank)
        o = attention_core(q, k, v, q_positions=pos, kv_positions=pos,
                           causal=True, window=window)
        return o.reshape(B_, S, H_loc * dh)

    core.flash_calls = 1
    return core


def _block_weights(params, p: str, dtype) -> Dict[str, torch.Tensor]:
    """A dense block's weights under period-graph keys ``{p}<leaf>``."""
    m, f = params.mixer, params.ffn
    return {
        p + "scale1": params.norm1.scale.to(dtype),
        p + "wq": m.wq.to(dtype), p + "wk": m.wk.to(dtype),
        p + "wv": m.wv.to(dtype), p + "wo": m.wo.to(dtype),
        p + "scale2": params.norm2.scale.to(dtype),
        p + "w_up": f.w_up.to(dtype), p + "w_gate": f.w_gate.to(dtype),
        p + "w_down": f.w_down.to(dtype),
    }


def _block_graph_fragment(tpc: TPContext, params, cfg, kind: str, idx: int,
                          src: str, dtype=torch.float32,
                          seq_sharded: bool = True):
    """One dense block (a :class:`repro_torch.models.transformer.Block`
    holding this rank's shards) as a period-graph fragment: nodes chained
    from value ``src``, every node name and weight key namespaced
    ``b{idx}.``. Returns (nodes, out_value, weights)."""
    if cfg.moe is not None:
        raise NotImplementedError("MoE period graphs are not ported yet "
                                  "(ROADMAP A10)")
    p = f"b{idx}."
    window = cfg.window if kind == "swa" else 0
    core = _attention_core_fn(cfg, tpc.tp, window=window,
                              rank=tpc.group.rank)
    nodes, out = _dense_block_nodes(core, True, cfg.act, p=p, src=src,
                                    seq_sharded=seq_sharded)
    return nodes, out, _block_weights(params, p, dtype)


# a period-graph weight key's leaf -> the Block parameter it holds
_WEIGHT_PARAMS = {"scale1": "norm1.scale", "scale2": "norm2.scale",
                  "wq": "mixer.wq", "wk": "mixer.wk", "wv": "mixer.wv",
                  "wo": "mixer.wo", "w_up": "ffn.w_up",
                  "w_gate": "ffn.w_gate", "w_down": "ffn.w_down"}


def replicated_weights(weights, cfg, tp: int,
                       seq_sharded: bool = True) -> frozenset:
    """The keys of a period graph's ``weights`` whose gradients are partial
    sums over a ring of ``tp``, to be all-reduced. Sequence-sharded, every
    weight each rank holds whole (:func:`param_shard_dim` None: the norm
    scales, and wk/wv when ``num_kv_heads % tp != 0``): each rank sums over
    its own sequence shard. In the replicated layout every rank sees the
    whole batch and sequence, so a norm scale's grad is complete; replicated
    wk/wv still are partial, since a rank's attention reads only the kv
    heads its q heads use (JAX's replicated-layout backward sums none of
    them, which undercounts wk/wv there: ROADMAP C)."""
    kv = ("wk", "wv")
    return frozenset(
        k for k in weights
        if param_shard_dim("blocks.0." + _WEIGHT_PARAMS[k.split(".", 1)[1]],
                           cfg, tp) is None
        and (seq_sharded or k.split(".", 1)[1] in kv))


def _period_graph(tpc: TPContext, params_seq, cfg, kinds: Sequence[str],
                  dtype=torch.float32, seq_sharded: bool = True):
    """The single-chain period graph :func:`sp_period` executes: every block
    chained through per-block ``b{i}.`` namespaces from input ``x``.
    Returns (graph, weights dict)."""
    nodes = [df.Node("x", "input")]
    weights: Dict[str, torch.Tensor] = {}
    src = "x"
    for i, (params, kind) in enumerate(zip(params_seq, kinds)):
        ns, src, w = _block_graph_fragment(tpc, params, cfg, kind, i, src,
                                           dtype=dtype,
                                           seq_sharded=seq_sharded)
        nodes += ns
        weights.update(w)
    return df.Graph(nodes, outputs=(src,)), weights


def microbatch_period_graph(base: df.Graph, num_microbatches: int
                            ) -> df.Graph:
    """``num_microbatches`` copies of a single-chain period graph merged
    into ONE graph (``mb{i}.``-prefixed values, SHARED weight keys);
    ``num_microbatches=1`` returns ``base`` unchanged."""
    if num_microbatches <= 1:
        return base
    return df.merge_graphs([base] * num_microbatches, share_weights=True)


def resolve_microbatches(tpc: TPContext, x: torch.Tensor,
                         requested: Union[int, str, None] = None,
                         moe: bool = False, seq_sharded: bool = True) -> int:
    """The effective period-graph batch split for this rank's activation
    ``x`` ((B, S/tp, d) sequence-sharded, or (B, S, d) replicated).
    ``requested=None`` defers to ``tpc.num_microbatches``; ``"auto"`` asks
    :func:`repro_torch.core.coordination.plan_microbatches` with the batch
    and the full-activation payload. The result is clamped to the largest
    value that divides the batch (1 = unsplit); ``"auto"`` never splits an
    MoE period."""
    req = tpc.num_microbatches if requested is None else requested
    b_loc = max(int(x.shape[0]), 1)
    if req == "auto":
        if moe:
            return 1
        seq = int(x.shape[1]) * (tpc.tp if seq_sharded else 1)
        payload = b_loc * seq * int(x.shape[2]) * x.element_size()
        mb = coordination.plan_microbatches(
            b_loc, float(payload), tpc.tp,
            bidirectional=tpc.cais.bidirectional, hw=tpc.hw)
    else:
        mb = int(req)
    mb = max(1, min(mb, b_loc))
    while b_loc % mb:
        mb -= 1
    return mb


def _core_comp_hints(cfg, kinds: Sequence[str], batch: int, seq: int
                     ) -> Dict[str, float]:
    """Planner ``comp_hints`` of a single-chain period graph: the FLOPs of
    each attention core (``b{i}.o``), which the lowering cannot read off
    GEMM weight shapes. Read by the perfsim planner (ROADMAP A13)."""
    from repro_torch.models.counting import attention_core_flops

    flops = attention_core_flops(cfg, batch, seq)
    return {f"b{i}.o": flops for i in range(len(kinds))}


def _plan_period(tpc: TPContext, base: df.Graph, weights, x,
                 requested: Union[int, str, None], moe: bool,
                 comp_hints: Optional[Dict[str, float]] = None,
                 seq_sharded: bool = True):
    """The (num_microbatches, pass-3 planner) decision for one period graph:
    the greedy policy's α-β split and nearest-first pairing (planner
    None)."""
    return resolve_microbatches(tpc, x, requested, moe, seq_sharded), None


def training_graph(merged: df.Graph, norm: str = "rmsnorm",
                   planner=None):
    """The backward of a (microbatch-merged) period graph: the training
    graph of its pass-2-fused form, and that graph optimized (pass 3 pairs
    across directions). Returns (TrainingGraph, optimized graph)."""
    g2 = df.fuse_sublayer_chain(df.fuse_shared_gather(
        df.fuse_compute_aware(merged)))
    tg = df.build_training_graph(g2, norm=norm)
    return tg, df.optimize(tg.graph, planner=planner)


@dataclass
class _Period:
    """One period's forward and graph-built backward on this rank."""
    tpc: TPContext
    merged: df.Graph        # the microbatch-merged graph before optimize
    graph: df.Graph         # the optimized forward
    names: Sequence[str]    # weight keys, in the order of the weight args
    replicated: frozenset   # keys whose grads are all-reduced over the ring
    mb: int
    norm: str
    planner: Optional[str] = None

    def chains(self):
        return ["x"] if self.mb == 1 else [f"mb{i}.x" for i in range(self.mb)]

    def forward(self, x: torch.Tensor, ws) -> torch.Tensor:
        values = dict(zip(self.chains(), torch.chunk(x, self.mb, dim=0)))
        res = df.execute(self.graph, values, dict(zip(self.names, ws)),
                         group=self.tpc.group, cais=self.tpc.cais,
                         norm=self.norm, backend=self.tpc.backend)
        return res[0] if self.mb == 1 else torch.cat(res, dim=0)

    def backward(self, x: torch.Tensor, ws, gy: torch.Tensor):
        """(dx, per-weight grads in the weights' types) for output cotangent
        ``gy``: the training graph executed on this rank."""
        tg, bwd = training_graph(self.merged, self.norm, self.planner)
        wmap = df.derived_weights(bwd, dict(zip(self.names, ws)))
        chains = self.chains()
        vals = dict(zip(chains, torch.chunk(x, self.mb, dim=0)))
        vals.update(zip(tg.grad_inputs, (
            g.contiguous() for g in torch.chunk(gy, self.mb, dim=0))))
        res = df.execute(bwd, vals, wmap, group=self.tpc.group,
                         cais=self.tpc.cais, norm=self.norm,
                         backend=self.tpc.backend)
        got = dict(zip(bwd.outputs, res))
        dx = torch.cat([got[tg.dx[c]] for c in chains], dim=0)
        dws = []
        for k, w in zip(self.names, ws):
            parts = [got[v] for v in tg.dweights.get(k, ())]
            dw = parts[0] if parts else torch.zeros_like(w)
            for p_ in parts[1:]:
                dw = dw + p_
            if k in self.replicated:
                dw = self.tpc.group.all_reduce(dw)
            dws.append(dw.to(w.dtype))
        return dx.to(x.dtype), dws


class _PeriodFunction(torch.autograd.Function):
    """The counterpart of ``repro``'s ``jax.custom_vjp`` around a period:
    the forward executes the optimized period graph and saves (x, weights)
    only; the backward is :meth:`_Period.backward`."""

    @staticmethod
    def forward(ctx, period: _Period, x, *ws):
        ctx.period = period
        ctx.save_for_backward(x, *ws)
        return period.forward(x, ws)

    @staticmethod
    def backward(ctx, gy):
        x, *ws = ctx.saved_tensors
        dx, dws = ctx.period.backward(x, ws, gy)
        return (None, dx, *dws)


def sp_period(tpc: TPContext, x: torch.Tensor, params_seq, cfg,
              kinds: Sequence[str], *, opts: Optional[SPOptions] = None,
              **kw):
    """A whole ``layer_pattern`` period — every block in ``kinds`` with this
    rank's shards from ``params_seq`` — built as ONE dataflow graph,
    optimized, and executed on this rank.

    ``num_microbatches`` (default: the :class:`TPContext` knob) splits the
    batch into that many independent chains merged into the same graph with
    shared weights; the outputs are concatenated back. x: (B, S/tp, d)
    sequence-sharded, or with ``seq_sharded=False`` (the decode/ragged
    layout, dense blocks only) (B, S, d) whole on every rank, the sequence
    positions ``arange(S)``. Returns (period output, shaped as x, aux loss),
    the aux loss 0 for dense periods.

    Where autograd records (x or a weight requires grad), the period runs
    as :class:`_PeriodFunction`, whose backward is graph-built
    (``tpc.graph_backward``, the default; ``False`` raises, ROADMAP A15).
    In the replicated layout the norm scales' grads are complete on each
    rank and are not summed over the ring (:func:`replicated_weights`)."""
    o = _sp_opts(opts, kw)
    if o.prefix_len:
        raise NotImplementedError("prefix-LM attention is not ported yet "
                                  "(VLM family, ROADMAP A15)")
    base, weights = _period_graph(tpc, params_seq, cfg, kinds,
                                  dtype=x.dtype, seq_sharded=o.seq_sharded)
    seq = int(x.shape[1]) * (tpc.tp if o.seq_sharded else 1)
    hints = _core_comp_hints(cfg, kinds, int(x.shape[0]), seq)
    mb, planner = _plan_period(tpc, base, weights, x, o.num_microbatches,
                               moe=False, comp_hints=hints,
                               seq_sharded=o.seq_sharded)
    merged = microbatch_period_graph(base, mb)
    period = _Period(tpc, merged, df.optimize(merged, planner=planner),
                     list(weights),
                     replicated_weights(weights, cfg, tpc.tp, o.seq_sharded),
                     mb, o.norm_kind, planner)
    ws = tuple(weights.values())
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (x,) + ws)):
        return period.forward(x, ws), aux
    if not tpc.graph_backward:
        raise NotImplementedError(
            "TPConfig(graph_backward=False) on a TP ring needs autodiff "
            "through the ring collectives, which the port does not have "
            "yet (ROADMAP A15); use the graph-built backward")
    return _PeriodFunction.apply(period, x, *ws), aux


def sp_block(tpc: TPContext, x: torch.Tensor, params, cfg,
             kind: str = "attn", *, opts: Optional[SPOptions] = None, **kw):
    """A whole pre-norm block as a single-block period (:func:`sp_period`).
    Returns (block output, aux loss)."""
    return sp_period(tpc, x, (params,), cfg, (kind,),
                     opts=_sp_opts(opts, kw))


def sp_moe_ffn(*_, **__):
    raise NotImplementedError("the MoE FFN over the TP ring is not ported "
                              "yet (ROADMAP A10)")


def _serve_attention_core_fn(cfg, tp: int, window: int = 0, rank: int = 0
                             ) -> Callable:
    """The paged-serving attention core as a multi-output ``custom`` node:
    besides q/k/v it takes the :class:`repro_torch.models.attention.KVView`
    tensors (block tables, positions, context lens) and this block's KV
    pools, writes the step's K/V through the block tables, attends over each
    row's gathered context and returns (o, kp, vp). The pools are updated in
    place (the port's departure from JAX, ``models/attention.py``), so the
    returned pools are the input tensors. Sharded pools hold this rank's kv
    heads; replicated ones are written alike on every rank and sliced to the
    rank's heads for the core."""
    from repro_torch.models.attention import (attention_core, paged_lookup,
                                              paged_update)
    from repro_torch.models.layers import apply_rope

    dh = cfg.resolved_head_dim
    H_loc, Hkv_loc = _local_heads(cfg, tp)

    def core(q, k, v, bt, qpos, ctx, kp, vp):   # one flash_attention call
        B_, S = q.shape[0], q.shape[1]
        pos = qpos.clamp_min(0)
        q = apply_rope(q.reshape(B_, S, H_loc, dh), pos, cfg.rope_theta)
        k = apply_rope(k.reshape(B_, S, Hkv_loc, dh), pos, cfg.rope_theta)
        paged_update(kp, vp, k, v.reshape(B_, S, Hkv_loc, dh), bt, qpos)
        kk, vv, kv_pos = paged_lookup(kp, vp, bt, ctx)
        kk, vv = _rank_kv(kk, vv, cfg, tp, rank)
        o = attention_core(q, kk, vv, q_positions=qpos, kv_positions=kv_pos,
                           causal=True, window=window)
        return o.reshape(B_, S, H_loc * dh), kp, vp

    core.flash_calls = 1
    return core


def _serve_block_fragment(tpc: TPContext, params, cfg, kind: str, idx: int,
                          src: str, dtype=torch.float32):
    """One dense block as a serve-period graph fragment: the
    replicated-activation block (:func:`_dense_block_nodes` with
    ``seq_sharded=False``) whose attention core is the pool-carrying
    :func:`_serve_attention_core_fn` node, reading graph inputs ``bt``,
    ``qpos``, ``ctx``, ``b{idx}.kp``, ``b{idx}.vp`` and giving
    ``b{idx}.kpn``/``b{idx}.vpn``. Returns (nodes, out_value, weights)."""
    p = f"b{idx}."
    window = cfg.window if kind == "swa" else 0
    core = _serve_attention_core_fn(cfg, tpc.tp, window=window,
                                    rank=tpc.group.rank)
    nodes, out = _dense_block_nodes(core, True, cfg.act, p=p, src=src,
                                    seq_sharded=False)
    serve = df.Node(f"{p}o", "custom",
                    (f"{p}q", f"{p}k", f"{p}v", "bt", "qpos", "ctx",
                     f"{p}kp", f"{p}vp"),
                    outputs=(f"{p}o", f"{p}kpn", f"{p}vpn"), fn=core)
    nodes = [serve if n.name == f"{p}o" else n for n in nodes]
    return nodes, out, _block_weights(params, p, dtype)


def serve_period_graph(tpc: TPContext, params_seq, cfg,
                       kinds: Sequence[str], dtype=torch.float32):
    """The graph :func:`sp_serve_period` optimizes and executes, before
    ``optimize``: inputs ``x``, ``bt``, ``qpos``, ``ctx`` and each block's
    pools, outputs the period output and each block's new pools. Returns
    (graph, weights dict)."""
    nodes = [df.Node(v, "input") for v in ("x", "bt", "qpos", "ctx")]
    weights: Dict[str, torch.Tensor] = {}
    src = "x"
    for i, (params, kind) in enumerate(zip(params_seq, kinds)):
        nodes += [df.Node(f"b{i}.kp", "input"), df.Node(f"b{i}.vp", "input")]
        ns, src, w = _serve_block_fragment(tpc, params, cfg, kind, i, src,
                                           dtype=dtype)
        nodes += ns
        weights.update(w)
    pools = tuple(f"b{i}.{n}" for i in range(len(kinds))
                  for n in ("kpn", "vpn"))
    return df.Graph(nodes, outputs=(src,) + pools), weights


def sp_serve_period(tpc: TPContext, x: torch.Tensor, params_seq, cfg,
                    kinds: Sequence[str], pools_seq, view, *,
                    norm_kind: str = "rmsnorm"):
    """A whole period of a mixed prefill/decode serving step as ONE dataflow
    graph on this rank: the serving counterpart of :func:`sp_period`. The
    activation stays replicated (decode S=1 and chunked prefill with
    S % tp != 0 alike), so pass 1 fuses every out-projection and FFN-down
    reduction into a backend-dispatched ``gemm_ar``. The block tables,
    positions and context lens (``view``, a
    :class:`repro_torch.models.attention.KVView`) and each block's pools
    (``pools_seq``, one ``{"k", "v"}`` dict a block, this rank's heads)
    enter as graph inputs of the attention core nodes; the pools are written
    in place and come back as graph outputs. The ``perfsim`` planner is
    ROADMAP A13: its context refuses to be built.

    x: (B, S_step, d) whole on every rank. Returns (period output, the
    pools list)."""
    base, weights = serve_period_graph(tpc, params_seq, cfg, kinds,
                                       dtype=x.dtype)
    graph = df.optimize(base)
    vals = {"x": x, "bt": view.block_tables, "qpos": view.positions,
            "ctx": view.context_lens}
    for i, pool in enumerate(pools_seq):
        vals[f"b{i}.kp"], vals[f"b{i}.vp"] = pool["k"], pool["v"]
    res = df.execute(graph, vals, weights, group=tpc.group, cais=tpc.cais,
                     norm=norm_kind, backend=tpc.backend)
    pools = [{"k": res[1 + 2 * i], "v": res[2 + 2 * i]}
             for i in range(len(kinds))]
    return res[0], pools


def tp_applicable(cfg, kind: str, tp: int,
                  route_ring: Optional[int] = None) -> bool:
    """Whether the explicit-backend path takes this sub-layer: Q-head and
    feature divisibility (KV heads may replicate)."""
    if kind in ("attn", "swa"):
        return cfg.num_heads % tp == 0 and cfg.norm == "rmsnorm"
    if kind == "ffn":
        return cfg.moe is None and cfg.d_ff > 0 and cfg.d_ff % tp == 0 \
            and cfg.norm == "rmsnorm"
    if kind == "moe":
        ring = tp if route_ring is None else route_ring
        return cfg.moe is not None and cfg.norm == "rmsnorm" and \
            cfg.moe.num_experts % ring == 0
    return False


# ---------------------------------------------------------------------------
# Matmul calls a period graph makes
# ---------------------------------------------------------------------------


def matmul_calls(graph: df.Graph, tpc: TPContext, batch: int, seq: int,
                 d_model: int, itemsize: int) -> int:
    """The matmul-kernel calls one rank makes executing the optimized
    dense period ``graph``, a forward, training or serve graph (its backward
    ops, the ``_dw``/``_gemm_t`` customs and ``gemm_rs`` over derived
    weights included), derived from its nodes alone: ``batch`` is each
    chain's batch, ``seq`` the full sequence, so every gathered or
    replicated activation is (batch, seq, d_model) of ``itemsize`` bytes.
    ``barrier`` issues one GEMM per weight; ``cais`` one per weight per
    micro-chunk per ring step on the gather side and one per hop (two per
    hop bidirectionally) on the reduce side. A ``gemm_col`` is one GEMM; a
    ``gemm_ar`` is the reduce side's partial GEMMs (``cais``) or one GEMM
    (``barrier``, and ``cais``'s monolithic fallback where ``seq`` does not
    split over the ring)."""
    n = tpc.tp
    s_loc = seq // n
    if n == 1 or tpc.mode == "barrier":
        def ag(k):
            return k

        def rs():
            return 1
    elif isinstance(tpc.backend, CAISBackend):
        c = tpc.cais.num_chunks
        if c is None:
            c = CAISBackend.plan_chunks(batch * seq * d_model * itemsize, n,
                                        tpc.cais.bidirectional, tpc.cais.hw)
        c = prim._pick_chunks(s_loc, c)

        def ag(k):
            return n * c * k

        def rs():
            two = tpc.cais.bidirectional and n % 2 == 0 and s_loc % 2 == 0
            return 2 * n if two else n
    else:
        raise ValueError(f"no call count for backend {tpc.mode!r}")
    calls = 0
    for node in graph.nodes:
        k = len(node.weights)
        if node.op in ("gemm_col", "gemm_row", "bwd_ag_gemm"):
            calls += 1      # bwd_ag_gemm: one GEMM over the gathered grad
        elif node.op == "custom" and node.fn in (df._dw, df._gemm_t):
            calls += 1      # a weight gradient, or a dx through wᵀ
        elif node.op in ("ag_gemm", "ag_gemm_multi"):
            calls += ag(k)
        elif node.op in ("gemm_rs", "fused_rs_ln"):
            calls += rs()
        elif node.op in ("fused_rs_ln_ag", "fused_rs_ln_ag_multi"):
            calls += rs() + ag(k - 2)
        elif node.op == "overlap_asym":
            calls += (1 + k - 1) if tpc.mode == "barrier" or n == 1 \
                else n + n * (k - 1)
        elif node.op == "gemm_ar":
            calls += rs() if seq % n == 0 else 1
    return calls


def flash_calls(graph: df.Graph) -> int:
    """The flash-attention calls one rank makes executing ``graph``: one per
    attention-core node, and in a training graph one more per core adjoint,
    whose VJP runs the core forward again (its backward is torch math)."""
    n = 0
    for node in graph.nodes:
        fn = node.fn
        n += getattr(fn, "flash_calls", 0)
        n += getattr(getattr(fn, "wrapped", None), "flash_calls", 0)
    return n


def cross_direction_pairs(merged: df.Graph, graph: df.Graph) -> list:
    """The ``overlap_asym`` nodes of ``graph``, a period's optimized training
    graph, that pair a backward collective with a forward one (``merged`` is
    the period's forward before fusion: the fused forward ops re-expose its
    value names, and every backward value is new)."""
    fwd = {v for nd in merged.nodes for v in nd.outputs}
    return [nd.name for nd in graph.nodes if nd.op == "overlap_asym"
            and (nd.outputs[0] in fwd) != (nd.outputs[1] in fwd)]
