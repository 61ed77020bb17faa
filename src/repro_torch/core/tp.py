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
block tables riding through each attention core node. An MoE block in that
layout, served or trained at a sequence that does not split over the ring,
is the counterpart of JAX's per-block GSPMD fallback: every rank routes the
whole step alike (a ``route`` node), runs the experts it holds on the
matmul kernel, and the ``expert_ar`` node's all-reduce sums the ranks'
partial outputs (:func:`_moe_replicated_nodes`); its adjoint all-reduces
the partial cotangents of the routed activation and the combine weights,
so every rank's router and aux gradients are complete.

The backward of a period is graph-built, as ``repro``'s ``jax.custom_vjp``
under ``TPConfig(graph_backward=True)``: :class:`_PeriodFunction` saves only
(x, weights); its backward builds the training graph of the pass-2-fused
period (:func:`repro_torch.core.dataflow.build_training_graph`), runs pass 3
on the merged forward+backward graph (so one chain's backward grad
reduce-scatter may pair with another chain's forward gather), executes it
on this rank, sums each weight's per-use grads and all-reduces those that
are partial over the ring (:func:`grad_groups`: in the replicated
layout every rank sees the whole batch and sequence, so only replicated
wk/wv, read a few heads a rank, and on a 2D mesh the grouped experts over
tp_in, are).

Under ``planner="perfsim"`` the perfsim schedule planner
(:mod:`repro_torch.plan`) decides the microbatch split and the pass-3
pairing of the forward, the training and the serve graphs, from the global
shapes ``repro``'s planner sees (:func:`global_weight_shapes`): the same
plans, cache keys included, as ``repro``'s.

A block that is not whole-block TP-applicable runs sub-layer by sub-layer,
as JAX's ``block_forward`` falls back: :func:`sp_attention`, :func:`sp_ffn`
and :func:`sp_moe_ffn` build, plan and execute one-sub-layer graphs as
periods (the same :class:`Period`, planner and graph-built backward), and a
sub-layer that is not TP-applicable runs replicated
(:func:`sp_replicated_mixer`: MLA, SSM, RG-LRU and attention whose query
heads do not split over the ring, over the gathered rows, whose gather's
adjoint is a reduce-scatter; :func:`sp_replicated_ffn`: an MoE whose
experts do not split over the ring). :func:`seq_rows` and
:func:`seq_gather` move an activation between the sequence-sharded layout
and one whole on every rank (``sequence_parallel=False``).

An MoE block's expert path is the period graph's ``route`` → ``a2a_ffn``
→ ``unroute`` nodes (:func:`_moe_graph_fns`): each rank routes its sequence
shard's tokens as one group, the backend's expert all-to-all carries them to
the experts' owners (experts sharded by whole expert, E/tp a rank) and back,
and every expert GEMM, forward and backward, goes through the matmul kernel.
Each rank's aux loss is its shard's; :func:`sp_period` returns their mean
over the ring. The router and a dense-residual MLP are replicated, so their
grads are summed over the ring; an expert's grads are complete at its owner.

On a 2D mesh (``tp_in`` x ``tp_out``) the group is the mesh's
:class:`repro_torch.sharding.CompositeGroup`: every shard index is the
composite index ``i_in·tp_out + i_out``, the backends run their
hierarchical compositions, and an MoE's experts are grouped (grouped EP):
sharded by whole expert over tp_out and replicated across tp_in, so the
expert all-to-all crosses tp_out only and the expert grads are summed over
tp_in (:func:`grad_groups`, JAX's ``grad_psum_axes``).

Not here yet: ``graph_backward=False`` on a ring (A15: JAX falls back to
autodiff of the executed forward, through its collectives; the port has no
autodiff through the ring collectives).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.core import coordination
from repro_torch.core import dataflow as df
from repro_torch.core import primitives as prim
from repro_torch.core.backends import (CAISBackend, CollectiveBackend,
                                       get_backend)
from repro_torch.core.primitives import CAISConfig
from repro_torch.hw import H100, HWSpec
from repro_torch.sharding import CompositeGroup, TPGroup

PLANNERS = ("greedy", "perfsim")


@dataclass(frozen=True)
class TPContext:
    """Group + collective backend + chunking config for explicit TP.

    ``backend`` may be a registry name or a :class:`CollectiveBackend`
    instance. ``num_microbatches`` is the period-graph batch split (int, or
    ``"auto"`` to size it from the α-β model via
    :func:`repro_torch.core.coordination.plan_microbatches`). ``planner``
    drives the split and pass 3: ``"greedy"`` (that α-β split and the
    nearest-independent-first pairing) or ``"perfsim"`` (the simulated-
    makespan search of :mod:`repro_torch.plan`, through its plan cache).
    ``hw`` is the target the α-β planners and the perfsim fabric read (the
    H100 by default)."""

    group: TPGroup
    backend: Union[str, CollectiveBackend] = "cais"
    cais: CAISConfig = CAISConfig()
    num_microbatches: Union[int, str] = 1
    planner: str = "greedy"
    hw: HWSpec = H100
    graph_backward: bool = True

    def __post_init__(self):
        object.__setattr__(self, "backend", get_backend(self.backend))
        if self.planner not in PLANNERS:
            raise ValueError(f"unknown planner {self.planner!r}; one of "
                             f"{PLANNERS}")
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
        """Total TP degree (the flat ring's size, or tp_in·tp_out)."""
        return self.group.size

    @property
    def is_2d(self) -> bool:
        return isinstance(self.group, CompositeGroup)

    @property
    def route_group(self) -> TPGroup:
        """The ring the MoE expert all-to-all crosses: the slow tp_out ring
        on a 2D mesh (grouped EP: experts replicate across tp_in), the
        whole TP ring on a flat one (JAX's ``route_axis``)."""
        return self.group.tp_out if self.is_2d else self.group

    @property
    def route_ring(self) -> int:
        """Size of :attr:`route_group` (the expert-sharding degree)."""
        return self.route_group.size

    @property
    def topology(self):
        """(n_inner, n_outer) ring sizes; (tp, 1) on a flat ring."""
        if self.is_2d:
            return (self.group.tp_in.size, self.group.tp_out.size)
        return (self.tp, 1)


@dataclass(frozen=True)
class SPOptions:
    """Keyword options of the ``sp_*`` entry points (``opts=SPOptions(...)``
    or the fields as direct keywords). ``seq_sharded=False`` is the
    replicated-activation (decode/ragged) layout; ``prefix_len`` marks the
    leading prefix-LM positions, which attend bidirectionally (the VLM's
    image prefix; the attention core's query rows carry absolute
    positions, so the rule holds on every rank); ``window`` is
    :func:`sp_attention`'s sliding window (0: global)."""

    prefix_len: int = 0
    window: int = 0
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


_EXPERT_LEAVES = ("ffn.w_up", "ffn.w_gate", "ffn.w_down")


def param_shard_dim(name: str, cfg, tp: int,
                    kind: Optional[str] = None) -> Optional[int]:
    """The dimension along which parameter ``name`` (a key of the port's
    ``LM`` state dict) is split over a flat TP ring of ``tp``, or None where
    it is replicated: the specs of the period-graph fragment, ``(None, M)``
    columns for wq/wk/wv/w_up/w_gate, ``(M, None)`` rows for wo/w_down. An
    MoE's experts split by whole expert (dim 0, ``e_spec``) where
    E % tp == 0 and replicate otherwise; its router and dense-residual MLP
    replicate. A mixer that is not TP-applicable (MLA, SSM, RG-LRU, and
    attention whose query heads do not split over the ring) is never
    sharded: every rank holds it whole and runs it replicated (JAX runs it
    under GSPMD, its store splitting some of its leaves: ROADMAP C,
    departure 7). ``kind`` names the block's kind where the name's index
    is no layer of ``cfg`` (a period graph's own block index). On any
    group, :func:`param_placement`."""
    if tp <= 1 or not name.startswith("blocks."):
        return None
    _, idx, leaf = name.split(".", 2)
    if leaf.startswith("mixer.") and not tp_applicable(
            cfg, kind or cfg.layer_kinds()[int(idx)], tp):
        return None
    if cfg.moe is not None and leaf.startswith("ffn."):
        if leaf in _EXPERT_LEAVES:
            return 0 if cfg.moe.num_experts % tp == 0 else None
        return None
    if leaf in ("mixer.wk", "mixer.wv"):
        return 1 if cfg.num_kv_heads % tp == 0 else None
    return _dense_shard_dim(leaf)


def _dense_shard_dim(leaf: str) -> Optional[int]:
    """A dense block's column/row rule for parameter ``leaf`` (relative to
    the block): wq/w_up/w_gate by columns, wo/w_down by rows, the rest
    whole."""
    if leaf in ("mixer.wq", "ffn.w_up", "ffn.w_gate"):
        return 1
    if leaf in ("mixer.wo", "ffn.w_down"):
        return 0
    return None


def param_placement(name: str, cfg, group: Optional[TPGroup],
                    kind: Optional[str] = None):
    """(dim, the group whose ranks split it) of parameter ``name`` on the
    TP group ``group``, or None where every rank holds it whole. On a flat
    ring, :func:`param_shard_dim` over the ring. On a 2D mesh's composite
    group the TP weights split over the composite index, and an MoE's
    experts by whole expert over tp_out (grouped EP: replicated across
    tp_in) where E % tp_out == 0."""
    if group is None or group.size <= 1 or not name.startswith("blocks."):
        return None
    if isinstance(group, CompositeGroup) and cfg.moe is not None \
            and name.split(".", 2)[2] in _EXPERT_LEAVES:
        if cfg.moe.num_experts % group.tp_out.size:
            return None
        return 0, group.tp_out
    dim = param_shard_dim(name, cfg, group.size, kind)
    return None if dim is None else (dim, group)


def shard_param(t: torch.Tensor, name: str, cfg, group) -> torch.Tensor:
    """This rank's slice of the whole parameter ``t`` by
    :func:`param_placement` (``t`` itself where it is not split)."""
    place = param_placement(name, cfg, group)
    if place is None:
        return t
    dim, g = place
    if t.shape[dim] % g.size:
        raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does not "
                         f"split over {g.size} ranks")
    size = t.shape[dim] // g.size
    return t.narrow(dim, g.rank * size, size)


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


def _moe_ffn_nodes(route_fn: Callable, expert_fn: Callable,
                   unroute_fn: Callable, expert_weights: tuple,
                   dense_fn: Optional[Callable], dense_weights: tuple,
                   p: str, src: str):
    """The MoE FFN on the normed value ``src``: route → a2a_ffn → unroute
    [+ the dense-residual MLP]. Returns (nodes, out_value, aux_value)."""
    nodes = [
        df.Node(f"{p}moe_route", "route", (src,), (f"{p}router",),
                outputs=(f"{p}send", f"{p}combine", f"{p}aux"), fn=route_fn),
        df.Node(f"{p}eout", "a2a_ffn", (f"{p}send",), expert_weights,
                fn=expert_fn),
        df.Node(f"{p}y", "unroute", (f"{p}eout", f"{p}combine", src),
                fn=unroute_fn),
    ]
    top = f"{p}y"
    if dense_fn is not None:
        nodes.append(df.Node(f"{p}dmlp", "custom", (src,),
                             dense_weights, fn=dense_fn))
        nodes.append(df.Node(f"{p}ymoe", "add", (top, f"{p}dmlp")))
        top = f"{p}ymoe"
    return nodes, top, f"{p}aux"


def _moe_block_nodes(core_fn: Callable, route_fn: Callable,
                     expert_fn: Callable, unroute_fn: Callable,
                     expert_weights: tuple,
                     dense_fn: Optional[Callable] = None,
                     dense_weights: tuple = (), p: str = "",
                     src: str = "x"):
    """One MoE block as a graph fragment: returns (nodes, out_value,
    aux_value). ``expert_weights``/``dense_weights`` are the (namespaced)
    weight keys of the expert FFN / dense-residual MLP."""
    ffn, top, aux = _moe_ffn_nodes(route_fn, expert_fn, unroute_fn,
                                   expert_weights, dense_fn, dense_weights,
                                   p, f"{p}ln2")
    nodes = _attention_block_nodes(core_fn, p, src) + [
        df.Node(f"{p}ln2", "layernorm", (f"{p}r1",), (f"{p}scale2",)),
    ] + ffn + [df.Node(f"{p}r2", "residual", (top, f"{p}r1"))]
    return nodes, f"{p}r2", aux


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


def moe_block_graph(core_fn: Callable, route_fn: Callable,
                    expert_fn: Callable, unroute_fn: Callable,
                    expert_weights: tuple,
                    dense_fn: Optional[Callable] = None,
                    dense_weights: tuple = ()) -> df.Graph:
    """One Graph for a whole MoE block: the expert path runs as ``route →
    a2a_ffn → unroute`` nodes, ``a2a_ffn`` dispatched through
    ``CollectiveBackend.a2a_expert_ffn``; ``dense_fn`` adds the Arctic-style
    dense-residual MLP as a ``custom`` node. Pass 2 fuses the attention-out
    RS → residual → LN2 → router seam into ``fused_rs_ln``."""
    nodes, out, aux = _moe_block_nodes(core_fn, route_fn, expert_fn,
                                       unroute_fn, expert_weights,
                                       dense_fn, dense_weights)
    return df.Graph([df.Node("x", "input")] + nodes, outputs=(out, aux))


def ffn_sublayer_graph(has_gate: bool, act: str, p: str = "",
                       seq_sharded: bool = True) -> df.Graph:
    """x → LN → [AG →] GEMM(up[, gate]) → act[(·)] → GEMM(down) → RS|AR as
    IR nodes (``repro``'s ``ffn_sublayer_graph``; the residual is the
    caller's). ``optimize()`` turns the collectives into the backend's fused
    schedules (ag_gemm_multi, gemm_rs; in the replicated layout gemm_col
    and gemm_ar). Weight keys ``{p}scale2``, ``{p}w_up``[, ``{p}w_gate``],
    ``{p}w_down``."""
    nodes = [df.Node("x", "input"),
             df.Node(f"{p}ln2", "layernorm", ("x",), (f"{p}scale2",))]
    nodes += _ffn_chain_nodes(f"{p}ln2", f"{p}out", has_gate, act, tag="2",
                              p=p, seq_sharded=seq_sharded)
    return df.Graph(nodes, outputs=(f"{p}out",))


def attention_sublayer_graph(core_fn: Callable, p: str = "",
                             seq_sharded: bool = True) -> df.Graph:
    """x → LN → [AG →] GEMM(q|k|v) → attention core → GEMM(out) → RS|AR as
    IR nodes (``repro``'s ``attention_sublayer_graph``; the residual is the
    caller's). Weight keys ``{p}scale1``, ``{p}wq``, ``{p}wk``, ``{p}wv``,
    ``{p}wo``."""
    nodes = _attention_block_nodes(core_fn, p, "x", seq_sharded)[:-1]
    return df.Graph([df.Node("x", "input")] + nodes,
                    outputs=(nodes[-1].name,))


def moe_sublayer_graph(route_fn: Callable, expert_fn: Callable,
                       unroute_fn: Callable, expert_weights: tuple,
                       dense_fn: Optional[Callable] = None,
                       dense_weights: tuple = (), p: str = "") -> df.Graph:
    """x → LN → route → a2a_ffn → unroute [+ dense-residual MLP] as IR
    nodes: the MoE FFN sub-layer :func:`sp_moe_ffn` runs (the residual is
    the caller's); outputs (FFN out, aux)."""
    ffn, top, aux = _moe_ffn_nodes(route_fn, expert_fn, unroute_fn,
                                   expert_weights, dense_fn, dense_weights,
                                   p, f"{p}ln2")
    nodes = [df.Node("x", "input"),
             df.Node(f"{p}ln2", "layernorm", ("x",), (f"{p}scale2",))]
    return df.Graph(nodes + ffn, outputs=(top, aux))


def _local_heads(cfg, tp: int):
    """(query heads, kv heads) a rank of a ring of ``tp`` holds: Hkv/tp kv
    heads when they shard, all Hkv when they replicate."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    return max(H // tp, 1), (max(Hkv // tp, 1) if Hkv % tp == 0 else Hkv)


def _rank_kv(k: torch.Tensor, v: torch.Tensor, cfg, tp: int, rank: int):
    """With replicated KV, the kv heads (dim 2) the rank's q heads use, made
    contiguous for the flash kernel
    (:func:`repro_torch.models.attention.rank_kv_heads`: their run where
    each of them serves as many of the rank's q heads, one copy a q head
    where the rank's q heads span them unevenly, e.g. 6 of 12 q heads over
    3 kv heads; JAX's ``shard_map`` path slices ``H_loc // g`` heads there,
    which attends with the wrong kv heads, ROADMAP C fault 7); sharded KV
    passes through."""
    from repro_torch.models.attention import rank_kv_heads

    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    if Hkv % tp == 0:
        return k, v
    hl, g = max(H // tp, 1), H // Hkv
    return rank_kv_heads(k, rank, hl, g), rank_kv_heads(v, rank, hl, g)


def _attention_core_fn(cfg, tp: int, window: int = 0, rank: int = 0,
                       prefix_len: int = 0) -> Callable:
    """The local attention math (rope, KV head slicing, the flash core,
    head reshape) as the closure of a ``custom`` node. q/k/v arrive over
    the full sequence (gathered, or replicated) with this rank's heads; with
    replicated KV the rank slices the kv heads its q heads use. The first
    ``prefix_len`` positions attend bidirectionally (prefix-LM)."""
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
                           causal=True, window=window, prefix_len=prefix_len)
        return o.reshape(B_, S, H_loc * dh)

    core.flash_calls = 1
    return core


def _block_weights(params, p: str, dtype) -> Dict[str, torch.Tensor]:
    """A block's weights under period-graph keys ``{p}<leaf>``: an MoE
    block's router stays f32, its dense-residual MLP is ``d_up``,
    ``d_gate``, ``d_down``."""
    m, f = params.mixer, params.ffn
    w = {
        p + "scale1": params.norm1.scale.to(dtype),
        p + "wq": m.wq.to(dtype), p + "wk": m.wk.to(dtype),
        p + "wv": m.wv.to(dtype), p + "wo": m.wo.to(dtype),
        p + "scale2": params.norm2.scale.to(dtype),
    }
    if getattr(f, "router", None) is not None:
        w[p + "router"] = f.router                      # stays float32
    w.update({p + "w_up": f.w_up.to(dtype), p + "w_gate": f.w_gate.to(dtype),
              p + "w_down": f.w_down.to(dtype)})
    dense = getattr(f, "dense", None)
    if dense is not None:
        w.update({p + "d_up": dense.w_up.to(dtype),
                  p + "d_gate": dense.w_gate.to(dtype),
                  p + "d_down": dense.w_down.to(dtype)})
    return w


def _act_vjp(act: str, g: torch.Tensor, da: torch.Tensor):
    """(act(g), d g) for the cotangent ``da`` of act(g): the elementwise
    VJP by ``torch.autograd``."""
    from repro_torch.models.layers import activation

    with torch.enable_grad():
        gl = g.detach().requires_grad_()
        a = activation(act, gl)
        (dg,) = torch.autograd.grad(a, gl, da)
    return a.detach(), dg


def _moe_graph_fns(cfg, ring: int, rank: int = 0):
    """Closures of the MoE expert path (route / expert compute / unroute):
    the IR node fns of :func:`sp_period`'s graph, and composed directly by
    :func:`sp_moe_ffn`. ``ring`` is the all-to-all ring's size and ``rank``
    this rank's place on it. Owner mapping: rank j owns experts
    [j·E_loc, (j+1)·E_loc) when E ≥ ring; when E < ring expert e lives on
    rank e·(ring/E) (replicated weights sliced by the owner, zero-capacity
    padding elsewhere).

    ``route_fn`` routes the rank's B·S_loc tokens as ONE group (capacity
    from T = B·S_loc) with f32 router logits. The dispatch and combine
    einsums are torch ops (JAX's are plain ``jnp``); every expert GEMM goes
    through :func:`repro_torch.core.primitives.mm`, one call per local
    expert and weight, and ``expert_fn.vjp`` is the per-row VJP the
    ``bwd_a2a_ffn`` node runs: the two forward GEMMs recomputed, then
    dx = dy·wᵀ (``nt``) and dw = xᵀ·dy (``tn``) on the kernel too."""
    from repro_torch.models.ffn import _top2_dispatch, capacity, router_probs
    from repro_torch.models.layers import activation

    m = cfg.moe
    E = m.num_experts
    E_loc = max(E // ring, 1)
    act = cfg.act

    def route_fn(xn, router):
        B, S_loc, d = xn.shape
        t = xn.reshape(B * S_loc, d)
        T = t.shape[0]
        probs = router_probs(t, router)
        cap = capacity(T, cfg)
        dispatch, combine, aux = _top2_dispatch(probs[None], cap)
        dispatch, combine = dispatch[0], combine[0]     # (T, E, cap)
        # send[j]: (E_loc·cap, d) tokens for the experts rank j owns
        de = torch.einsum("tec,td->ecd", dispatch.to(t.dtype), t)
        if E >= ring:
            send = de.reshape(ring, E_loc * cap, d)
        else:
            # owner(e) = e·(ring/E); other ranks get zero-capacity padding
            send = t.new_zeros((ring, cap, d))
            send[::ring // E] = de
        return send, combine, aux.float()[None]

    def owned(ws):
        if E >= ring:
            return ws
        e = rank // (ring // E)     # replicated weights: this owner's expert
        return tuple(w[e:e + 1] for w in ws)

    def expert_fn(chunk, wu, wg, wd):
        # chunk: (E_loc·cap, d) → each local expert's gated FFN on its rows
        wu, wg, wd = owned((wu, wg, wd))
        c = chunk.contiguous().reshape(E_loc, -1, chunk.shape[-1])
        out = [prim.mm(activation(act, prim.mm(c[e], wg[e]))
                       * prim.mm(c[e], wu[e]), wd[e])
               for e in range(E_loc)]
        return torch.stack(out).reshape(chunk.shape)

    def expert_vjp(chunk, gy, wu, wg, wd):
        full = (wu, wg, wd)
        wu, wg, wd = owned(full)
        d = chunk.shape[-1]
        # the cotangent may arrive as a strided view (an einsum's VJP)
        c = chunk.contiguous().reshape(E_loc, -1, d)
        gyc = gy.contiguous().reshape(E_loc, -1, d)
        # the weight grads are written in place, an expert at a time (at
        # full width one expert's three are 0.7 GB in f32)
        dws = tuple(torch.zeros_like(w) for w in full)
        e0 = 0 if E >= ring else rank // (ring // E)
        dc = torch.empty_like(c)
        for e in range(E_loc):
            u, g = prim.mm(c[e], wu[e]), prim.mm(c[e], wg[e])
            dh = prim.mm(gyc[e], wd[e].T)
            a, dg = _act_vjp(act, g, dh * u)
            du = dh * a
            dws[2][e0 + e] = prim.mm((a * u).T, gyc[e])
            dws[0][e0 + e] = prim.mm(c[e].T, du)
            dws[1][e0 + e] = prim.mm(c[e].T, dg)
            dc[e] = prim.mm(du, wu[e].T) + prim.mm(dg, wg[e].T)
        return dc.reshape(chunk.shape), dws

    expert_fn.vjp = expert_vjp
    expert_fn.matmul_calls = 3 * E_loc          # a row, forward
    expert_fn.vjp_matmul_calls = 8 * E_loc      # a row, its VJP

    def unroute_fn(ret, combine, xn):
        B, S_loc, d = xn.shape
        cap = combine.shape[-1]
        eout = ret.reshape(E, cap, d) if E >= ring else ret[::ring // E]
        y = torch.einsum("tec,ecd->td", combine.to(ret.dtype), eout)
        return y.reshape(B, S_loc, d)

    return route_fn, expert_fn, unroute_fn


def _dense_residual_fn(act: str) -> Callable:
    """The dense-residual MLP of an Arctic-style MoE block as a ``custom``
    node fn (local math; its weights replicate, so a rank applies them to
    its own sequence shard)."""
    from repro_torch.models.layers import activation

    def dense_fn(xn, du, dg, dd):
        return (activation(act, xn @ dg) * (xn @ du)) @ dd

    return dense_fn


def _block_graph_fragment(tpc: TPContext, params, cfg, kind: str, idx: int,
                          src: str, dtype=torch.float32,
                          seq_sharded: bool = True, prefix_len: int = 0):
    """One block (a :class:`repro_torch.models.transformer.Block` holding
    this rank's shards) as a period-graph fragment: nodes chained from value
    ``src``, every node name and weight key namespaced ``b{idx}.``. Returns
    (nodes, out_value, aux_value or None, weights)."""
    p = f"b{idx}."
    window = cfg.window if kind == "swa" else 0
    core = _attention_core_fn(cfg, tpc.tp, window=window,
                              rank=tpc.group.rank, prefix_len=prefix_len)
    weights = _block_weights(params, p, dtype)
    if cfg.moe is None:
        nodes, out = _dense_block_nodes(core, True, cfg.act, p=p, src=src,
                                        seq_sharded=seq_sharded)
        return nodes, out, None, weights
    if not seq_sharded:
        nodes, out, aux = _moe_replicated_block_nodes(core, cfg, tpc, p, src)
        return nodes, out, aux, weights
    if cfg.moe.num_experts % tpc.route_ring:
        raise ValueError("the period graph's MoE path requires "
                         "E % route_ring == 0 (see tp_applicable)")
    route_fn, expert_fn, unroute_fn = _moe_graph_fns(
        cfg, tpc.route_ring, tpc.route_group.rank)
    e_keys = (p + "w_up", p + "w_gate", p + "w_down")
    dense = cfg.moe.dense_residual_d_ff > 0
    d_keys = (p + "d_up", p + "d_gate", p + "d_down") if dense else ()
    nodes, out, aux = _moe_block_nodes(
        core, route_fn, expert_fn, unroute_fn, e_keys,
        _dense_residual_fn(cfg.act) if dense else None, d_keys, p=p,
        src=src)
    return nodes, out, aux, weights


# a period-graph weight key's leaf -> the Block parameter it holds
_WEIGHT_PARAMS = {"scale1": "norm1.scale", "scale2": "norm2.scale",
                  "wq": "mixer.wq", "wk": "mixer.wk", "wv": "mixer.wv",
                  "wo": "mixer.wo", "w_up": "ffn.w_up",
                  "w_gate": "ffn.w_gate", "w_down": "ffn.w_down",
                  "router": "ffn.router", "d_up": "ffn.dense.w_up",
                  "d_gate": "ffn.dense.w_gate",
                  "d_down": "ffn.dense.w_down"}


def _placements(weights, cfg, group: TPGroup) -> Dict[str, object]:
    """{period-graph weight key: its :func:`param_placement`} on ``group``,
    through the Block parameter each key holds. A graph's mixer weights are
    a TP-applicable attention's, whatever kind the stack's layer 0 is."""
    return {k: param_placement(
        "blocks.0." + _WEIGHT_PARAMS[k.split(".", 1)[1]], cfg, group,
        kind="attn") for k in weights}


def grad_groups(placements, group: TPGroup,
                seq_sharded: bool = True) -> Dict[str, TPGroup]:
    """The keys of a period graph's weights (each with its
    :func:`param_placement` in ``placements``) whose gradients are partial
    sums over ranks of the TP group ``group``, each with the group to
    all-reduce it over: JAX's ``grad_psum_axes``, every TP axis a weight's
    spec does not name. Sequence-sharded, every weight a rank holds whole
    (the norm scales, wk/wv when ``num_kv_heads % tp != 0``, an MoE's
    router and dense MLP) sums over the whole TP group; on a 2D mesh the
    grouped experts, split over tp_out only, sum over tp_in
    (``group.tp_in``); a weight split over the whole group sums over
    nothing. In the replicated layout every rank sees the whole batch and
    sequence, so a norm scale's grad is complete, and so are an MoE's
    router and dense-residual MLP grads: the ``expert_ar`` adjoint
    all-reduces the cotangents that reach them, and the aux loss is each
    rank's whole one. Replicated wk/wv still are partial, since a rank's
    attention reads only the kv heads its q heads use (JAX's
    replicated-layout backward sums none of them, which undercounts wk/wv
    there: ROADMAP C), and so, on a 2D mesh, are the grouped experts, of
    which each tp_in rank computes a part."""
    out: Dict[str, TPGroup] = {}
    for k, place in placements.items():
        leaf = k.split(".", 1)[1]
        if place is None:
            if seq_sharded or leaf in ("wk", "wv"):
                out[k] = group
        elif place[1] is not group and isinstance(group, CompositeGroup):
            out[k] = group.tp_in        # grouped EP: replicated over tp_in
    return out


def _period_graph(tpc: TPContext, params_seq, cfg, kinds: Sequence[str],
                  dtype=torch.float32, seq_sharded: bool = True,
                  prefix_len: int = 0):
    """The single-chain period graph :func:`sp_period` executes: every block
    chained through per-block ``b{i}.`` namespaces from input ``x``, its
    outputs the period output and then each MoE block's aux value. Returns
    (graph, weights dict)."""
    nodes = [df.Node("x", "input")]
    weights: Dict[str, torch.Tensor] = {}
    aux_vals = []
    src = "x"
    for i, (params, kind) in enumerate(zip(params_seq, kinds)):
        ns, src, aux, w = _block_graph_fragment(
            tpc, params, cfg, kind, i, src, dtype=dtype,
            seq_sharded=seq_sharded, prefix_len=prefix_len)
        nodes += ns
        weights.update(w)
        if aux is not None:
            aux_vals.append(aux)
    return df.Graph(nodes, outputs=(src,) + tuple(aux_vals)), weights


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
    ``x`` ((B, S/tp, d) sequence-sharded, or (B, S, d) replicated; B is the
    data replica's batch, JAX's ``B // dp``). ``requested=None`` defers to
    ``tpc.num_microbatches``; ``"auto"`` asks
    :func:`repro_torch.core.coordination.plan_microbatches` with the batch
    and the full-activation payload; on a 2D mesh against the tp_out ring
    with the inter-tier α-β model and the per-node payload (the outer
    exchange moves 1/tp_in of the gathered activation). The result is
    clamped to the largest value that divides the batch (1 = unsplit);
    ``"auto"`` never splits an MoE period."""
    req = tpc.num_microbatches if requested is None else requested
    b_loc = max(int(x.shape[0]), 1)
    if req == "auto":
        if moe:
            return 1
        seq = int(x.shape[1]) * (tpc.tp if seq_sharded else 1)
        payload = b_loc * seq * int(x.shape[2]) * x.element_size()
        n_in, n_out = tpc.topology
        if n_out > 1:
            mb = coordination.plan_microbatches(
                b_loc, float(payload) / max(n_in, 1), n_out,
                bidirectional=tpc.cais.bidirectional,
                hw=tpc.hw.inter_tier())
        else:
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
    each attention core (``b{i}.o``) and routed expert FFN (``b{i}.eout``),
    which the lowering cannot read off GEMM weight shapes (``batch`` a
    chain's rows, ``seq`` the full sequence). As in ``repro``, the expert
    hint is keyed on a block kind ``"moe"``, which no layer pattern holds
    (an MoE block's kind is its attention's), so an MoE period's plan, like
    ``repro``'s, prices its expert FFNs at zero (ROADMAP C)."""
    from repro_torch.models.counting import (attention_core_flops,
                                             expert_ffn_flops)

    flops = attention_core_flops(cfg, batch, seq)
    hints = {f"b{i}.o": flops for i in range(len(kinds))}
    if cfg.moe is not None:
        ef = expert_ffn_flops(cfg, batch, seq)
        hints.update({f"b{i}.eout": ef
                      for i, k in enumerate(kinds) if k == "moe"})
    return hints


def global_weight_shapes(weights, cfg, group: TPGroup
                         ) -> Dict[str, tuple]:
    """The unsharded shape of each period-graph weight, which is what
    ``repro``'s planner sees (its weights enter ``shard_map`` whole): a
    rank's shard with its :func:`param_placement` dimension multiplied back
    by the size of the group that splits it."""
    return _global_shapes(weights, _placements(weights, cfg, group))


def _global_shapes(weights, placements) -> Dict[str, tuple]:
    out = {}
    for k, w in weights.items():
        shape = list(w.shape)
        place = placements[k]
        if place is not None:
            shape[place[0]] *= place[1].size
        out[k] = tuple(shape)
    return out


def _shape_items(shapes: Dict[str, tuple]) -> tuple:
    return tuple(sorted(shapes.items()))


@dataclass(frozen=True)
class _PlanView:
    """What the perfsim planner is told about one period on this rank, in
    ``repro``'s global terms: ``x_shape`` (batch, full S, d), the unsharded
    weight shapes, the element size, the cores' FLOP hints, and ``static``,
    the hashable description the plan memo keys on (the graph's role and
    block kinds, the layout and all of the above)."""
    x_shape: tuple
    weight_shapes: Dict[str, tuple]
    dtype_bytes: int
    hints: Dict[str, float]
    static: tuple


def _plan_view(tpc: TPContext, weights, placements, kinds: Sequence[str],
               x: torch.Tensor, seq_sharded: bool,
               hints: Dict[str, float]) -> _PlanView:
    seq = int(x.shape[1]) * (tpc.tp if seq_sharded else 1)
    x_shape = (int(x.shape[0]), seq, int(x.shape[2]))
    wshapes = _global_shapes(weights, placements)
    static = (tuple(kinds), seq_sharded, x_shape, _shape_items(wshapes),
              x.element_size(), tpc.tp, tpc.topology, tpc.mode, tpc.hw,
              _shape_items(hints))
    return _PlanView(x_shape, wshapes, x.element_size(), hints, static)


def _plan_period(tpc: TPContext, base: df.Graph, x,
                 requested: Union[int, str, None], moe: bool,
                 view: Optional[_PlanView] = None, seq_sharded: bool = True):
    """The (num_microbatches, pass-3 planner, perfsim Plan) decision for one
    period graph: greedy where ``view`` is None, else perfsim.

    ``"greedy"`` keeps the α-β split (:func:`resolve_microbatches`) and the
    nearest-first pairing (planner and plan None). ``"perfsim"`` hands the
    whole decision to :func:`repro_torch.plan.search.period_planner`, over
    ``view``'s global shapes: microbatch candidates (1, 2, 4) dividing the
    batch under ``"auto"`` (1 for MoE), an explicit request fixed, scored by
    simulated makespan together with pass-3 pairings and chunk counts,
    through the process-wide plan cache and its memo."""
    if view is None:
        return (resolve_microbatches(tpc, x, requested, moe, seq_sharded),
                None, None)
    from repro_torch import plan as plan_mod

    req = tpc.num_microbatches if requested is None else requested
    b_loc = max(int(x.shape[0]), 1)
    if req == "auto":
        cands = (1,) if moe else tuple(
            m for m in (1, 2, 4) if m <= b_loc and b_loc % m == 0)
    else:
        cands = (resolve_microbatches(tpc, x, requested, moe, seq_sharded),)
    plan, pairer = plan_mod.period_planner(
        base, x_shape=view.x_shape, weight_shapes=view.weight_shapes,
        dtype_bytes=view.dtype_bytes, tp=tpc.tp, backend=tpc.mode,
        mb_candidates=cands, hw=tpc.hw, n_outer=tpc.topology[1],
        cache=plan_mod.default_cache(),
        comp_hints=view.hints, memo_key=("period", cands) + view.static)
    return plan.num_microbatches, pairer, plan


def _bwd_planner(tpc: TPContext, tg: "df.TrainingGraph", view: _PlanView,
                 mb: int):
    """The perfsim pass-3 planner of the merged forward+backward training
    graph ``tg``: a :class:`repro_torch.plan.PerfsimPlanner` over its value
    shapes (each chain's ``x`` and cotangent seed), the weight table
    extended with the derived transposed keys, and the cores' hints split
    over the chains, doubled for their ``adj.`` adjoints, as ``repro``'s."""
    from repro_torch import plan as plan_mod

    b, S, d = view.x_shape
    per = (max(b // mb, 1), S, d)
    chains = ["x"] if mb == 1 else [f"mb{i}.x" for i in range(mb)]
    vshapes = {c: per for c in chains}
    vshapes.update({gi: ((1,) if gi.endswith("aux") else per)
                    for gi in tg.grad_inputs})
    wshapes = dict(view.weight_shapes)
    wshapes.update(df.derived_weight_shapes(tg.graph, wshapes))
    bh = {}
    for k, f in view.hints.items():
        for pfx in ([""] if mb == 1 else [f"mb{i}." for i in range(mb)]):
            bh[pfx + k] = f / mb
            bh["adj." + pfx + k] = 2.0 * f / mb
    return plan_mod.PerfsimPlanner(
        value_shapes=vshapes, weight_shapes=wshapes,
        dtype_bytes=view.dtype_bytes,
        fabric=plan_mod.fabric_from_hw(tpc.hw, max(tpc.tp, 2),
                                       n_outer=tpc.topology[1]),
        backend=tpc.mode, num_microbatches=mb,
        cache=plan_mod.default_cache(), comp_hints=bh or None,
        memo_key=("train", mb) + view.static)


def training_graph(merged: df.Graph, norm: str = "rmsnorm",
                   bwd_planner: Optional[Callable] = None):
    """The backward of a (microbatch-merged) period graph: the training
    graph of its pass-2-fused form, and that graph optimized (pass 3 pairs
    across directions; ``bwd_planner`` maps the training graph to the
    pass-3 planner, None for greedy). Returns (TrainingGraph, optimized
    graph, the planner or None)."""
    g2 = df.fuse_sublayer_chain(df.fuse_shared_gather(
        df.fuse_compute_aware(merged)))
    tg = df.build_training_graph(g2, norm=norm)
    planner = bwd_planner(tg) if bwd_planner is not None else None
    return tg, df.optimize(tg.graph, planner=planner), planner


@dataclass
class Period:
    """One period's forward and graph-built backward on this rank, as
    :func:`build_period` planned them."""
    tpc: TPContext
    merged: df.Graph        # the microbatch-merged graph before optimize
    graph: df.Graph         # the optimized forward
    names: Sequence[str]    # weight keys, in the order of the weight args
    grad_groups: Dict[str, TPGroup]  # keys whose grads are all-reduced,
    #                                  and over which group
    mb: int
    norm: str
    plan: Optional[object] = None   # the forward's perfsim Plan, or None
    bwd_planner: Optional[Callable] = None  # TrainingGraph -> planner
    n_aux: int = 0          # aux outputs a chain (one an MoE block)
    seq_sharded: bool = True  # False: the replicated activation layout
    _trained: Optional[tuple] = field(default=None, init=False, repr=False,
                                      compare=False)

    def chains(self):
        return ["x"] if self.mb == 1 else [f"mb{i}.x" for i in range(self.mb)]

    def forward(self, x: torch.Tensor, ws):
        """(the period output, this rank's aux loss): the aux is each MoE
        block's aux summed, each the mean over the chains (a split period
        routes each chain with its own capacity, as in JAX), a 0-d f32
        tensor; 0 for a dense period."""
        values = dict(zip(self.chains(), torch.chunk(x, self.mb, dim=0)))
        res = df.execute(self.graph, values, dict(zip(self.names, ws)),
                         group=self.tpc.group, cais=self.tpc.cais,
                         norm=self.norm, backend=self.tpc.backend)
        per = 1 + self.n_aux
        out = res[0] if self.mb == 1 else torch.cat(
            [res[i * per] for i in range(self.mb)], dim=0)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j in range(self.n_aux):
            aux = aux + sum(res[i * per + 1 + j]
                            for i in range(self.mb)).reshape(()) / self.mb
        return out, aux

    def training(self):
        """(TrainingGraph, the optimized training graph, its planner or
        None) of this period, built once."""
        if self._trained is None:
            self._trained = training_graph(self.merged, self.norm,
                                           self.bwd_planner)
        return self._trained

    def backward(self, x: torch.Tensor, ws, gy: torch.Tensor,
                 gaux: Optional[torch.Tensor] = None):
        """(dx, per-weight grads in the weights' types) for the cotangents
        ``gy`` of the output and ``gaux`` of this rank's aux loss: the
        training graph executed on this rank, seeded per chain with its
        slice of ``gy`` and, for each aux output, ``gaux`` / mb (the
        forward's mean over the chains)."""
        tg, bwd, _ = self.training()
        wmap = df.derived_weights(bwd, dict(zip(self.names, ws)))
        chains = self.chains()
        vals = dict(zip(chains, torch.chunk(x, self.mb, dim=0)))
        seeds = []
        ga = (torch.zeros(1, dtype=torch.float32, device=x.device)
              if gaux is None else gaux.reshape(1).float()) / self.mb
        for g in torch.chunk(gy, self.mb, dim=0):
            seeds += [g.contiguous()] + [ga] * self.n_aux
        vals.update(zip(tg.grad_inputs, seeds))
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
            if k in self.grad_groups:
                dw = self.grad_groups[k].all_reduce(dw)
            dws.append(dw.to(w.dtype))
        return dx.to(x.dtype), dws


class _PeriodFunction(torch.autograd.Function):
    """The counterpart of ``repro``'s ``jax.custom_vjp`` around a period:
    the forward executes the optimized period graph and saves (x, weights)
    only, returning (output, this rank's aux loss); the backward is
    :meth:`Period.backward`."""

    @staticmethod
    def forward(ctx, period: Period, x, *ws):
        ctx.period = period
        ctx.save_for_backward(x, *ws)
        return period.forward(x, ws)

    @staticmethod
    def backward(ctx, gy, gaux):
        x, *ws = ctx.saved_tensors
        dx, dws = ctx.period.backward(x, ws, gy, gaux)
        return (None, dx, *dws)


class _RingMean(torch.autograd.Function):
    """The mean over the ring of each rank's aux loss, which every rank
    then holds (JAX's ``jnp.mean`` of the aux sharded over the ring). Its
    backward gives each rank g / tp with no collective: every rank seeds the
    same cotangent of the same replicated loss, and its own aux enters the
    mean with weight 1/tp."""

    @staticmethod
    def forward(ctx, aux, group):
        ctx.n = group.size
        return group.all_reduce(aux) / group.size

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def ring_mean(aux: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """Each rank's ``aux`` averaged over ``group``, differentiable
    (:class:`_RingMean`)."""
    return _RingMean.apply(aux, group) if group.size > 1 else aux


def _make_period(tpc: TPContext, x: torch.Tensor, base: df.Graph,
                 weights: Dict[str, torch.Tensor], placements,
                 hints: Dict[str, float], role: Sequence[str],
                 o: SPOptions) -> Period:
    """The :class:`Period` of the single-chain graph ``base`` over
    ``weights`` (each key's placement in ``placements``): split into the
    planned microbatches, optimized by the planned pass 3, its weights' grad
    groups. ``role`` names the graph in the planner's memo key (the block
    kinds of a period, ``"sub.*"`` for a one-sub-layer graph). An MoE graph
    of the replicated layout routes the whole batch as one device does: it
    is never split, and it is planned greedily under either planner, with
    no plan lookup (JAX plans none: its MoE there runs under GSPMD, and the
    layout has no pair to plan)."""
    n_aux = len(base.outputs) - 1
    if n_aux and not o.seq_sharded:
        o = dataclasses.replace(o, num_microbatches=1)
    view = (_plan_view(tpc, weights, placements, role, x, o.seq_sharded,
                       hints)
            if tpc.planner == "perfsim" and not (n_aux and not o.seq_sharded)
            else None)
    mb, planner, plan = _plan_period(tpc, base, x, o.num_microbatches,
                                     moe=n_aux > 0, view=view,
                                     seq_sharded=o.seq_sharded)
    merged = microbatch_period_graph(base, mb)
    bwd = (functools.partial(_bwd_planner, tpc, view=view, mb=mb)
           if view is not None else None)
    return Period(tpc, merged, df.optimize(merged, planner=planner),
                  list(weights),
                  grad_groups(placements, tpc.group, o.seq_sharded),
                  mb, o.norm_kind, plan, bwd, n_aux, o.seq_sharded)


def build_period(tpc: TPContext, x: torch.Tensor, params_seq, cfg,
                 kinds: Sequence[str], *, opts: Optional[SPOptions] = None,
                 **kw):
    """The :class:`Period` :func:`sp_period` runs for activation ``x`` (its
    shape and dtype are read, so a ``meta`` tensor will do): the period
    graph of this rank's shards, split into the planned microbatches and
    optimized by the planned pass 3, and the weights it reads. Returns
    (Period, weights dict)."""
    o = _sp_opts(opts, kw)
    base, weights = _period_graph(tpc, params_seq, cfg, kinds,
                                  dtype=x.dtype, seq_sharded=o.seq_sharded,
                                  prefix_len=o.prefix_len)
    seq = int(x.shape[1]) * (tpc.tp if o.seq_sharded else 1)
    hints = _core_comp_hints(cfg, kinds, int(x.shape[0]), seq)
    period = _make_period(tpc, x, base, weights,
                          _placements(weights, cfg, tpc.group), hints, kinds,
                          o)
    return period, weights


class StepRecord:
    """What the TP forwards run inside :func:`recording` executed on this
    rank: every :class:`Period` (a whole period, a per-block graph or a
    one-sub-layer graph) in the order it ran, how many mixers of each kind
    ran replicated (:func:`sp_replicated_mixer`) or on DTensors under the
    ``auto`` mode (:func:`record_auto_mixer`; a remat recompute counts
    again), and every serve period
    (:func:`sp_serve_period`: its context, optimized graph, activation
    shape and item size). A training step's kernel launches derive from it
    (:func:`step_launches`), and so do serving steps'
    (:func:`serve_launches`)."""

    def __init__(self):
        self.periods: List[Period] = []
        self.replicated_mixers: Dict[str, int] = {}
        self.auto_mixers: Dict[str, int] = {}
        self.serve: List[tuple] = []


_RECORDS: List[StepRecord] = []


@contextlib.contextmanager
def recording():
    """Record, while the block runs, what this rank's TP forwards execute
    (yields the :class:`StepRecord`)."""
    rec = StepRecord()
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


def record_auto_mixer(kind: str) -> None:
    """Count one mixer of ``kind`` run under the ``auto`` mode in every
    active :func:`recording`."""
    for rec in _RECORDS:
        rec.auto_mixers[kind] = rec.auto_mixers.get(kind, 0) + 1


def _run_period(period: Period, x: torch.Tensor, ws: tuple):
    """Execute ``period`` on this rank: as :class:`_PeriodFunction` where
    autograd records (x or a weight requires grad), plainly otherwise.
    Returns (output, the aux loss's mean over the ring; 0 without aux)."""
    for rec in _RECORDS:
        rec.periods.append(period)
    tpc = period.tpc
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (x,) + ws)):
        out, aux = period.forward(x, ws)
    elif not tpc.graph_backward:
        raise NotImplementedError(
            "TPConfig(graph_backward=False) on a TP ring needs autodiff "
            "through the ring collectives, which the port does not have "
            "yet (ROADMAP A15); use the graph-built backward")
    else:
        out, aux = _PeriodFunction.apply(period, x, *ws)
    # a sequence shard's aux is its own; in the replicated layout every
    # rank's is the whole batch's already
    mean = period.n_aux and period.seq_sharded
    return out, (ring_mean(aux, tpc.group) if mean else aux)


def sp_period(tpc: TPContext, x: torch.Tensor, params_seq, cfg,
              kinds: Sequence[str], *, opts: Optional[SPOptions] = None,
              **kw):
    """A whole ``layer_pattern`` period — every block in ``kinds`` with this
    rank's shards from ``params_seq`` — built as ONE dataflow graph,
    optimized, and executed on this rank.

    ``num_microbatches`` (default: the :class:`TPContext` knob) splits the
    batch into that many independent chains merged into the same graph with
    shared weights; the outputs are concatenated back. Under
    ``planner="perfsim"`` the split and pass 3 come from the plan
    (:func:`build_period`). x: (B, S/tp, d) sequence-sharded, or with
    ``seq_sharded=False`` (the decode/ragged layout) (B, S, d) whole on
    every rank, the sequence positions ``arange(S)``. Returns (period
    output, shaped as x, aux loss): the aux loss is the mean over the ring
    of each rank's (its shard's MoE statistics; the same value on every
    rank), in the replicated layout every rank's own (the whole batch's),
    0 for dense periods. ``"auto"`` never splits an MoE period; an explicit
    split of a sequence-sharded one routes each chain with its own capacity
    and reports the mean of the chains' aux, as JAX's does; one of the
    replicated layout is never split.

    Where autograd records (x or a weight requires grad), the period runs
    as :class:`_PeriodFunction`, whose backward is graph-built
    (``tpc.graph_backward``, the default; ``False`` raises, ROADMAP A15).
    In the replicated layout the norm scales' grads are complete on each
    rank and are not summed over the ring (:func:`grad_groups`)."""
    period, weights = build_period(tpc, x, params_seq, cfg, kinds,
                                   opts=_sp_opts(opts, kw))
    return _run_period(period, x, tuple(weights.values()))


def sp_block(tpc: TPContext, x: torch.Tensor, params, cfg,
             kind: str = "attn", *, opts: Optional[SPOptions] = None, **kw):
    """A whole pre-norm block as a single-block period (:func:`sp_period`).
    Returns (block output, aux loss)."""
    return sp_period(tpc, x, (params,), cfg, (kind,),
                     opts=_sp_opts(opts, kw))


# ---------------------------------------------------------------------------
# Sub-layers: one-sub-layer periods, and the replicated sub-layers of a ring
# ---------------------------------------------------------------------------
#
# A block that is not whole-block TP-applicable (an MLA mixer, an MoE whose
# experts do not split over the ring) runs sub-layer by sub-layer, as JAX's
# ``block_forward`` falls back: a TP-applicable sub-layer as its own
# one-sub-layer period (:func:`sp_attention`, :func:`sp_ffn`,
# :func:`sp_moe_ffn`: the same Period, planner and graph-built backward as a
# whole period), the others replicated. JAX runs those under GSPMD; here
# they are explicit (:func:`sp_replicated_mixer`, :func:`sp_replicated_ffn`).


def _ffn_placements(weights, group: TPGroup):
    """A dense FFN sub-layer's placements on ``group``, by the dense rule
    (:func:`_dense_shard_dim`): up/gate by columns, down by rows, the norm
    scale whole."""
    dims = {k: _dense_shard_dim(_WEIGHT_PARAMS[k.split(".", 1)[1]])
            for k in weights}
    return {k: None if d is None else (d, group) for k, d in dims.items()}


def build_ffn_sublayer(tpc: TPContext, x: torch.Tensor, norm_scale, w_up,
                       w_gate, w_down, act: str, *,
                       opts: Optional[SPOptions] = None, **kw):
    """The one-sub-layer :class:`Period` :func:`sp_ffn` runs for ``x`` (a
    ``meta`` tensor will do) and its weights dict."""
    o = _sp_opts(opts, kw)
    p = "b0."
    base = ffn_sublayer_graph(w_gate is not None, act, p=p,
                              seq_sharded=o.seq_sharded)
    weights = {p + "scale2": norm_scale, p + "w_up": w_up}
    if w_gate is not None:
        weights[p + "w_gate"] = w_gate
    weights[p + "w_down"] = w_down
    period = _make_period(tpc, x, base, weights,
                          _ffn_placements(weights, tpc.group), {},
                          ("sub.ffn",), o)
    return period, weights


def sp_ffn(tpc: TPContext, x: torch.Tensor, norm_scale, w_up, w_gate,
           w_down, act: str, *, opts: Optional[SPOptions] = None, **kw):
    """The FFN sub-layer FFN(LN(x)) (the residual is the caller's) as a
    one-sub-layer period: :func:`ffn_sublayer_graph` built, split into the
    planned microbatches, optimized and executed on this rank, with the
    graph-built backward where autograd records. ``w_gate`` may be None.
    x: (B, S/tp, d) sequence-sharded, or with ``seq_sharded=False`` (B, S,
    d) whole on every rank (the down projection then ends in a
    ``gemm_ar``). The weights are this rank's shards: up/gate by columns,
    down by rows."""
    period, weights = build_ffn_sublayer(tpc, x, norm_scale, w_up, w_gate,
                                         w_down, act, opts=_sp_opts(opts, kw))
    return _run_period(period, x, tuple(weights.values()))[0]


def build_attention_sublayer(tpc: TPContext, x: torch.Tensor, norm_scale,
                             wq, wk, wv, wo, cfg, *,
                             opts: Optional[SPOptions] = None, **kw):
    """The one-sub-layer :class:`Period` :func:`sp_attention` runs for
    ``x`` and its weights dict."""
    o = _sp_opts(opts, kw)
    p = "b0."
    core = _attention_core_fn(cfg, tpc.tp, window=o.window,
                              rank=tpc.group.rank, prefix_len=o.prefix_len)
    base = attention_sublayer_graph(core, p=p, seq_sharded=o.seq_sharded)
    weights = {p + "scale1": norm_scale, p + "wq": wq, p + "wk": wk,
               p + "wv": wv, p + "wo": wo}
    seq = int(x.shape[1]) * (tpc.tp if o.seq_sharded else 1)
    hints = _core_comp_hints(cfg, ("attn",), int(x.shape[0]), seq)
    period = _make_period(tpc, x, base, weights,
                          _placements(weights, cfg, tpc.group), hints,
                          ("sub.attn",), o)
    return period, weights


def sp_attention(tpc: TPContext, x: torch.Tensor, norm_scale, wq, wk, wv,
                 wo, cfg, *, opts: Optional[SPOptions] = None, **kw):
    """The attention sub-layer attn(LN(x)) (the residual is the caller's)
    as a one-sub-layer period over :func:`attention_sublayer_graph`; Q heads
    shard over the ring, K/V too where ``num_kv_heads % tp == 0`` and
    replicate otherwise (every rank projects all kv heads and its core
    slices the ones its q heads use, as :func:`_attention_core_fn` does).
    Options ``window``, ``norm_kind``, ``seq_sharded`` and
    ``num_microbatches`` as :class:`SPOptions` keywords."""
    period, weights = build_attention_sublayer(
        tpc, x, norm_scale, wq, wk, wv, wo, cfg, opts=_sp_opts(opts, kw))
    return _run_period(period, x, tuple(weights.values()))[0]


def build_moe_sublayer(tpc: TPContext, x: torch.Tensor, norm_scale, params,
                       cfg, norm_kind: str = "rmsnorm",
                       seq_sharded: bool = True):
    """The one-sub-layer :class:`Period` :func:`sp_moe_ffn` runs for ``x``
    and its weights dict: never split into microbatches (each chain would
    route with its own capacity, which JAX's ``sp_moe_ffn`` does not)."""
    p = "b0."
    dense = params.dense is not None
    if seq_sharded:
        E, ring = cfg.moe.num_experts, tpc.route_ring
        if not (E % ring == 0 or ring % E == 0):
            raise ValueError(f"{E} experts do not map onto a ring of {ring}")
        route_fn, expert_fn, unroute_fn = _moe_graph_fns(
            cfg, ring, tpc.route_group.rank)
        e_keys = (p + "w_up", p + "w_gate", p + "w_down")
        d_keys = (p + "d_up", p + "d_gate", p + "d_down") if dense else ()
        base = moe_sublayer_graph(
            route_fn, expert_fn, unroute_fn, e_keys,
            _dense_residual_fn(cfg.act) if dense else None, d_keys, p=p)
    else:
        ffn, top, aux = _moe_replicated_nodes(cfg, tpc, p, f"{p}ln2")
        base = df.Graph([df.Node("x", "input"),
                         df.Node(f"{p}ln2", "layernorm", ("x",),
                                 (f"{p}scale2",))] + ffn,
                        outputs=(top, aux))
    dt = x.dtype
    weights = {p + "scale2": norm_scale, p + "router": params.router,
               p + "w_up": params.w_up.to(dt),
               p + "w_gate": params.w_gate.to(dt),
               p + "w_down": params.w_down.to(dt)}
    if dense:
        weights.update({p + "d_up": params.dense.w_up.to(dt),
                        p + "d_gate": params.dense.w_gate.to(dt),
                        p + "d_down": params.dense.w_down.to(dt)})
    period = _make_period(tpc, x, base, weights,
                          _placements(weights, cfg, tpc.group), {},
                          ("sub.moe",),
                          SPOptions(norm_kind=norm_kind, num_microbatches=1,
                                    seq_sharded=seq_sharded))
    return period, weights


def sp_moe_ffn(tpc: TPContext, x: torch.Tensor, norm_scale: torch.Tensor,
               params, cfg, norm_kind: str = "rmsnorm",
               seq_sharded: bool = True):
    """The MoE FFN sub-layer with the backend's expert all-to-all, as a
    one-sub-layer period (:func:`moe_sublayer_graph`; differentiable by its
    graph-built backward): each rank routes its sequence shard's tokens to
    the experts' owners through the :func:`_moe_graph_fns` closures.
    ``params`` is this rank's :class:`repro_torch.models.ffn.MoE`: experts
    sharded by whole expert where E % ring == 0, all E replicated where
    E < ring (ring % E == 0; expert e on rank e·(ring/E), the others
    computing on zero-capacity padding); on a 2D mesh the ring is tp_out
    (grouped EP). x: (B, S/tp, d) sequence-sharded. Returns (FFN(LN(x)),
    the aux loss's mean over the TP group); the residual is the caller's.
    With ``seq_sharded=False`` (x (B, S, d) whole on every rank) the MoE of
    the replicated layout (:func:`_moe_replicated_nodes`: the whole batch
    routed alike on every rank, this rank's experts, one all-reduce where
    they split), and the aux loss every rank's own, the whole batch's."""
    period, weights = build_moe_sublayer(tpc, x, norm_scale, params, cfg,
                                         norm_kind, seq_sharded)
    return _run_period(period, x, tuple(weights.values()))


class _SeqGather(torch.autograd.Function):
    """All-gather of the rank's sequence rows (B, S/tp, ·) into (B, S, ·).
    Its adjoint depends on what lies downstream: where each rank keeps
    only its own rows of what it computes from the gathered value
    (``partial=True``), each rank's cotangent of it is partial and the
    adjoint is a reduce-scatter; where every rank computes the same loss
    from it (``partial=False``: the activation whole between periods), the
    cotangent is replicated and the adjoint keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group, partial):
        ctx.group, ctx.partial, ctx.s = group, partial, x.shape[1]
        return group.all_gather(x, 1)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return ctx.group.reduce_scatter(g.contiguous(), 1), None, None
        r, s = ctx.group.rank, ctx.s
        return g[:, r * s:(r + 1) * s].contiguous(), None, None


class _SeqRows(torch.autograd.Function):
    """This rank's sequence rows of an activation whole (and the same) on
    every rank. The rows' cotangents are each rank's complete part of the
    whole's, so the adjoint all-gathers them."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        s = x.shape[1] // group.size
        return x[:, group.rank * s:(group.rank + 1) * s].contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g.contiguous(), 1), None


def seq_gather(x: torch.Tensor, group: TPGroup,
               partial: bool) -> torch.Tensor:
    """(B, S/tp, ·) rows → (B, S, ·) on every rank, differentiable
    (:class:`_SeqGather`)."""
    return _SeqGather.apply(x, group, partial) if group.size > 1 else x


def seq_rows(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """This rank's (B, S/tp, ·) rows of (B, S, ·), differentiable
    (:class:`_SeqRows`)."""
    return _SeqRows.apply(x, group) if group.size > 1 else x


def sp_replicated_mixer(tpc: TPContext, x: torch.Tensor, norm_scale,
                        mixer_fn: Callable, norm_kind: str = "rmsnorm",
                        seq_sharded: bool = True, *,
                        kind: str) -> torch.Tensor:
    """A mixer of ``kind`` that is not TP-applicable (MLA, SSM, RG-LRU,
    attention whose query heads do not split over the ring), whole weights
    on every rank (JAX runs it under GSPMD). Sequence-sharded (x (B, S/tp,
    d)): the normed rows all-gathered along the sequence, ``mixer_fn`` on
    the whole sequence, this rank's rows of its output kept; the gather's
    adjoint is a reduce-scatter (each rank's cotangent of the gathered rows is
    partial), and the mixer's weight grads are partial sums over the ranks,
    summed over the ring once a step
    (:meth:`repro_torch.models.transformer.LM.sync_grads`). With
    ``seq_sharded=False`` (x (B, S, d) whole on every rank) ``mixer_fn`` on
    the normed x, its grads complete on every rank."""
    from repro_torch.models.layers import apply_norm

    for rec in _RECORDS:
        rec.replicated_mixers[kind] = rec.replicated_mixers.get(kind, 0) + 1
    h = apply_norm(norm_kind, x, norm_scale)
    if not seq_sharded:
        return mixer_fn(h)
    full = seq_gather(h, tpc.group, partial=True)
    r, s = tpc.group.rank, x.shape[1]
    return mixer_fn(full)[:, r * s:(r + 1) * s]


def sp_replicated_ffn(tpc: TPContext, x: torch.Tensor, norm_scale,
                      ffn_fn: Callable, norm_kind: str = "rmsnorm"):
    """An FFN that is not TP-applicable (an MoE whose experts replicate:
    E % route_ring != 0), on a sequence-sharded ring: ``ffn_fn`` (per token,
    its whole weights) on this rank's normed rows, its aux loss the mean
    over the ring (as :func:`sp_period` reports it). Its weight grads are
    partial sums over the ranks, summed over the ring once a step. Returns
    (FFN(LN(x)), aux)."""
    from repro_torch.models.layers import apply_norm

    out, aux = ffn_fn(apply_norm(norm_kind, x, norm_scale))
    return out, ring_mean(aux.reshape(()), tpc.group)


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
                                              paged_update,
                                              padding_rows_as_jax)
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
        o = padding_rows_as_jax(o, vv, qpos)
        return o.reshape(B_, S, H_loc * dh), kp, vp

    core.flash_calls = 1
    return core


def serve_experts(cfg, tpc: TPContext):
    """(first, end, stored) of an MoE in the replicated activation layout
    (a serve step, a ragged training step) on this rank: the global
    indices [first, end) of the experts it computes, and ``stored``, the
    global index of its first stored expert (its expert weights' index
    0). Where the route ring splits the experts (E % route_ring == 0) a rank
    holds E/route_ring whole experts (:func:`param_placement`); on a 2D mesh
    every tp_in rank of a tp_out index holds the same ones (grouped EP), and
    each computes its tp_in share of them. So over the TP group every
    expert is computed exactly once, and one all-reduce over the group sums
    the ranks' partial outputs (JAX's grouped EP splits the expert hidden
    dim over tp_in instead: its reduction too spans both axes). Otherwise
    the experts replicate and every rank computes all E (``end - first ==
    E``), with no reduction."""
    E, ring = cfg.moe.num_experts, tpc.route_ring
    if E % ring:
        return 0, E, 0
    e_loc = E // ring
    stored = tpc.route_group.rank * e_loc
    if not tpc.is_2d:
        return stored, stored + e_loc, stored
    n, i = tpc.group.tp_in.size, tpc.group.tp_in.rank
    return stored + i * e_loc // n, stored + (i + 1) * e_loc // n, stored


def _moe_replicated_fns(cfg, tpc: TPContext):
    """(route_fn, experts) of an MoE FFN in the replicated activation layout,
    the node fns of :func:`_moe_replicated_nodes`.

    ``route_fn(xn, router)`` routes the whole normed (B, S, d) activation,
    bitwise equal on every rank, alike on every rank: one device's groups
    and capacities, padding rows included
    (:func:`repro_torch.models.ffn.route_tokens`), giving (dispatch,
    combine, aux). ``experts(xn, dispatch, combine, wu, wg, wd)``
    dispatches the tokens to the (G, C) buffers of the experts this rank
    computes (:func:`serve_experts`), runs each one's gated FFN on its G·C
    rows through :func:`repro_torch.core.primitives.mm` (three calls an
    expert: ``matmul_calls``) and combines them: this rank's partial sum of
    the FFN output, all of it where the experts replicate. ``experts.vjp``
    is its declared VJP, ``(xn, dispatch, combine, gy, wu, wg, wd) ->
    (d xn, zeros for the mask, d combine, d wu, d wg, d wd)``: this rank's
    partial input cotangents and its experts' weight grads (zero for a
    stored expert another tp_in rank computes), nine calls an expert on the
    kernel: the forward's three again (d combine reads the expert outputs),
    dh = dy·w_downᵀ and the row grads du·w_upᵀ, dg·w_gateᵀ (``nt``), the
    weight grads hᵀ·dy, xᵀ·du, xᵀ·dg (``tn``)."""
    from repro_torch.models.ffn import route_tokens
    from repro_torch.models.layers import activation

    first, end, stored = serve_experts(cfg, tpc)
    n = end - first
    local = range(first - stored, end - stored)
    act = cfg.act

    def route_fn(xn, router):
        _, dispatch, combine, aux = route_tokens(xn, router, cfg)
        return dispatch, combine, aux.float()[None]

    def rows_of(xn, dispatch):
        """(n, G·C, d): each computed expert's buffer rows."""
        G, g = dispatch.shape[:2]
        d = xn.shape[-1]
        einp = torch.einsum("gsec,gsd->egcd",
                            dispatch[:, :, first:end].to(xn.dtype),
                            xn.reshape(G, g, d))
        return einp.contiguous().reshape(n, -1, d)

    def experts(xn, dispatch, combine, wu, wg, wd):
        if n == 0:              # a tp_in rank with no expert of its own
            return xn.new_zeros(xn.shape)
        G, C = dispatch.shape[0], dispatch.shape[-1]
        eout = torch.stack([
            prim.mm(activation(act, prim.mm(r, wg[j])) * prim.mm(r, wu[j]),
                    wd[j])
            for r, j in zip(rows_of(xn, dispatch), local)])
        y = torch.einsum("gsec,egcd->gsd",
                         combine[:, :, first:end].to(xn.dtype),
                         eout.reshape(n, G, C, xn.shape[-1]))
        return y.reshape(xn.shape)

    def experts_vjp(xn, dispatch, combine, gy, wu, wg, wd):
        # the weight grads are written in place, an expert at a time (at
        # full width one expert's three are 0.7 GB in f32)
        dws = tuple(torch.zeros_like(w) for w in (wu, wg, wd))
        dmask, dcomb = torch.zeros_like(dispatch), torch.zeros_like(combine)
        if n == 0:
            return (torch.zeros_like(xn), dmask, dcomb) + dws
        G, g, _, C = dispatch.shape
        d = xn.shape[-1]
        rows = rows_of(xn, dispatch)
        gyt = gy.reshape(G, g, d)
        # the rows' output cotangents: the combine's adjoint
        dout = torch.einsum("gsec,gsd->egcd",
                            combine[:, :, first:end].to(xn.dtype),
                            gyt).contiguous().reshape(n, G * C, d)
        eout, drows = torch.empty_like(rows), torch.empty_like(rows)
        for i, j in enumerate(local):
            r, dy = rows[i], dout[i]
            u, gt = prim.mm(r, wu[j]), prim.mm(r, wg[j])
            dh = prim.mm(dy, wd[j].T)
            a, dgt = _act_vjp(act, gt, dh * u)
            h = a * u
            eout[i] = prim.mm(h, wd[j])
            du = dh * a
            dws[2][j] = prim.mm(h.T, dy)
            dws[0][j] = prim.mm(r.T, du)
            dws[1][j] = prim.mm(r.T, dgt)
            drows[i] = prim.mm(du, wu[j].T) + prim.mm(dgt, wg[j].T)
        dcomb[:, :, first:end] = torch.einsum(
            "gsd,egcd->gsec", gyt, eout.reshape(n, G, C, d)).to(dcomb.dtype)
        dxn = torch.einsum("gsec,egcd->gsd",
                           dispatch[:, :, first:end].to(xn.dtype),
                           drows.reshape(n, G, C, d))
        return (dxn.reshape(xn.shape), dmask, dcomb) + dws

    experts.vjp = experts_vjp
    experts.matmul_calls = 3 * n
    experts_vjp.matmul_calls = 9 * n
    return route_fn, experts


def _moe_replicated_nodes(cfg, tpc: TPContext, p: str, src: str):
    """The MoE FFN of the replicated activation layout on the normed value
    ``src`` (whole and bitwise equal on every rank): GSPMD's per-block MoE
    of JAX (a serve step; a training step at a sequence that does not
    split over the ring) as explicit ops. A ``route`` node, run alike on
    every rank over the whole step, then this rank's experts: an
    ``expert_ar`` node, whose all-reduce sums the ranks' partial outputs,
    where the experts split (a ``custom`` node with no reduction where they
    replicate; :func:`_moe_replicated_fns`), then the dense-residual MLP
    where the arch has one (replicated, so added once, after the sum).
    Returns (nodes, out_value, aux_value)."""
    route_fn, experts = _moe_replicated_fns(cfg, tpc)
    split = cfg.moe.num_experts % tpc.route_ring == 0
    nodes = [
        df.Node(f"{p}moe_route", "route", (src,), (f"{p}router",),
                outputs=(f"{p}dispatch", f"{p}combine", f"{p}aux"),
                fn=route_fn),
        df.Node(f"{p}moe", "expert_ar" if split else "custom",
                (src, f"{p}dispatch", f"{p}combine"),
                (p + "w_up", p + "w_gate", p + "w_down"), fn=experts)]
    top = f"{p}moe"
    if cfg.moe.dense_residual_d_ff:
        nodes += [df.Node(f"{p}dmlp", "custom", (src,),
                          (p + "d_up", p + "d_gate", p + "d_down"),
                          fn=_dense_residual_fn(cfg.act)),
                  df.Node(f"{p}ymoe", "add", (top, f"{p}dmlp"))]
        top = f"{p}ymoe"
    return nodes, top, f"{p}aux"


def _moe_replicated_block_nodes(core_fn: Callable, cfg, tpc: TPContext,
                                p: str, src: str):
    """A whole MoE block in the replicated activation layout: the attention
    of :func:`_attention_block_nodes` (no gather; the out-projection's
    allreduce, which pass 1 fuses to ``gemm_ar``), ln2, the MoE FFN of
    :func:`_moe_replicated_nodes`, the residual. Returns (nodes, out_value,
    aux_value)."""
    ffn, top, aux = _moe_replicated_nodes(cfg, tpc, p, f"{p}ln2")
    nodes = _attention_block_nodes(core_fn, p, src, seq_sharded=False) + [
        df.Node(f"{p}ln2", "layernorm", (f"{p}r1",), (f"{p}scale2",))
    ] + ffn + [df.Node(f"{p}r2", "residual", (top, f"{p}r1"))]
    return nodes, f"{p}r2", aux


def _serve_block_fragment(tpc: TPContext, params, cfg, kind: str, idx: int,
                          src: str, dtype=torch.float32):
    """One block as a serve-period graph fragment in the replicated
    activation layout, its attention core the pool-carrying
    :func:`_serve_attention_core_fn` node, reading graph inputs ``bt``,
    ``qpos``, ``ctx``, ``b{idx}.kp``, ``b{idx}.vp`` and giving
    ``b{idx}.kpn``/``b{idx}.vpn``; the out-projection ends in an allreduce,
    which pass 1 fuses to ``gemm_ar``. A dense block's FFN is the
    replicated-layout chain of :func:`_dense_block_nodes`; an MoE block is
    :func:`_moe_replicated_block_nodes` (its aux is not a graph output).
    Returns (nodes, out_value, weights)."""
    p = f"b{idx}."
    window = cfg.window if kind == "swa" else 0
    core = _serve_attention_core_fn(cfg, tpc.tp, window=window,
                                    rank=tpc.group.rank)
    if cfg.moe is None:
        nodes, out = _dense_block_nodes(core, True, cfg.act, p=p, src=src,
                                        seq_sharded=False)
    else:
        nodes, out, _ = _moe_replicated_block_nodes(core, cfg, tpc, p, src)
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


def serve_planner(tpc: TPContext, cfg, kinds: Sequence[str], weights,
                  x: torch.Tensor, pools_seq, view):
    """The pass-3 planner of a serve period: None under ``"greedy"``; under
    ``"perfsim"`` a :class:`repro_torch.plan.PerfsimPlanner` over the graph's
    value shapes as ``repro`` gives them (x; the block tables, positions and
    context lens; each block's pools with all kv heads), the unsharded
    weight shapes and the cores' FLOP hints, memoized in the process on
    those shapes and the block kinds. An MoE serve period takes no planner
    under either: JAX plans none (its ``_blocks_step`` runs MoE serving
    per block, under GSPMD), and the replicated layout has no pair to plan
    anyway."""
    if tpc.planner != "perfsim" or cfg.moe is not None:
        return None
    from repro_torch import plan as plan_mod

    kv_tp = tpc.tp if cfg.num_kv_heads % tpc.tp == 0 else 1
    vshapes = {"x": tuple(x.shape), "bt": tuple(view.block_tables.shape),
               "qpos": tuple(view.positions.shape),
               "ctx": tuple(view.context_lens.shape)}
    for i, pool in enumerate(pools_seq):
        for kk, name in (("k", "kp"), ("v", "vp")):
            shape = list(pool[kk].shape)
            shape[2] *= kv_tp
            vshapes[f"b{i}.{name}"] = tuple(shape)
    wshapes = global_weight_shapes(weights, cfg, tpc.group)
    hints = _core_comp_hints(cfg, kinds, int(x.shape[0]), int(x.shape[1]))
    static = ("serve", tuple(kinds), _shape_items(vshapes),
              _shape_items(wshapes), x.element_size(), tpc.tp, tpc.topology,
              tpc.mode, tpc.hw, _shape_items(hints))
    return plan_mod.PerfsimPlanner(
        value_shapes=vshapes, weight_shapes=wshapes,
        dtype_bytes=x.element_size(),
        fabric=plan_mod.fabric_from_hw(tpc.hw, max(tpc.tp, 2),
                                       n_outer=tpc.topology[1]),
        backend=tpc.mode, cache=plan_mod.default_cache(), comp_hints=hints,
        memo_key=static)


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
    in place and come back as graph outputs. Under ``planner="perfsim"``
    pass 3 comes from the plan over the serve graph's own value shapes
    (:func:`serve_planner`); the layout has no gemm_rs/ag_gemm pair, so the
    plan pairs nothing. An MoE period routes the whole step on every rank,
    runs the rank's experts and all-reduces their partial sum
    (:func:`_moe_replicated_nodes`); it takes no planner.

    x: (B, S_step, d) whole on every rank. Returns (period output, the
    pools list)."""
    base, weights = serve_period_graph(tpc, params_seq, cfg, kinds,
                                       dtype=x.dtype)
    graph = df.optimize(base, planner=serve_planner(
        tpc, cfg, kinds, weights, x, pools_seq, view))
    for rec in _RECORDS:
        rec.serve.append((tpc, graph, tuple(x.shape), x.element_size()))
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
    period ``graph``, a forward, training or serve graph (its backward
    ops, the ``_dw``/``_gemm_t`` customs and ``gemm_rs`` over derived
    weights included; an expert all-to-all runs its expert fn, or the fn's
    VJP, on each of the route ring's rows; an ``expert_ar`` node, and the
    ``custom`` node of its VJP or of replicated experts, the calls its fn
    declares), derived from its nodes alone:
    ``batch`` is each chain's batch, ``seq`` the full sequence, so every
    gathered or replicated activation is (batch, seq, d_model) of
    ``itemsize`` bytes. ``barrier`` issues one GEMM per weight; ``cais``
    one per weight per micro-chunk per ring step on the gather side and
    one per hop (two per hop bidirectionally) on the reduce side. A
    ``gemm_col`` is one GEMM; a ``gemm_ar`` is the reduce side's partial
    GEMMs (``cais``) or one GEMM (``barrier``, and ``cais``'s monolithic
    fallback where ``seq`` does not split over the ring). On a 2D mesh the
    GEMMs are the fused schedules' on the tp_in ring (the outer legs move
    data only): its gather side over the sequence gathered across tp_out,
    its reduce side to shards of seq/tp_in; the overlap pair runs its two
    sides one after the other."""
    n = tpc.tp
    ring = tpc.topology[0]          # the ring the fused GEMM schedules use
    s_loc = seq // ring
    if ring == 1 or tpc.mode == "barrier":
        def ag(k):
            return k

        def rs():
            return 1
    elif isinstance(tpc.backend, CAISBackend):
        c = tpc.cais.num_chunks
        if c is None:
            c = CAISBackend.plan_chunks(batch * seq * d_model * itemsize,
                                        ring, tpc.cais.bidirectional,
                                        tpc.cais.hw)
        c = prim._pick_chunks(s_loc, c)

        def ag(k):
            return ring * c * k

        def rs():
            two = tpc.cais.bidirectional and ring % 2 == 0 and s_loc % 2 == 0
            return 2 * ring if two else ring
    else:
        raise ValueError(f"no call count for backend {tpc.mode!r}")
    calls = 0
    for node in graph.nodes:
        k = len(node.weights)
        if node.op == "a2a_ffn":    # the expert fn on each route-ring row
            calls += tpc.route_ring * node.fn.matmul_calls
        elif node.op == "bwd_a2a_ffn":
            calls += tpc.route_ring * node.fn.vjp_matmul_calls
        elif node.op in ("gemm_col", "gemm_row", "bwd_ag_gemm"):
            calls += 1      # bwd_ag_gemm: one GEMM over the gathered grad
        elif node.op == "custom" and node.fn in (df._dw, df._gemm_t):
            calls += 1      # a weight gradient, or a dx through wᵀ
        elif node.op in ("custom", "expert_ar"):
            # the experts of the replicated layout's MoE, or their VJP
            calls += getattr(node.fn, "matmul_calls", 0)
        elif node.op in ("ag_gemm", "ag_gemm_multi"):
            calls += ag(k)
        elif node.op in ("gemm_rs", "fused_rs_ln"):
            calls += rs()
        elif node.op in ("fused_rs_ln_ag", "fused_rs_ln_ag_multi"):
            calls += rs() + ag(k - 2)
        elif node.op == "overlap_asym":
            if tpc.is_2d:
                calls += rs() + ag(k - 1)
            else:
                calls += (1 + k - 1) if tpc.mode == "barrier" or n == 1 \
                    else n + n * (k - 1)
        elif node.op == "gemm_ar":
            if tpc.mode == "barrier" or seq % n:
                calls += 1
            else:
                calls += rs()
    return calls


def step_launches(rec: StepRecord, batch: int, seq: int, d_model: int,
                  itemsize: int) -> dict:
    """The kernel calls one rank makes in a training step's forward and
    graph-built backward over a (``batch``, ``seq``) batch of ``itemsize``
    activations, derived from what its forward ran (``rec``): matmul and
    flash by :func:`matmul_calls` / :func:`flash_calls` of each period's
    optimized forward and training graphs; a replicated mixer one flash a
    forward where it attends (MLA, attention) and an MLA mixer two
    matmul_rmsnorm calls (their backward is torch math:
    ``ops._FlashAttention``, ``ops._MatmulRMSNorm``); an SSM or RG-LRU
    mixer none; under the ``auto`` mode an attention mixer one flash each
    time it ran, its remat recompute included (the projections are
    DTensor's own products, no matmul call). Also the overlap_asym nodes
    the graphs execute, and those of the first period's training graph
    that pair a backward collective with a forward one."""
    n = rec.replicated_mixers
    out = dict(matmul=0,
               flash=sum(m.get(k, 0) for m in (n, rec.auto_mixers)
                         for k in ("attn", "swa", "mla")),
               matmul_rmsnorm=2 * n.get("mla", 0), overlap_asym=0,
               cross_direction_pairs=[])
    for i, period in enumerate(rec.periods):
        _, bwd, _ = period.training()
        for graph in (period.graph, bwd):
            out["matmul"] += matmul_calls(graph, period.tpc,
                                          batch // period.mb, seq, d_model,
                                          itemsize)
            out["flash"] += flash_calls(graph)
            out["overlap_asym"] += sum(nd.op == "overlap_asym"
                                       for nd in graph.nodes)
        if i == 0:
            out["cross_direction_pairs"] = cross_direction_pairs(
                period.merged, bwd)
    return out


def serve_launches(rec: StepRecord) -> dict:
    """The kernel calls and all-reduce nodes one rank's serve periods
    recorded in ``rec`` executed: matmul by :func:`matmul_calls` of each
    optimized serve graph at its step's (batch, S), flash by
    :func:`flash_calls` (one a layer a step), and the nodes that all-reduce
    as they stand (``allreduce`` and ``expert_ar``: one an MoE layer a step
    where the experts split)."""
    out = dict(matmul=0, flash=0, allreduce=0)
    for tpc, graph, (B, S, d), itemsize in rec.serve:
        out["matmul"] += matmul_calls(graph, tpc, B, S, d, itemsize)
        out["flash"] += flash_calls(graph)
        out["allreduce"] += sum(n.op in ("allreduce", "expert_ar")
                                for n in graph.nodes)
    return out


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
