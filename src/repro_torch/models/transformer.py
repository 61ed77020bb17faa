"""Decoder-only LM assembled from an ArchConfig: the training forward and
loss, prefill/decode over dense caches, and the paged serving path, of
``repro/models/transformer.py``. The FFN is a gated MLP or an MoE
(:mod:`repro_torch.models.ffn`), whose load-balancing aux loss enters
``LM.loss`` with weight ``AUX_LOSS_WEIGHT``.

JAX scans the stack over pattern periods with parameters stacked per
period; here the blocks are an ``nn.ModuleList`` in layer order and the
stack is a Python loop over periods (``repro_torch.bridge`` maps the stacked
JAX layout onto it). ``Block`` and ``MLP`` construction take the place of
``init_block`` / ``init_mlp``.

On a TP ring (``LM(..., group=...)`` with more than one rank and an
explicit backend in ``rt.tp.mode``) each rank holds its shards of the TP
weights, the embedded activation is cut to this rank's sequence shard, every
period runs as one dataflow graph (:func:`repro_torch.core.tp.sp_period`)
and stays sequence-sharded between periods, and the loss's (sum, count) is
all-reduced over the ring; an MoE period's aux loss is the mean over the
ring of each rank's, the aux of its own shard. A block that is not
whole-block TP-applicable (MLA, SSM, RG-LRU, attention whose query heads
do not split over the ring; an MoE whose experts do not split) runs
sub-layer by sub-layer (:func:`block_routes`), each mixer that is not
TP-applicable whole on every rank and run replicated. Where the
sequence does not split over the ring (S % tp != 0) the activation is whole
on every rank and blocks run in the replicated-activation graphs, an MoE's
routed over the whole batch alike on every rank, each rank's experts
summed by one all-reduce (its aux every rank's own, the whole batch's); with
``sequence_parallel=False`` it is whole between periods, each period taking
its rows and gathering its output (:data:`LAYOUTS`). Paged serving
(``serve_step``) on a ring keeps the activation whole on every rank and
runs each period as one serve graph
(:func:`repro_torch.core.tp.sp_serve_period`) against the rank's KV pools,
an MoE's experts split over the ring (or replicated) and their partial
outputs all-reduced; the embedding and head are whole on every rank, so
every rank computes the same logits. On one device there is no TP context
and every block takes the per-block path, as in JAX.

Under the ``auto`` TP mode (``rt.tp.mode`` a backend with ``explicit =
False``, the default; JAX's compiler-scheduled path) a group runs no
period graph: the stack's input becomes a DTensor on the TP group's
device mesh, sequence-sharded or whole by the layout, and each block runs
its one-device code on DTensors of this rank's parameter shards
(:func:`auto_block_forward`), DTensor's sharding propagation choosing the
collectives as GSPMD does for JAX. Dense attention blocks in training
only: every other block kind, the VLM and every serving entry point raise
under it on a group (:func:`auto_unported`, ROADMAP A5 (b)).

On a mesh (``LM(..., group=mesh)``, a :class:`repro_torch.sharding.Mesh`)
the TP group is the mesh's: a flat ring, or on a 2D (``tp_in`` x
``tp_out``) mesh the composite group, whose rank is the composite index
that cuts the sequence and the shards, and whose MoE experts are grouped
(E/tp_out whole experts a rank). A ``data`` axis holds replicas: each takes
its rows of the global batch, the loss is the mean over the global batch
(the masked CE sum and the token count all-reduced over the TP group and
``data``; an MoE's aux loss the mean over both), and
:meth:`LM.sync_grads` sums every grad over ``data``. Where an MoE's
replicas each route their rows in one piece (the replicated layout) the
global batch's routing groups must be each replica's own, or the step
raises (:func:`repro_torch.models.ffn.check_replica_routing`). Serving
with a data axis is not ported (JAX's period-graph serve path is dp 1
too).

Training: ``forward`` and ``loss`` are differentiable once the parameters
require grad (``repro_torch.train.step.init_state`` sets that; the model is
built frozen, for serving). On a ring each period's backward is graph-built
(``sp_period``); the ring's partial grads of the replicated embedding, head
and final norm are summed by :meth:`LM.sync_grads`, once, after backward.
``Runtime.remat`` checkpoints each period and the remainder tail on one
device and under the ``auto`` mode (``torch.utils.checkpoint``, JAX's
``jax.checkpoint``); a period graph on a ring already saves only (x, weights) for its graph-built backward, which
re-executes the forward, so there it adds nothing and is not applied (JAX's
``jax.checkpoint`` around its ``custom_vjp`` runs that forward a third
time: the same values). Serving over dense caches (``prefill`` /
``decode_step``) runs on one device only (ROADMAP A11 (b), A12); MLA, SSM
and RG-LRU blocks have no paged path (their caches are a latent or a
recurrent state, not K/V) and serve through the dense engine.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tp as tp_mod
from repro_torch.core.backends import get_backend
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Norm, apply_norm, embed_init_, softcap
from repro_torch.optim.optimizers import Leaf
from repro_torch.runtime import Runtime, resolve_device
from repro_torch.sharding import (CompositeGroup, Mesh, TPGroup, as_mesh,
                                  dp_size, tp_axes, tp_size)

# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _has_ffn(cfg: ArchConfig) -> bool:
    return cfg.d_ff > 0 or cfg.moe is not None


class Block(nn.Module):
    """Pre-norm residual block: norm1 → mixer → (+x) → norm2 → ffn → (+x)
    (no FFN where d_ff is 0 and there is no MoE); ``kind`` is "attn",
    "swa" (sliding window ``cfg.window``), "mla", "ssm" (Mamba-2 SSD) or
    "rglru" (RG-LRU). On a TP ring of ``tp`` an attention mixer whose
    query heads split over the ring holds this rank's shards; every other
    mixer (MLA, SSM, RG-LRU, attention whose heads do not split) is whole
    on every rank and runs replicated (ROADMAP C, departure 7)."""

    def __init__(self, kind: str, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, tp: int = 1,
                 route_ring: Optional[int] = None):
        super().__init__()
        self.kind = kind
        self.norm1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        if kind in ("attn", "swa"):
            self.mixer = attn.Attention(
                cfg, dtype, device,
                tp if tp_mod.tp_applicable(cfg, kind, tp) else 1)
        elif kind == "mla":
            self.mixer = attn.MLA(cfg, dtype, device)
        elif kind == "ssm":
            self.mixer = ssm_mod.SSM(cfg, dtype, device)
        elif kind == "rglru":
            self.mixer = rglru_mod.RGLRU(cfg, dtype, device)
        else:
            raise NotImplementedError(f"{kind!r} blocks are not ported yet")
        self.norm2 = self.ffn = None
        if _has_ffn(cfg):
            self.norm2 = Norm(cfg.norm, cfg.d_model, dtype, device)
            self.ffn = ffn_mod.init_ffn(cfg, dtype, device, tp, route_ring)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mixer.reset_parameters(generator)
        if self.ffn is not None:
            self.ffn.reset_parameters(generator)


class AutoTP(NamedTuple):
    """The ``auto`` TP mode on ``group`` (JAX's ``explicit = False``
    backends): no period graph; each block runs its one-device code on
    DTensors over the group's device mesh, its parameters this rank's
    shards by :func:`repro_torch.core.tp.param_placement`
    (:func:`auto_block_forward`)."""

    group: TPGroup


def _tp_context(rt: Runtime, group: Optional[TPGroup]
                ) -> Union[None, tp_mod.TPContext, AutoTP]:
    """The TP execution context for ``group``, through the one
    ``TPConfig → TPContext.from_config`` path; None on one device; an
    :class:`AutoTP` where ``rt.tp.mode`` leaves scheduling to the framework
    (``auto``)."""
    if group is None or group.size <= 1:
        return None
    if not get_backend(rt.tp.mode).explicit:
        return AutoTP(group)
    return tp_mod.TPContext.from_config(rt.tp, group)


def auto_unported(what: str) -> NotImplementedError:
    """The error of a path that the ``auto`` TP mode does not run on a
    group (ROADMAP A5 (b)), rather than computing it unsharded."""
    return NotImplementedError(
        f"{what} under tp mode 'auto' (DTensor) on a TP group is not ported "
        "yet (ROADMAP A5 (b)): use 'barrier' or 'cais'")


# the activation's layout on a TP ring (LM.forward picks it):
#   "sharded"    (B, S/tp, d) between periods, every period sequence-sharded
#   "gathered"   sequence_parallel=False: (B, S, d) whole on every rank
#                between periods; each period takes its rows on entry and
#                all-gathers its output (JAX's ``_sp_axis`` None, the same
#                values)
#   "replicated" ragged S % tp != 0 (or S = 1): (B, S, d) whole on every
#                rank everywhere, dense blocks in the replicated-activation
#                graphs (``seq_sharded=False``)
LAYOUTS = ("sharded", "gathered", "replicated")


def activation_layout(rt: Runtime, seq: int, tp: int) -> str:
    """The layout of a (B, ``seq``, d) activation on a TP ring of ``tp``."""
    if seq % tp:
        return "replicated"
    return "sharded" if rt.tp.sequence_parallel else "gathered"


def _whole_block_applicable(cfg: ArchConfig, kind: str, tp: int,
                            route_ring: Optional[int] = None) -> bool:
    """Can this block run as ONE dataflow graph (attention AND FFN side
    both explicit-TP-applicable)?"""
    return (kind in ("attn", "swa") and tp_mod.tp_applicable(cfg, kind, tp)
            and _has_ffn(cfg)
            and (tp_mod.tp_applicable(cfg, "moe", tp, route_ring)
                 or tp_mod.tp_applicable(cfg, "ffn", tp)))


def block_routes(kind: str, cfg: ArchConfig, tpc: tp_mod.TPContext,
                 seq_sharded: bool = True) -> Tuple[str, str]:
    """How :func:`block_forward` runs a block of ``kind`` on a TP ring, JAX's
    ``block_forward`` branch for branch: ("block", "block") where the whole
    block is one dataflow graph (``sp_block``; ``seq_sharded=False`` the
    replicated-activation graph of a dense block); otherwise (mixer, FFN)
    sub-layer by sub-layer, the mixer "sp_attention" or "replicated" (every
    mixer that is not TP-applicable: MLA, SSM, RG-LRU, attention whose
    query heads do not split over the ring; JAX runs them under GSPMD), the
    FFN "sp_moe_ffn", "sp_ffn", "replicated" (an MoE whose experts do not
    split over the route ring) or "none". An MoE block at a sequence that
    does not split (``seq_sharded=False``), which JAX runs replicated under
    GSPMD, takes the MoE graph of the replicated layout, its experts split
    or replicated: the whole block where its attention splits, else its FFN
    as "sp_moe_ffn"."""
    moe_replicated = not seq_sharded and cfg.moe is not None
    if _whole_block_applicable(cfg, kind, tpc.tp, tpc.route_ring) or (
            moe_replicated and kind in ("attn", "swa")
            and tp_mod.tp_applicable(cfg, kind, tpc.tp)):
        return "block", "block"
    if kind not in ("attn", "swa", "mla", "ssm", "rglru"):
        raise NotImplementedError(f"{kind!r} blocks are not ported yet")
    mixer = ("sp_attention" if kind in ("attn", "swa")
             and tp_mod.tp_applicable(cfg, kind, tpc.tp) else "replicated")
    if not _has_ffn(cfg):
        ffn = "none"
    elif moe_replicated or tp_mod.tp_applicable(cfg, "moe", tpc.tp,
                                                tpc.route_ring):
        ffn = "sp_moe_ffn"
    elif tp_mod.tp_applicable(cfg, "ffn", tpc.tp):
        ffn = "sp_ffn"
    elif cfg.moe is not None:
        ffn = "replicated"
    else:
        raise NotImplementedError(
            f"{cfg.name}: d_ff {cfg.d_ff} does not split over tp={tpc.tp}")
    return mixer, ffn


def replicated_block_params(kind: str, cfg: ArchConfig,
                            tpc: tp_mod.TPContext) -> Tuple[str, ...]:
    """The parameter name prefixes of a block of ``kind`` (relative to the
    block) that run outside every period graph on a sequence-sharded ring
    and are whole on every rank: their grads are partial sums over the
    ranks, which :meth:`LM.sync_grads` sums once (a replicated mixer and
    its norm1; a replicated FFN and its norm2)."""
    mixer, ffn = block_routes(kind, cfg, tpc)
    out = ()
    if mixer == "replicated":
        out += ("norm1.", "mixer.")
    if ffn == "replicated":
        out += ("norm2.", "ffn.")
    return out


# a block's parameters by module, as the one-device code reads them
_BLOCK_LEAVES = {"norm1": ("scale",), "mixer": ("wq", "wk", "wv", "wo"),
                 "norm2": ("scale",), "ffn": ("w_up", "w_gate", "w_down")}


def _as_dtensors(kind: str, params: Block, cfg: ArchConfig, group: TPGroup,
                 mesh) -> Dict[str, SimpleNamespace]:
    """This rank's shards of a block's parameters as DTensors on ``mesh``:
    ``Shard(dim)`` where :func:`repro_torch.core.tp.param_placement` splits
    one over ``group``, ``Replicate()`` elsewhere (the layout
    ``bridge.shard_for_group``, the optimizers and the checkpoint keep), by
    module ({"mixer": namespace(wq=..., ...), ...})."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    out = {}
    for mod, leaves in _BLOCK_LEAVES.items():
        sub = getattr(params, mod)
        if sub is None:
            continue
        views = {}
        for leaf in leaves:
            p = getattr(sub, leaf, None)
            if p is not None:
                place = tp_mod.param_placement(f"blocks.0.{mod}.{leaf}", cfg,
                                               group, kind)
                p = DTensor.from_local(
                    p, mesh, [Replicate() if place is None
                              else Shard(place[0])], run_check=False)
            views[leaf] = p
        out[mod] = SimpleNamespace(**views)
    return out


def auto_block_forward(kind: str, params: Block, x, cfg: ArchConfig,
                       group: TPGroup, seq_sharded: bool = True,
                       prefix_len: int = 0):
    """Pre-norm residual attention block under the ``auto`` TP mode: the
    one-device code (``apply_norm``, :func:`_mixer_forward`,
    ``mlp_forward``) on DTensors, x (B, S, d) on ``x.device_mesh``
    sequence-sharded (``Shard(1)``) where ``seq_sharded``, else whole. Each
    sub-layer gathers its normed input whole once (the projections share
    it), and its output, a partial sum over the ranks after the row-split
    projection, is constrained as JAX constrains a block's
    (:func:`repro_torch.sharding.shard`): one all-gather in and one
    reduce-scatter out a sub-layer, or one all-reduce out where x is
    whole."""
    from torch.distributed.tensor import Replicate

    from repro_torch.sharding import shard

    mesh = x.device_mesh
    p = _as_dtensors(kind, params, cfg, group, mesh)
    tp_mod.record_auto_mixer(kind)

    def normed(x, norm):
        h = apply_norm(cfg.norm, x, norm.scale)
        return h.redistribute(mesh, [Replicate()])

    out = _mixer_forward(kind, p["mixer"], normed(x, p["norm1"]), cfg,
                         prefix_len)
    x = x + shard(out, mesh, seq_sharded)
    if _has_ffn(cfg):
        out = ffn_mod.mlp_forward(p["ffn"], normed(x, p["norm2"]), cfg.act)
        x = x + shard(out, mesh, seq_sharded)
    return x


def block_forward(kind: str, params: Block, x: torch.Tensor,
                  cfg: ArchConfig,
                  tpc: Union[None, tp_mod.TPContext, AutoTP] = None,
                  prefix_len: int = 0, seq_sharded: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm residual block. Returns (x, aux_loss). Under the ``auto``
    TP mode (``tpc`` an :class:`AutoTP`) :func:`auto_block_forward`. On a
    TP ring by :func:`block_routes`: the whole block as one dataflow graph
    (``sp_block``) where attention and FFN both are TP-applicable, in the
    replicated-activation graph where the sequence does not split
    (``seq_sharded=False``: x (B, S, d) whole on every rank; an MoE's
    experts split or replicated); otherwise sub-layer by sub-layer, each
    TP-applicable one as its one-sub-layer graph (``sp_attention``,
    ``sp_ffn``, ``sp_moe_ffn``) and the others
    replicated (:func:`repro_torch.core.tp.sp_replicated_mixer`,
    ``sp_replicated_ffn``)."""
    if tpc is None:
        x = x + _mixer_forward(kind, params.mixer, params.norm1(x), cfg,
                               prefix_len)
        return _ffn_block(params, x, cfg)
    if isinstance(tpc, AutoTP):
        return (auto_block_forward(kind, params, x, cfg, tpc.group,
                                   seq_sharded, prefix_len),
                torch.zeros((), dtype=torch.float32, device=x.device))
    mixer, ffn = block_routes(kind, cfg, tpc, seq_sharded)
    if mixer == "block":
        return tp_mod.sp_block(tpc, x, params, cfg, kind,
                               prefix_len=prefix_len, norm_kind=cfg.norm,
                               seq_sharded=seq_sharded)
    dt = x.dtype
    if mixer == "sp_attention":
        m = params.mixer
        x = x + tp_mod.sp_attention(
            tpc, x, params.norm1.scale.to(dt), m.wq.to(dt), m.wk.to(dt),
            m.wv.to(dt), m.wo.to(dt), cfg, window=_window(kind, cfg),
            prefix_len=prefix_len, norm_kind=cfg.norm,
            seq_sharded=seq_sharded)
    else:
        x = x + tp_mod.sp_replicated_mixer(
            tpc, x, params.norm1.scale,
            lambda h: _mixer_forward(kind, params.mixer, h, cfg, prefix_len),
            cfg.norm, seq_sharded=seq_sharded, kind=kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "sp_moe_ffn":
        out, aux = tp_mod.sp_moe_ffn(tpc, x, params.norm2.scale.to(dt),
                                     params.ffn, cfg, norm_kind=cfg.norm,
                                     seq_sharded=seq_sharded)
        x = x + out
    elif ffn == "sp_ffn":
        f = params.ffn
        x = x + tp_mod.sp_ffn(
            tpc, x, params.norm2.scale.to(dt), f.w_up.to(dt),
            f.w_gate.to(dt), f.w_down.to(dt), cfg.act, norm_kind=cfg.norm,
            seq_sharded=seq_sharded)
    elif ffn == "replicated":
        out, aux = tp_mod.sp_replicated_ffn(
            tpc, x, params.norm2.scale,
            lambda h: ffn_mod.ffn_forward(params.ffn, h, cfg), cfg.norm)
        x = x + out
    return x, aux


def _mixer_forward(kind: str, mixer, h: torch.Tensor, cfg: ArchConfig,
                   prefix_len: int = 0) -> torch.Tensor:
    if kind == "mla":
        return attn.mla_forward(mixer, h, cfg)
    if kind == "ssm":
        return ssm_mod.ssm_forward(mixer, h, cfg)
    if kind == "rglru":
        return rglru_mod.rglru_forward(mixer, h, cfg)
    return attn.attention_forward(mixer, h, cfg, window=_window(kind, cfg),
                                  prefix_len=prefix_len)


def _window(kind: str, cfg: ArchConfig) -> int:
    return cfg.window if kind == "swa" else 0


def _ffn_block(params: Block, x: torch.Tensor, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + FFN(norm2(x)), the FFN's aux loss)."""
    if not _has_ffn(cfg):
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    out, aux = ffn_mod.ffn_forward(params.ffn, params.norm2(x), cfg)
    return x + out, aux


def _ffn_residual(params: Block, x: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """x + FFN(norm2(x)) on a serving path, which drops the aux loss (an
    MoE routes every token of the step, padding included, as JAX's
    ``serve_step`` does)."""
    return _ffn_block(params, x, cfg)[0]


def _blocks_forward(kinds: Sequence[str], blocks: Sequence[Block],
                    x: torch.Tensor, cfg: ArchConfig,
                    tpc: Optional[tp_mod.TPContext] = None,
                    prefix_len: int = 0, layout: str = "sharded"):
    """Run consecutive blocks (JAX's ``_blocks_forward``): on a TP ring with
    a sequence that splits, when every block is whole-block TP-applicable,
    as ONE period-level dataflow graph (``sp_period``); otherwise block by
    block (:func:`block_forward`). Under ``layout="gathered"`` the blocks
    take this rank's rows of the whole x on entry and all-gather their
    output (:func:`repro_torch.core.tp.seq_rows`, ``seq_gather``); under
    the ``auto`` mode x stays whole there (JAX's ``_sp_axis`` None)."""
    if isinstance(tpc, AutoTP):
        layout = "replicated" if layout == "gathered" else layout
    elif tpc is not None and layout == "gathered":
        x, aux = _blocks_forward(kinds, blocks, tp_mod.seq_rows(x, tpc.group),
                                 cfg, tpc, prefix_len, "sharded")
        return tp_mod.seq_gather(x, tpc.group, partial=False), aux
    if (isinstance(tpc, tp_mod.TPContext) and len(blocks) > 0
            and layout == "sharded"
            and all(_whole_block_applicable(cfg, k, tpc.tp, tpc.route_ring)
                    for k in kinds)):
        return tp_mod.sp_period(tpc, x, list(blocks), cfg, kinds,
                                prefix_len=prefix_len, norm_kind=cfg.norm)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, blk in zip(kinds, blocks):
        x, a = block_forward(kind, blk, x, cfg, tpc, prefix_len,
                             seq_sharded=layout != "replicated")
        aux = aux + a
    return x, aux


def stack_forward(blocks: nn.ModuleList, x: torch.Tensor, cfg: ArchConfig,
                  tpc: Optional[tp_mod.TPContext] = None,
                  prefix_len: int = 0, remat: bool = False,
                  layout: str = "sharded"):
    """The whole stack, one ``layer_pattern`` period at a time (JAX's
    ``lax.scan`` over stacked periods), then the remainder layers, the
    activation in ``layout`` on a TP ring (:data:`LAYOUTS`). With
    ``remat`` (where autograd records) each period and the remainder tail
    keep only their input for the backward and run their forward again
    there (``torch.utils.checkpoint``, non-reentrant)."""
    pattern = tuple(cfg.layer_pattern)
    P = len(pattern)
    n_full = cfg.num_layers // P
    remat = remat and torch.is_grad_enabled()

    def run(kinds, blks, x):
        if remat:
            return checkpoint(_blocks_forward, kinds, blks, x, cfg, tpc,
                              prefix_len, layout, use_reentrant=False)
        return _blocks_forward(kinds, blks, x, cfg, tpc, prefix_len, layout)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in range(n_full):
        x, a = run(pattern, blocks[p * P:(p + 1) * P], x)
        aux = aux + a
    rem = cfg.layer_kinds()[n_full * P:]
    if rem:
        x, a = run(rem, blocks[n_full * P:], x)
        aux = aux + a
    return x, aux


# ----- prefill / decode over dense caches -----------------------------------


def block_prefill(params: Block, x: torch.Tensor, cfg: ArchConfig,
                  s_max: Optional[int] = None
                  ) -> Tuple[torch.Tensor, attn.Cache]:
    """Pre-norm residual block over the prompt; returns (x, the layer's
    decode cache: K/V, a latent, or a recurrent {"h", "conv"} state)."""
    h = params.norm1(x)
    if params.kind == "mla":
        mixed, cache = attn.mla_prefill(params.mixer, h, cfg, s_max=s_max)
    elif params.kind in ("ssm", "rglru"):
        fwd = ssm_mod.ssm_forward if params.kind == "ssm" \
            else rglru_mod.rglru_forward
        mixed, (state, conv) = fwd(params.mixer, h, cfg, return_state=True)
        cache = {"h": state, "conv": conv}
    else:
        mixed, cache = attn.attention_prefill(
            params.mixer, h, cfg, window=_window(params.kind, cfg),
            s_max=s_max)
    return _ffn_residual(params, x + mixed, cfg), cache


def block_decode(params: Block, x: torch.Tensor, cache: attn.Cache,
                 idx: torch.Tensor, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, attn.Cache]:
    """One decode step of one block; ``cache`` is updated in place (a
    recurrent state needs no position: ``idx`` is the attention kinds')."""
    h = params.norm1(x)
    if params.kind == "mla":
        mixed, cache = attn.mla_decode(params.mixer, h, cache, idx, cfg)
    elif params.kind == "ssm":
        mixed, cache = ssm_mod.ssm_decode(params.mixer, h, cache, cfg)
    elif params.kind == "rglru":
        mixed, cache = rglru_mod.rglru_decode(params.mixer, h, cache, cfg)
    else:
        mixed, cache = attn.attention_decode(
            params.mixer, h, cache, idx, cfg,
            window=_window(params.kind, cfg))
    return _ffn_residual(params, x + mixed, cfg), cache


def init_block_cache(kind: str, cfg: ArchConfig, batch: int, s_max: int,
                     dtype: torch.dtype, device: torch.device) -> attn.Cache:
    if kind == "attn":
        return attn.init_dense_cache(cfg, batch, s_max, dtype, device)
    if kind == "swa":
        return attn.init_swa_cache(cfg, batch, cfg.window, dtype, device)
    if kind == "mla":
        return attn.init_mla_cache(cfg, batch, s_max, dtype, device)
    if kind == "ssm":
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return rglru_mod.init_rglru_cache(cfg, batch, dtype, device)
    raise NotImplementedError(f"{kind!r} caches are not ported yet")


def stack_prefill(blocks: nn.ModuleList, x: torch.Tensor, cfg: ArchConfig,
                  s_max: Optional[int] = None
                  ) -> Tuple[torch.Tensor, List[attn.Cache]]:
    """The whole stack over the prompt, layer by layer; returns (x, one
    cache per layer in layer order)."""
    caches = []
    for blk in blocks:
        x, c = block_prefill(blk, x, cfg, s_max)
        caches.append(c)
    return x, caches


def stack_decode(blocks: nn.ModuleList, x: torch.Tensor,
                 caches: List[attn.Cache], idx: torch.Tensor, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, List[attn.Cache]]:
    """One decode step through the whole stack; ``caches[i]`` belongs to
    layer ``i`` (updated in place)."""
    for blk, c in zip(blocks, caches):
        x, _ = block_decode(blk, x, c, idx, cfg)
    return x, caches


def init_stack_cache(cfg: ArchConfig, batch: int, s_max: int,
                     dtype: torch.dtype, device: torch.device
                     ) -> List[attn.Cache]:
    """Empty decode caches for the whole stack, one per layer in layer
    order."""
    return [init_block_cache(kind, cfg, batch, s_max, dtype, device)
            for kind in cfg.layer_kinds()]


# ----- paged serving ---------------------------------------------------------


def block_step(params: Block, x: torch.Tensor, pool: attn.Pool,
               view: attn.KVView, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, attn.Pool]:
    """One block of a mixed prefill/decode serving step against its paged
    KV pool (updated in place), on one device. Returns (x, pool). Attention
    blocks only: an MLA layer caches a latent, which the pools do not hold
    (JAX's ``paged_supported`` gate)."""
    if params.kind not in ("attn", "swa"):
        raise NotImplementedError(f"{params.kind!r} blocks have no paged "
                                  "path; serve them through the dense engine")
    h = params.norm1(x)
    mixed, pool = attn.attention_paged(params.mixer, h, pool, view, cfg,
                                       window=_window(params.kind, cfg))
    return _ffn_residual(params, x + mixed, cfg), pool


def _serve_applicable(cfg: ArchConfig, kind: str, tp: int) -> bool:
    """Can a block of ``kind`` run in a serve graph on a ring of ``tp``:
    attention whose query heads split over the ring, and a dense FFN that
    splits or an MoE (its experts split by whole expert, or replicate)?"""
    return (kind in ("attn", "swa") and tp_mod.tp_applicable(cfg, kind, tp)
            and (cfg.moe is not None or tp_mod.tp_applicable(cfg, "ffn", tp)))


def _blocks_step(kinds: Sequence[str], blocks: Sequence[Block],
                 x: torch.Tensor, pools: Sequence[attn.Pool],
                 view: attn.KVView, cfg: ArchConfig,
                 tpc: Optional[tp_mod.TPContext] = None):
    """Consecutive blocks of a serving step. On a TP ring, when every
    block's attention splits over the ring and its FFN is a dense FFN that
    splits or an MoE, the period runs as ONE serve graph
    (``sp_serve_period``: replicated activation, ``gemm_ar`` reductions,
    the pools through each core node; an MoE routes the whole step on every
    rank, runs the rank's experts and all-reduces their partial sum, JAX's
    per-block GSPMD MoE as explicit ops); otherwise the rank raises (JAX
    falls back per sub-layer under GSPMD; the port has no such fallback in
    serving, ROADMAP A11 (b)). On one device, block by block."""
    if tpc is None:
        for blk, pool in zip(blocks, pools):
            x, _ = block_step(blk, x, pool, view, cfg)
        return x, list(pools)
    if not all(_serve_applicable(cfg, k, tpc.tp) for k in kinds):
        raise NotImplementedError(
            f"{cfg.name}: serving blocks {tuple(kinds)} whose attention or "
            f"FFN does not split over the ring at tp={tpc.tp} (JAX falls "
            "back per sub-layer under GSPMD) is not ported yet (ROADMAP "
            "A11 (b))")
    return tp_mod.sp_serve_period(tpc, x, list(blocks), cfg, kinds,
                                  list(pools), view, norm_kind=cfg.norm)


def stack_step(blocks: nn.ModuleList, x: torch.Tensor,
               pools: List[attn.Pool], view: attn.KVView, cfg: ArchConfig,
               tpc: Optional[tp_mod.TPContext] = None
               ) -> Tuple[torch.Tensor, List[attn.Pool]]:
    """One mixed prefill/decode serving step through the whole stack, one
    ``layer_pattern`` period at a time, then the remainder layers (as
    :func:`stack_forward`); ``pools[i]`` belongs to layer ``i`` (updated in
    place)."""
    P = len(cfg.layer_pattern)
    n_full = cfg.num_layers // P
    kinds = cfg.layer_kinds()
    spans = [(p * P, (p + 1) * P) for p in range(n_full)]
    if n_full * P < cfg.num_layers:
        spans.append((n_full * P, cfg.num_layers))
    for lo, hi in spans:
        x, _ = _blocks_step(kinds[lo:hi], blocks[lo:hi], x, pools[lo:hi],
                            view, cfg, tpc)
    return x, pools


def init_stack_pools(cfg: ArchConfig, num_blocks: int, block_size: int,
                     dtype: torch.dtype, device: torch.device, tp: int = 1
                     ) -> List[attn.Pool]:
    """Paged KV pools for the whole stack, one per layer in layer order,
    with a rank's kv heads on a ring of ``tp``
    (:func:`repro_torch.models.attention.init_kv_pool`)."""
    return [attn.init_kv_pool(cfg, num_blocks, block_size, dtype, device, tp)
            for _ in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# LM head / loss
# ---------------------------------------------------------------------------


def chunked_ce_loss(x: torch.Tensor, embed_or_head: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor,
                    cfg: ArchConfig, rt: Runtime, tied: bool,
                    group: Optional[TPGroup] = None,
                    data: Optional[TPGroup] = None) -> torch.Tensor:
    """Mean cross-entropy with logits computed per sequence chunk (bounds
    the (B, chunk, V) logits). x: (B, S, d) — on a TP ring in the
    ``"sharded"`` layout this rank's sequence shard, with the matching
    slices of ``labels`` and ``mask``; the (sum, count) pair is then
    all-reduced over ``group`` and over the ``data`` axis, so the loss is
    the mean over the global batch (a mean of replica means would differ
    wherever the masks do). Where the activation is whole on every rank the
    caller passes no ``group``: every rank's pair is already the whole
    sequence's. The chunks are ``rt.loss_chunk`` long, the last one shorter
    where that does not divide S: JAX's ``lax.scan`` needs equal chunks and
    halves the chunk until it divides S (one token a chunk at a prime S);
    this slice loop needs no divisor. Where the chunk divides S the chunks
    are JAX's; elsewhere the per-token sum is the same, grouped
    otherwise."""
    B, S, _ = x.shape
    chunk = min(rt.loss_chunk, S)
    w = embed_or_head.T if tied else embed_or_head    # (d, V)
    w = w.to(x.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        logits = softcap((x[:, s0:s0 + chunk] @ w).float(),
                         cfg.logits_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        yc = labels[:, s0:s0 + chunk].long()
        gold = torch.gather(logits, -1, yc[..., None])[..., 0]
        mc = mask[:, s0:s0 + chunk].float()
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
    groups = tuple(g for g in (group, data) if g is not None and g.size > 1)
    if groups:
        tot, cnt = _RingSum.apply(torch.stack([tot, cnt]), groups)
    return tot / torch.clamp(cnt, min=1.0)


class _RingSum(torch.autograd.Function):
    """The loss's all-reduce of (sum, count) over each of ``groups`` (the
    TP ring, then the data axis), differentiable with an identity backward:
    every rank seeds the same cotangent of the same replicated loss, which
    is already each rank's cotangent of its own partial sum (an all-reduce
    there would make every grad tp times too large)."""

    @staticmethod
    def forward(ctx, x, groups):
        for g in groups:
            x = g.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


# ---------------------------------------------------------------------------
# LM — the top-level decoder-only model
# ---------------------------------------------------------------------------


AUX_LOSS_WEIGHT = 0.01


class LM(nn.Module):
    """Decoder-only language model (attention, MLA, SSM and RG-LRU archs).

    Parameters live on ``device`` (CUDA unless the caller names another) in
    ``rt.param_dtype``; activations run in ``rt.compute_dtype``. With
    ``seed`` set, the weights are drawn from a ``torch.Generator`` on that
    device; with ``seed=None`` they are left uninitialised, for a caller
    that loads a state dict (``repro_torch.bridge``). ``group`` is a TP
    ring or a :class:`repro_torch.sharding.Mesh`; with a TP group of more
    than one rank the model holds this rank's shards of the TP weights (the
    same weights as the one-device model from the same seed), and every
    replica of a data axis holds the same."""

    def __init__(self, cfg: ArchConfig, rt: Runtime = Runtime(), *,
                 device=None, seed: Optional[int] = 0,
                 group: Optional[Union[TPGroup, Mesh]] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.rt = cfg, rt
        self.mesh = as_mesh(group)
        tp = self.tp
        route_ring = (self.group.tp_out.size
                      if isinstance(self.group, CompositeGroup) else tp)
        dtype = rt.pdtype
        param = lambda *s: nn.Parameter(
            torch.empty(s, dtype=dtype, device=device), requires_grad=False)
        self.embed = param(cfg.vocab_size, cfg.d_model)
        self.blocks = nn.ModuleList(
            Block(kind, cfg, dtype, device, tp, route_ring)
            for kind in cfg.layer_kinds())
        self.final_norm = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.lm_head = None if cfg.tie_embeddings \
            else param(cfg.d_model, cfg.vocab_size)
        self._extra_params(param)
        if seed is None:
            return
        if tp == 1:
            self.reset_parameters(
                torch.Generator(device=device).manual_seed(seed))
            return
        # the same weights as the one-device model from this seed: draw them
        # whole, keep this rank's shards. Ranks that share one card (gloo on
        # CUDA) take turns, so the card holds one whole model at a time
        from repro_torch.bridge import shard_for_group

        world = self.mesh.world
        turns = world.backend == "gloo" and device.type == "cuda"
        for turn in range(world.size if turns else 1):
            if not turns or turn == world.rank:
                full = type(self)(cfg, rt, device=device, seed=seed)
                self.load_state_dict(shard_for_group(
                    full.state_dict(), cfg, self.group))
                del full
                if turns:
                    torch.cuda.empty_cache()
            if turns:
                world.all_reduce(torch.zeros(1))    # the turn's end

    def _extra_params(self, param) -> None:
        """Parameters a subclass adds beside the decoder's (``param(*shape)``
        makes one), before the weights are drawn."""

    @property
    def group(self) -> Optional[TPGroup]:
        """The TP group: the flat ring, or a 2D mesh's composite group."""
        return tp_axes(self.mesh)

    @property
    def data(self) -> Optional[TPGroup]:
        """The data-parallel axis (None without a mesh)."""
        return None if self.mesh is None else self.mesh.data

    @property
    def tp(self) -> int:
        """The TP degree this model's weights are sharded over."""
        return tp_size(self.mesh)

    @property
    def dp(self) -> int:
        return dp_size(self.mesh)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        embed_init_(self.embed, generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        if self.lm_head is not None:
            embed_init_(self.lm_head, generator)

    def _embed(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.embed[tokens.long()].to(dtype)

    def _head(self) -> Tuple[torch.Tensor, bool]:
        tied = self.cfg.tie_embeddings
        return (self.embed if tied else self.lm_head), tied

    # ----- training forward -----
    def forward(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hidden states after the final norm, and the aux loss. tokens:
        (B, S) int, the whole sequence on every rank; on a TP ring the
        result is this rank's sequence shard (B, S/tp, d) in the
        ``"sharded"`` layout, and (B, S, d) on every rank where the
        activation is whole (``sequence_parallel=False``, or S % tp != 0:
        :func:`activation_layout`)."""
        return self._stack(self._embed(tokens, self.rt.dtype))

    def _stack(self, x: torch.Tensor, prefix_len: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`forward` from the embedded (B, S, d) input, whole on every
        rank (its first ``prefix_len`` positions a prefix-LM prefix)."""
        tpc = _tp_context(self.rt, self.group)
        B, S = x.shape[:2]
        layout = activation_layout(self.rt, S, self.tp)
        if isinstance(tpc, AutoTP):
            x = self._auto_input(x[:, self._seq_shard(S)].contiguous(),
                                 prefix_len, layout)
        elif tpc is not None:
            x = x[:, self._seq_shard(S)].contiguous()
            if layout == "replicated":
                ffn_mod.check_replica_routing(self.cfg, B * S, self.dp)
        x, aux = stack_forward(self.blocks, x, self.cfg, tpc,
                               prefix_len=prefix_len,
                               remat=self.rt.remat and not isinstance(
                                   tpc, tp_mod.TPContext),
                               layout=layout)
        if isinstance(tpc, AutoTP):
            x = x.to_local()
        return self.final_norm(x), aux

    def _auto_input(self, x: torch.Tensor, prefix_len: int, layout: str):
        """The ``auto`` route's stack input: this rank's rows ``x`` (its
        sequence shard in the ``"sharded"`` layout, else every row) as a
        DTensor on the TP group's device mesh. Dense attention blocks only:
        every other block kind raises before any collective."""
        cfg = self.cfg
        other = [k for k in cfg.layer_kinds() if k not in ("attn", "swa")]
        if other:
            raise auto_unported(f"{cfg.name}: {other[0]!r} blocks")
        if cfg.moe is not None:
            raise auto_unported(f"{cfg.name}: an MoE FFN")
        if prefix_len or cfg.num_prefix_tokens:
            raise auto_unported(f"{cfg.name}: a prefix-LM (the VLM)")
        if cfg.d_ff % self.tp:
            raise auto_unported(f"{cfg.name}: d_ff {cfg.d_ff} over "
                                f"tp={self.tp}")
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = self.group.device_mesh(x.device.type)
        return DTensor.from_local(
            x, mesh, [Shard(1) if layout == "sharded" else Replicate()],
            run_check=False)

    def split_groups(self) -> Dict[str, TPGroup]:
        """{parameter: the group whose ranks split it} for the parameters
        this rank holds a shard of (the TP group, or tp_out for a 2D mesh's
        grouped experts); every rank of the TP group holds the rest
        whole."""
        from repro_torch.core.tp import param_placement

        out = {}
        for n, _ in self.named_parameters():
            place = param_placement(n, self.cfg, self.group)
            if place is not None:
                out[n] = place[1]
        return out

    def opt_leaves(self) -> Dict[str, Leaf]:
        """{parameter: its :class:`~repro_torch.optim.optimizers.Leaf`}: the
        ``repro`` leaf and stack index it belongs to
        (:func:`repro_torch.bridge.jax_leaf`) and the dimension this rank's
        shard of it splits (:func:`repro_torch.core.tp.param_placement`),
        for the optimizers whose update is defined per JAX leaf."""
        from repro_torch.bridge import jax_leaf
        from repro_torch.core.tp import param_placement

        out = {}
        for n, _ in self.named_parameters():
            place = param_placement(n, self.cfg, self.group)
            out[n] = Leaf(*jax_leaf(n, self.cfg),
                          None if place is None else place[0])
        return out

    def sync_grads(self, seq: int, data: bool = True) -> None:
        """Sum, once, over the whole TP group the grads that are partial
        sums over its ranks, by the layout of the step's batch (its
        sequence length ``seq``, :func:`activation_layout`): in the
        ``"sharded"`` layout those of the parameters outside the block
        graphs (embedding, head, final norm: each rank's are its sequence
        shard's part); in the ``"sharded"`` and ``"gathered"`` layouts those
        of the block parameters that run replicated outside every period
        graph (:func:`replicated_block_params`: a replicated mixer and its
        norm1, a replicated MoE and its norm2). Where the activation is whole on
        every rank, every rank computes the same loss from it, so the
        embedding's, head's and final norm's grads are complete, and in the
        ``"replicated"`` layout the replicated blocks' are too. The period
        graphs' own weights are summed in their backward, and under the
        ``auto`` mode every block parameter's in DTensor's (a whole
        parameter's partial grads all-reduced as ``DTensor.from_local``'s
        backward makes its grad whole). Then, unless
        ``data`` is False, every grad over the data axis: each replica's is
        its rows' part of the global batch's. A no-op on one device."""
        if self.tp > 1:
            layout = activation_layout(self.rt, seq, self.tp)
            tpc = _tp_context(self.rt, self.group)
            partial = () if isinstance(tpc, AutoTP) else tuple(
                f"blocks.{i}.{q}" for i, blk in enumerate(self.blocks)
                for q in replicated_block_params(blk.kind, self.cfg, tpc))
            for name, p in self.named_parameters():
                if p.grad is None:
                    continue
                if name.startswith("blocks."):
                    summed = layout != "replicated" and \
                        name.startswith(partial)
                else:
                    summed = layout == "sharded"
                if summed:
                    p.grad = self.group.all_reduce(p.grad)
        if data and self.dp > 1:
            for p in self.parameters():
                if p.grad is not None:
                    p.grad = self.data.all_reduce(p.grad)

    def _seq_shard(self, S: int) -> slice:
        """This rank's sequence rows in the ``"sharded"`` layout; every row
        where the activation is whole on every rank."""
        if activation_layout(self.rt, S, self.tp) != "sharded":
            return slice(None)
        s = S // self.tp
        return slice(self.group.rank * s, (self.group.rank + 1) * s)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy (+ the weighted aux loss) of
        ``batch`` ({"tokens", "labels"[, "mask"]}, each (B, S)): on a mesh
        with a data axis, this replica's rows of the global batch
        (:func:`repro_torch.data.pipeline.replica_rows`), and the loss the
        global batch's. The same value on every rank of the mesh."""
        x, aux = self.forward(batch["tokens"])
        return self._loss(x, aux, batch)

    def _loss(self, x: torch.Tensor, aux: torch.Tensor,
              batch: Dict[str, torch.Tensor], prefix_len: int = 0
              ) -> torch.Tensor:
        """The loss of :meth:`loss` from the stack's output ``x`` over
        ``prefix_len`` + S rows (this rank's shard of them in the
        ``"sharded"`` layout), the first ``prefix_len`` unlabelled: they are
        cut off where ``x`` is whole, and carry mask 0 in a shard (a rank
        whose rows are all prefix adds 0 to the sum and to the count)."""
        labels, mask = batch["labels"], batch.get("mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        group = None
        T = prefix_len + labels.shape[1]
        if self.tp > 1 and activation_layout(self.rt, T, self.tp) == \
                "sharded":
            if prefix_len:
                pad = lambda t: torch.cat([t.new_zeros(
                    (t.shape[0], prefix_len)), t], dim=1)
                labels, mask = pad(labels), pad(mask)
            sl = self._seq_shard(T)
            labels, mask, group = labels[:, sl], mask[:, sl], self.group
        else:
            x = x[:, prefix_len:]
        head, tied = self._head()
        ce = chunked_ce_loss(x, head, labels, mask, self.cfg, self.rt, tied,
                             group, self.data)
        if self.dp > 1 and self.cfg.moe is not None:
            aux = tp_mod.ring_mean(aux, self.data)
        return ce + AUX_LOSS_WEIGHT * aux

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.lm_head is None else self.lm_head
        return softcap((x @ head.to(x.dtype)).float(), self.cfg.logits_softcap)

    # ----- serving over dense caches -----
    @property
    def auto(self) -> bool:
        """Whether this model runs the ``auto`` TP mode on a group."""
        return self.tp > 1 and not get_backend(self.rt.tp.mode).explicit

    def _one_device(self, what: str) -> None:
        if self.auto:
            raise auto_unported(f"{what} over dense caches")
        if self.tp > 1 or self.dp > 1:
            raise NotImplementedError(f"{what} over a TP ring is not ported "
                                      "yet (ROADMAP A11 (b), A12)")

    def init_cache(self, batch: int, s_max: int) -> List[attn.Cache]:
        return init_stack_cache(self.cfg, batch, s_max, self.rt.dtype,
                                self.device)

    @torch.no_grad()
    def prefill(self, tokens=None, s_max: Optional[int] = None, *,
                embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[attn.Cache]]:
        """The prompt through the stack. ``tokens``: (B, S) int, or a batch
        dict with a "tokens" entry; or, instead, the input embeddings
        ``embeds`` (B, S, d) in the compute type (the VLM's image prefix and
        text, as JAX's VLM calls ``stack_prefill`` on them). Returns the
        last position's logits, (B, 1, V) f32, and the per-layer caches of
        ``s_max`` slots (default S)."""
        self._one_device("prefill")
        if isinstance(tokens, dict):
            tokens = tokens["tokens"]
        x = self._embed(tokens, self.rt.dtype) if embeds is None else embeds
        x, caches = stack_prefill(self.blocks, x, self.cfg,
                                  s_max or x.shape[1])
        return self.logits(self.final_norm(x[:, -1:])), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List[attn.Cache],
                    idx: torch.Tensor
                    ) -> Tuple[torch.Tensor, List[attn.Cache]]:
        """token: (B, 1) int; idx: (B,) int32 positions of the new tokens.
        Returns the logits (B, 1, V) f32 and the caches (updated in
        place)."""
        self._one_device("decode")
        x = self._embed(token, self.rt.dtype)
        x, caches = stack_decode(self.blocks, x, caches, idx, self.cfg)
        return self.logits(self.final_norm(x)), caches

    # ----- paged serving (docs/serving.md) -----
    def init_pools(self, num_blocks: int, block_size: int) -> List[attn.Pool]:
        """This rank's paged KV pools (its kv heads on a ring)."""
        return init_stack_pools(self.cfg, num_blocks, block_size,
                                self.rt.dtype, self.device, self.tp)

    @torch.no_grad()
    def serve_step(self, tokens: torch.Tensor, pools: List[attn.Pool],
                   view: attn.KVView) -> Tuple[torch.Tensor, List[attn.Pool]]:
        """One mixed prefill/decode step against paged KV pools.
        tokens: (B, S_step) int (0 at padding positions). Returns the
        per-row logits at each row's last valid position, (B, 1, V) f32,
        and the pools (updated in place). On a TP ring every rank passes the
        same tokens and view with its own pools (:meth:`init_pools`) and
        gets the same logits: a dense or an MoE model (each rank routes the
        whole step and runs the experts it holds), as long as every block's
        attention splits over the ring."""
        if self.auto:
            raise auto_unported("paged serving")
        if any(b.kind not in ("attn", "swa") for b in self.blocks):
            raise NotImplementedError(
                f"{self.cfg.name}: only attention blocks have a paged path; "
                "serve the others through the dense engine")
        if self.dp > 1:
            raise NotImplementedError(
                "serving on a mesh with a data axis is not ported (JAX's "
                "period-graph serve path is dp 1 as well): serve on the TP "
                "group alone")
        tpc = _tp_context(self.rt, self.group)
        x = self._embed(tokens, self.rt.dtype)
        x, pools = stack_step(self.blocks, x, pools, view, self.cfg, tpc)
        B = x.shape[0]
        x_last = x[torch.arange(B, device=x.device), view.last.long()][:, None]
        return self.logits(self.final_norm(x_last)), pools
