"""FFN blocks: the dense MLP (gated, or non-gated for ``gelu_mlp``) and the
capacity-bounded top-k MoE, the counterpart of ``repro/models/ffn.py``.

MoE follows the GShard/Mesh-TF formulation: tokens are reshaped into
``(groups, group_size)`` and dispatched to experts with a one-hot
capacity-bounded dispatch tensor. On one device the dispatch, expert and
combine einsums are torch ops, as JAX's are plain ``jnp`` (no Pallas kernel
computes them); on a TP ring the experts are sharded by whole expert and, in
training on a sequence shard, the expert path runs through the period
graph's ``route`` → ``a2a_ffn`` → ``unroute`` nodes
(:mod:`repro_torch.core.tp`); in serving, and in training at a sequence
that does not split over the ring, every rank routes the whole step alike
(:func:`route_tokens`), runs its own experts and one all-reduce sums them
(the ``expert_ar`` node). Either way the expert GEMMs go through the matmul
kernel.

Routing is discrete: the top-2 choice and the capacity slots come from
argmax and cumsum, so the router logits are computed in f32 (the router
weight stays f32 whatever the parameter type, TF32 off) and ``torch.argmax``
keeps ``jnp.argmax``'s first-maximum rule. The masks are ``F.one_hot`` of
integer indices and carry no gradient, so autograd of
:func:`_top2_dispatch` is ``jax.vjp`` of JAX's: the aux loss reaches the
router logits only through the mean router probability.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import activation, dense_init_, gated


class MLP(nn.Module):
    """w_up (d, d_ff), w_down (d_ff, d) and, gated (``act`` silu or gelu),
    w_gate (d, d_ff); a non-gated MLP (``gelu_mlp``) has no w_gate."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device, act: str = "silu"):
        super().__init__()
        mk = lambda *s: nn.Parameter(
            torch.empty(s, dtype=dtype, device=device), requires_grad=False)
        self.w_up = mk(d_model, d_ff)
        self.w_down = mk(d_ff, d_model)
        self.w_gate = mk(d_model, d_ff) if gated(act) else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_up, self.w_down, self.w_gate):
            if w is not None:
                dense_init_(w, generator)


class MoE(nn.Module):
    """The router (d, E), f32 whatever ``dtype``; the experts' gated MLPs
    stacked on a leading expert axis, w_up/w_gate (E_loc, d, d_ff) and
    w_down (E_loc, d_ff, d); and, for a dense-residual MoE (Arctic), the
    dense MLP ``dense`` beside them. ``num_local`` is the experts this rank
    holds (all E on one device)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, num_local: int):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
        mk = lambda *s, dt=dtype: nn.Parameter(
            torch.empty(s, dtype=dt, device=device), requires_grad=False)
        self.router = mk(d, E, dt=torch.float32)
        self.w_up = mk(num_local, d, f)
        self.w_down = mk(num_local, f, d)
        self.w_gate = mk(num_local, d, f)
        dr = cfg.moe.dense_residual_d_ff
        self.dense = MLP(d, dr, dtype, device, cfg.act) if dr else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, f = self.w_up.shape[1], self.w_up.shape[2]
        dense_init_(self.router, generator)
        dense_init_(self.w_up, generator, fan_in=d)
        dense_init_(self.w_down, generator, fan_in=f)
        dense_init_(self.w_gate, generator, fan_in=d)
        if self.dense is not None:
            self.dense.reset_parameters(generator)


def _gated_experts(cfg: ArchConfig) -> None:
    if not gated(cfg.act):
        raise NotImplementedError(f"an MoE of non-gated experts ({cfg.act!r}) "
                                  "is not ported (no arch has one)")


def local_experts(cfg: ArchConfig, tp: int) -> int:
    """The experts a rank of a ring of ``tp`` holds: E/tp where they shard
    by whole expert (E % tp == 0), all E otherwise (replicated; the E < tp
    owner mapping of :func:`repro_torch.core.tp.sp_moe_ffn`)."""
    E = cfg.moe.num_experts
    return E // tp if tp > 1 and E % tp == 0 else E


def init_ffn(cfg: ArchConfig, dtype: torch.dtype, device: torch.device,
             tp: int = 1, route_ring: Optional[int] = None
             ) -> Union[MLP, MoE]:
    """The FFN parameters; on a TP ring of ``tp`` ranks one rank's shards
    (w_up/w_gate by columns, w_down by rows; an MoE's experts by whole
    expert over ``route_ring``, default ``tp``: on a 2D mesh tp_out, the
    grouped-EP placement; its router and dense MLP whole)."""
    if cfg.moe is not None:
        _gated_experts(cfg)
        return MoE(cfg, dtype, device, local_experts(
            cfg, tp if route_ring is None else route_ring))
    return MLP(cfg.d_model, cfg.d_ff // tp, dtype, device, cfg.act)


def mlp_forward(params: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up) @ w_down`` gated, ``act(x @ w_up) @
    w_down`` not."""
    dtype = x.dtype
    h = x @ params.w_up.to(dtype)
    if params.w_gate is not None:
        h = activation(act, x @ params.w_gate.to(dtype)) * h
    else:
        h = activation(act, h)
    return h @ params.w_down.to(dtype)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def capacity(tokens: int, cfg: ArchConfig) -> int:
    """The expert buffer slots for a group of ``tokens``, in JAX's
    operation order (another float order can truncate to another value)."""
    m = cfg.moe
    return max(1, int(tokens * m.top_k / m.num_experts * m.capacity_factor))


def _top2_dispatch(probs: torch.Tensor, capacity: int):
    """GShard top-2 dispatch. probs: (G, g, E) f32.

    Returns (dispatch (G,g,E,C) bool, combine (G,g,E,C) f32, aux_loss). The
    aux loss's gradient reaches the logits only through ``density_proxy``
    (the mean router probability); the one-hot factors carry none, which is
    the Switch/GShard straight-through convention of ``repro``'s."""
    G, g, E = probs.shape
    idx1 = torch.argmax(probs, -1)
    mask1 = F.one_hot(idx1, E).to(probs.dtype)
    probs_wo1 = probs * (1.0 - mask1)
    idx2 = torch.argmax(probs_wo1, -1)
    mask2 = F.one_hot(idx2, E).to(probs.dtype)

    # load-balancing auxiliary loss (Switch/GShard)
    density = torch.mean(mask1, dim=1)              # (G, E) fraction routed
    density_proxy = torch.mean(probs, dim=1)        # (G, E) mean router prob
    aux = torch.mean(density * density_proxy) * (E * E)

    # capacity-bounded positions inside each expert buffer
    pos1 = torch.cumsum(mask1, dim=1) * mask1 - mask1          # 0-based
    mask1 = mask1 * (pos1 < capacity)
    # second choice queues behind all first choices
    count1 = torch.sum(mask1, dim=1, keepdim=True)
    pos2 = (torch.cumsum(mask2, dim=1) * mask2 - mask2) + count1
    mask2 = mask2 * (pos2 < capacity)

    gate1 = torch.sum(probs * mask1, -1)
    gate2 = torch.sum(probs * mask2, -1)
    denom = torch.clamp(gate1 + gate2, min=1e-9)
    gate1, gate2 = gate1 / denom, gate2 / denom

    def onehot_pos(pos, mask):
        # (G,g,E) position -> (G,g,E,C) one-hot, zeroed where not routed;
        # wherever pos >= capacity the mask is already 0, so the clamp (which
        # F.one_hot needs: jax.nn.one_hot gives zeros out of range) changes
        # nothing
        oh = F.one_hot(pos.long().clamp(0, capacity - 1), capacity)
        return oh.to(probs.dtype) * mask[..., None]

    d1 = onehot_pos(pos1, mask1)
    d2 = onehot_pos(pos2, mask2)
    combine = gate1[..., None, None] * d1 + gate2[..., None, None] * d2
    dispatch = (d1 + d2) > 0.0
    return dispatch, combine, aux


def router_probs(t: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """softmax of the f32 router logits of tokens ``t`` (..., d)."""
    return torch.softmax(t.float() @ router, dim=-1)


def group_size(tokens: int, cfg: ArchConfig) -> int:
    """The routing group of a step or batch of ``tokens``: ``group_size``,
    halved until it divides ``tokens`` (JAX's ``moe_forward``)."""
    g = min(cfg.moe.group_size, tokens)
    while tokens % g:   # shrink until it divides (small/odd batches)
        g //= 2
    return g


def check_replica_routing(cfg: ArchConfig, tokens: int, dp: int) -> None:
    """Raise, before any collective, where a data replica that routes its
    ``tokens`` rows of a global batch of ``dp`` such replicas in one piece
    (the replicated activation layout) would not route them as JAX's
    ``moe_forward`` routes the global batch under GSPMD: where the global
    batch's :func:`group_size` is not the replica's own, its groups
    straddle the replicas (each replica's capacity slots would depend on
    the other's tokens) or differ in size and capacity."""
    if cfg.moe is None or dp == 1:
        return
    g, own = group_size(dp * tokens, cfg), group_size(tokens, cfg)
    if g != own:
        raise NotImplementedError(
            f"{cfg.name}: the global batch routes in groups of {g} tokens, "
            f"the {dp} data replicas' {tokens} tokens each in groups of "
            f"{own}; routing the replicas' rows in the global groups is not "
            "ported (ROADMAP A11 (b))")


def route_tokens(x: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """The routing of a (B, S, d) step or batch, as JAX's ``moe_forward``
    routes it: tokens in groups of ``group_size`` over the batch-major
    flattening, halved until the group divides B·S (decode steps, odd
    batches; padding tokens route with the rest), the capacity from the
    group, the f32 router and :func:`_top2_dispatch`. Returns (xt (G, g, d),
    dispatch (G, g, E, C), combine (G, g, E, C), aux). One device's
    :func:`moe_forward` and the TP ring's graphs of the replicated layout
    (:func:`repro_torch.core.tp._moe_replicated_fns`, on every rank alike:
    serving, and training at a sequence that does not split over the ring)
    route through it, so both route exactly the same groups."""
    B, S, d = x.shape
    g = group_size(B * S, cfg)
    xt = x.reshape((B * S) // g, g, d)
    probs = router_probs(xt, router)
    return (xt,) + _top2_dispatch(probs, capacity(g, cfg))


def moe_forward(params: MoE, x: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss), every expert on this device, routed
    by :func:`route_tokens`."""
    B, S, d = x.shape
    dtype = x.dtype
    xt, dispatch, combine, aux = route_tokens(x, params.router, cfg)

    # dispatch: tokens -> expert buffers (E, G, C, d)
    einp = torch.einsum("gsec,gsd->egcd", dispatch.to(dtype), xt)
    h = torch.einsum("egcd,edf->egcf", einp, params.w_up.to(dtype))
    gate = torch.einsum("egcd,edf->egcf", einp, params.w_gate.to(dtype))
    h = activation(cfg.act, gate) * h
    eout = torch.einsum("egcf,efd->egcd", h, params.w_down.to(dtype))
    out = torch.einsum("gsec,egcd->gsd", combine.to(dtype), eout)
    out = out.reshape(B, S, d)
    if params.dense is not None:
        out = out + mlp_forward(params.dense, x, cfg.act)
    return out, aux.float()


def ffn_forward(params: Union[MLP, MoE], x: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unified FFN entry: returns (out, aux_loss), the aux loss 0 for a
    dense MLP."""
    if cfg.moe is not None:
        return moe_forward(params, x, cfg)
    return mlp_forward(params, x, cfg.act), torch.zeros(
        (), dtype=torch.float32, device=x.device)
