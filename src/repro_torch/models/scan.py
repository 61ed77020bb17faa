"""The linear recurrence h_t = a_t·h_{t-1} + b_t along one dimension, in
log depth: the port's stand-in for ``jax.lax.associative_scan`` over the
pairs (a, b) (RG-LRU, ``repro/models/rglru.py``) and for the inter-chunk
``lax.scan`` of Mamba-2's SSD (``repro/models/ssm.py``).

The scan doubles its reach each step (Hillis–Steele): after the step of
offset d every position holds the recurrence folded over its last 2d
inputs, so n positions take ⌈log2 n⌉ elementwise steps of whole tensors,
whatever n is; a Python loop over time steps would launch n small kernels
a layer on the card. Its backward is the adjoint recurrence, itself a
scan run backwards: λ_t = g_t + a_{t+1}·λ_{t+1}, then ∂b_t = λ_t, ∂a_t =
λ_t·h_{t-1} and ∂h0 = a_0·λ_0. So it keeps a and h for the backward, not
the ⌈log2 n⌉ intermediates autograd would keep through the doubling steps
(on a ring a replicated RG-LRU mixer scans the whole gathered sequence on
every rank).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable


def _scan(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """Every h_t of h_t = a_t·h_{t-1} + b_t, h_{-1} = 0, by doubling."""
    n = b.shape[dim]
    d = 1
    while d < n:
        head, tail = b.narrow(dim, 0, d), b.narrow(dim, d, n - d)
        a_tail = a.narrow(dim, d, n - d)
        b = torch.cat([head, a_tail * b.narrow(dim, 0, n - d) + tail], dim)
        if 2 * d < n:
            a = torch.cat([a.narrow(dim, 0, d),
                           a_tail * a.narrow(dim, 0, n - d)], dim)
        d *= 2
    return b


def _sum_to(x: torch.Tensor, shape) -> torch.Tensor:
    """x summed over the dimensions along which ``shape`` broadcasts."""
    dims = [i for i, (s, t) in enumerate(zip(shape, x.shape)) if s != t]
    return x.sum(dims, keepdim=True) if dims else x


class _LinearScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b, h0, dim):
        if h0 is not None:
            first = a.narrow(dim, 0, 1) * h0.unsqueeze(dim) \
                + b.narrow(dim, 0, 1)
            b = torch.cat([first, b.narrow(dim, 1, b.shape[dim] - 1)], dim)
        h = _scan(a, b, dim)
        ctx.dim, ctx.has_h0 = dim, h0 is not None
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        dim = ctx.dim
        n = h.shape[dim]
        # λ_t = g_t + a_{t+1}·λ_{t+1}: the forward scan on the reversed
        # sequence, a shifted by one (a_n = 0)
        a_next = torch.cat([a.narrow(dim, 1, n - 1),
                            torch.zeros_like(a.narrow(dim, 0, 1))], dim)
        lam = _scan(a_next.flip(dim), g.flip(dim), dim).flip(dim)
        first = (h0.unsqueeze(dim) if ctx.has_h0
                 else torch.zeros_like(h.narrow(dim, 0, 1)))
        h_prev = torch.cat([first, h.narrow(dim, 0, n - 1)], dim)
        da = _sum_to(lam * h_prev, a.shape)
        dh0 = None
        if ctx.has_h0:
            dh0 = (a.narrow(dim, 0, 1) * lam.narrow(dim, 0, 1)).squeeze(dim)
            dh0 = _sum_to(dh0, h0.shape)
        return da, lam, dh0, None


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every h_t of h_t = a_t·h_{t-1} + b_t along ``dim`` (h_{-1} = ``h0``,
    or 0), computed in the inputs' type. ``a`` has ``b``'s size along
    ``dim`` and broadcasts against it elsewhere (a decay a head, say);
    ``h0`` is ``b`` without ``dim``. Returns h, shaped as ``b``;
    differentiable in a, b and h0."""
    dim = dim % b.ndim
    if a.shape[dim] != b.shape[dim]:
        raise ValueError(f"a has {a.shape[dim]} steps along dim {dim}, b "
                         f"has {b.shape[dim]}")
    return _LinearScan.apply(a, b, h0, dim)
