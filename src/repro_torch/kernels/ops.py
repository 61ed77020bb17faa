"""Dispatch to the port's kernels by the device of the inputs.

Counterpart of ``repro/kernels/ops.py``. A CUDA tensor always goes to the
hand-written Hopper kernel (which launches or raises); only a tensor on the
CPU takes the plain version in :mod:`repro_torch.kernels.ref`. There is no
fallback from a failed kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import matmul_rmsnorm as _mln
from repro_torch.kernels import ref


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a (M,K) @ b (K,N) -> (M,N) with an f32 accumulator, in ``out_dtype``
    (default a's type). Each operand is contiguous or the transpose of a
    contiguous tensor (aᵀ, bᵀ: the backward's xᵀ and wᵀ, read where they
    lie); both devices refuse any other layout, so the CPU tests hold
    callers to the kernel's.

    It has no gradient of its own: the graph-built backward calls it for
    every dx and dw explicitly. So where autograd records and an input
    requires grad it raises on every device (the kernel's output would
    carry no ``grad_fn``; the CPU version's would, and hide the caller)."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError(
            "ops.matmul has no gradient: call it on tensors that do not "
            "require grad, or where autograd does not record (a period "
            "graph's forward and its graph-built backward)")
    _mm.layout(a, b)
    if a.device.type == "cuda":
        return _mm.matmul(a, b, out_dtype=out_dtype)
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b, out_dtype)
    raise ValueError(f"no matmul for device {a.device}")


def _matmul_rmsnorm_forward(a, b, scale, eps, out_dtype):
    if a.device.type == "cuda":
        return _mln.matmul_rmsnorm(a, b, scale, eps=eps, out_dtype=out_dtype)
    if a.device.type == "cpu":
        return ref.matmul_rmsnorm_ref(a, b, scale, eps, out_dtype)
    raise ValueError(f"no matmul_rmsnorm for device {a.device}")


class _MatmulRMSNorm(torch.autograd.Function):
    """matmul_rmsnorm as a differentiable op. Forward: the hand kernel on a
    CUDA tensor, the plain version on the CPU. Backward: the VJP of the
    plain version, recomputed in torch math from the saved a, b and scale.
    b may be a column slice of a wider weight (``wkv_a[:, :kv_rank]``): its
    grad flows back through the slice into that slice of the weight's grad.
    The JAX package differentiates ``apply_norm(x @ w)`` in plain ``jnp``
    and its Pallas kernel has no VJP, so this is the counterpart, not a
    fallback."""

    @staticmethod
    def forward(ctx, a, b, scale, eps, out_dtype):
        ctx.save_for_backward(a, b, scale)
        ctx.eps, ctx.out_dtype = eps, out_dtype
        return _matmul_rmsnorm_forward(a, b, scale, eps, out_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            prim = tuple(t.detach().requires_grad_(n)
                         for t, n in zip(saved, need))
            out = ref.matmul_rmsnorm_ref(*prim, ctx.eps, ctx.out_dtype)
            got = iter(torch.autograd.grad(
                out, [t for t, n in zip(prim, need) if n], grad_out))
        return (*(next(got) if n else None for n in need), None, None)


def matmul_rmsnorm(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, *,
                   eps: float = 1e-6,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """rmsnorm(a (M,K) @ b (K,N)) * (1 + scale) -> (M,N) in ``out_dtype``
    (default a's type), the norm over each whole f32 row of a @ b. Both
    devices take the kernel's layouts only (a contiguous; b with unit column
    stride and row stride >= N, so a column slice of a weight passes as it
    is). Differentiable in a, b and scale (:class:`_MatmulRMSNorm`) where
    autograd records and one of them requires grad; otherwise one plain call
    of the kernel or the CPU version."""
    _mln.check_layout(a, b, scale)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (a, b, scale)):
        return _MatmulRMSNorm.apply(a, b, scale, eps, out_dtype)
    return _matmul_rmsnorm_forward(a, b, scale, eps, out_dtype)


def _attention_forward(q, k, v, kw):
    if q.device.type == "cuda":
        return _fa.flash_attention(q, k, v, **kw)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, **kw)
    raise ValueError(f"no flash_attention for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The attention core as a differentiable op. Forward: the hand kernel on
    a CUDA tensor, the plain version on the CPU. Backward: the VJP of the
    plain version, recomputed in torch math from the saved q, k, v. The JAX
    package has no backward kernel either (its Pallas kernel has no VJP and
    its model's core is plain ``jnp``), so this is the counterpart, not a
    fallback."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, causal, window,
                scale, prefix_len):
        ctx.save_for_backward(q, k, v, q_positions, kv_positions)
        ctx.kw = dict(causal=causal, window=window, scale=scale,
                      prefix_len=prefix_len)
        return _attention_forward(q, k, v, dict(
            q_positions=q_positions, kv_positions=kv_positions, **ctx.kw))

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, q_positions, kv_positions = ctx.saved_tensors
        with torch.enable_grad():
            prim = tuple(t.detach().requires_grad_() for t in (q, k, v))
            out = ref.attention_ref(*prim, q_positions=q_positions,
                                    kv_positions=kv_positions, **ctx.kw)
            grads = torch.autograd.grad(out, prim, grad_out)
        return (*grads, None, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """softmax(q kᵀ·scale) v under the position mask
    (:func:`repro_torch.kernels.ref.visible`: causal or not, a sliding
    window, a prefix-LM prefix); q (B,Sq,H,dh), k (B,Skv,Hkv,dh),
    v (B,Skv,Hkv,dv) with dv <= dh -> (B,Sq,H,dv). Differentiable in q, k
    and v (:class:`_FlashAttention`) where autograd records; otherwise one
    plain call of the kernel or the CPU version."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, q_positions, kv_positions,
                                     causal, window, scale, prefix_len)
    return _attention_forward(q, k, v, dict(
        q_positions=q_positions, kv_positions=kv_positions, causal=causal,
        window=window, scale=scale, prefix_len=prefix_len))
