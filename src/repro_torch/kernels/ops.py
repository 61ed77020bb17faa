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
from repro_torch.kernels import ref


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a (M,K) @ b (K,N) -> (M,N) with an f32 accumulator, in ``out_dtype``
    (default a's type). Both devices take only 2-D contiguous operands, so
    the CPU tests hold callers to the kernel's layout."""
    if a.dim() != 2 or b.dim() != 2 or not (a.is_contiguous()
                                             and b.is_contiguous()):
        raise ValueError("matmul takes 2-D contiguous operands; got "
                         f"{tuple(a.shape)} {tuple(a.stride())} @ "
                         f"{tuple(b.shape)} {tuple(b.stride())}")
    if a.device.type == "cuda":
        return _mm.matmul(a, b, out_dtype=out_dtype)
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b, out_dtype)
    raise ValueError(f"no matmul for device {a.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ·scale) v under the position mask; q (B,Sq,H,dh),
    k/v (B,Skv,Hkv,dh)."""
    kw = dict(q_positions=q_positions, kv_positions=kv_positions,
              causal=causal, window=window, scale=scale)
    if q.device.type == "cuda":
        return _fa.flash_attention(q, k, v, **kw)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, **kw)
    raise ValueError(f"no flash_attention for device {q.device}")
