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
from repro_torch.kernels import ref


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
