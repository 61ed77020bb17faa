"""Plain PyTorch versions of the port's kernels: the CPU path of
:mod:`repro_torch.kernels.ops` and what the CUDA kernels are held against.

Counterpart of ``repro/kernels/ref.py``, with one deliberate difference: the
JAX oracle ``flash_attention_ref`` masks causally bottom-right
(``tril(k=Skv-Sq)``) while its Pallas kernel masks top-left; the two agree
only for Sq == Skv. Here every mask comes from absolute positions, as the
model's ``attention_core`` takes it, so the (BH, S, d) form below is the
top-left case of :func:`attention_ref` with positions = arange.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.3819763e38   # finite, as in the model: masked weights are exact 0


def visible(q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
            causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, Sq, Skv) bool: which keys each query may see."""
    kv = kv_positions[:, None, :]
    ok = (kv >= 0).expand(-1, q_positions.shape[1], -1)
    if causal:
        qp = q_positions[:, :, None]
        ok = ok & (kv <= qp)
        if window:
            ok = ok & (kv > qp - window)
    return ok


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_positions: torch.Tensor, kv_positions: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Sq,H,dh), k/v (B,Skv,Hkv,dh) -> (B,Sq,H,dh) in q's type, all
    arithmetic in f32. GQA: query head h reads kv head h // (H/Hkv). A row
    with no visible key holds zeros (the kernel's convention)."""
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, dv = v.shape
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    qg = q.float().reshape(B, Sq, Hkv, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    ok = visible(q_positions, kv_positions, causal=causal,
                 window=window)[:, None, None]
    p = torch.softmax(s.masked_fill(~ok, NEG_INF), dim=-1) * ok
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, dv).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The TPU kernel's own case: q, k, v (BH, S, d), heads folded into the
    batch, causal top-left over positions arange."""
    BH, Sq, _ = q.shape
    Skv = k.shape[1]
    qp = torch.arange(Sq, dtype=torch.int32, device=q.device).expand(BH, Sq)
    kp = torch.arange(Skv, dtype=torch.int32, device=q.device).expand(BH, Skv)
    o = attention_ref(q[:, :, None], k[:, :, None], v[:, :, None],
                      q_positions=qp, kv_positions=kp, causal=causal,
                      scale=scale)
    return o[:, :, 0]
