"""Plain PyTorch versions of the port's kernels: the CPU path of
:mod:`repro_torch.kernels.ops` and what the CUDA kernels are held against.

Counterpart of ``repro/kernels/ref.py``, with one deliberate difference in
attention: the JAX oracle ``flash_attention_ref`` masks causally bottom-right
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


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a (M,K) @ b (K,N) with f32 products and sums, cast to ``out_dtype``
    (default a's type)."""
    out_dtype = a.dtype if out_dtype is None else out_dtype
    return (a.float() @ b.float()).to(out_dtype)


def matmul_rmsnorm_ref(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-6,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """rmsnorm(a (M,K) @ b (K,N)) * (1 + scale), eps 1e-6: f32 products and
    sums, the norm of the f32 accumulator in f32, cast to ``out_dtype``
    (default a's type)."""
    out_dtype = a.dtype if out_dtype is None else out_dtype
    z = a.float() @ b.float()
    var = z.square().mean(-1, keepdim=True)
    return (z * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(out_dtype)


def visible(q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
            causal: bool = True, window: int = 0,
            prefix_len: int = 0) -> torch.Tensor:
    """(B, Sq, Skv) bool: which keys each query may see. Key j is visible to
    query i iff kv_pos[j] >= 0 and, when causal, (kv_pos[j] <= q_pos[i] or
    both lie in the prefix-LM prefix, kv_pos[j] < prefix_len and q_pos[i] <
    prefix_len) and (window 0 or kv_pos[j] > q_pos[i] - window): the
    window applies after the prefix's OR, as in JAX's ``attention_core``."""
    kv = kv_positions[:, None, :]
    ok = (kv >= 0).expand(-1, q_positions.shape[1], -1)
    if causal:
        qp = q_positions[:, :, None]
        rel = kv <= qp
        if prefix_len:
            rel = rel | ((kv < prefix_len) & (qp < prefix_len))
        ok = ok & rel
        if window:
            ok = ok & (kv > qp - window)
    return ok


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_positions: torch.Tensor, kv_positions: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None,
                  prefix_len: int = 0) -> torch.Tensor:
    """q (B,Sq,H,dh), k/v (B,Skv,Hkv,dh) -> (B,Sq,H,dh) in q's type, all
    arithmetic in f32. GQA: query head h reads kv head h // (H/Hkv). A row
    with no visible key holds zeros (the kernel's convention)."""
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, dv = v.shape
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    qg = q.float().reshape(B, Sq, Hkv, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    ok = visible(q_positions, kv_positions, causal=causal, window=window,
                 prefix_len=prefix_len)[:, None, None]
    p = torch.softmax(s.masked_fill(~ok, NEG_INF), dim=-1) * ok
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, dv).to(q.dtype)


def splitkv_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_positions: torch.Tensor, kv_positions: torch.Tensor,
                     kchunk: int, causal: bool = True, window: int = 0,
                     scale: Optional[float] = None, prefix_len: int = 0):
    """The split-KV kernel's first step, plainly: for each range of
    ``kchunk`` keys, each query row's running max m (of the scaled scores;
    −inf where the range holds no visible key), sum l = Σ exp(s − m) and
    acc = Σ exp(s − m) v, all f32. Returns (m, l, acc) stacked over the
    ranges: (n, B, Sq, H), (n, B, Sq, H), (n, B, Sq, H, dv)."""
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, dv = v.shape
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    qg = q.float().reshape(B, Sq, Hkv, G, dh)
    ok = visible(q_positions, kv_positions, causal=causal, window=window,
                 prefix_len=prefix_len)
    ms, ls, accs = [], [], []
    for k0 in range(0, Skv, kchunk):
        ks = slice(k0, k0 + kchunk)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k[:, ks].float()) * scale
        vis = ok[:, :, None, None, ks]
        s = s.masked_fill(~vis, -math.inf)
        m = s.amax(-1)
        # no visible key: m = −inf and every weight 0, never exp(−inf + inf)
        p = torch.where(vis, torch.exp(s - m.clamp_min(NEG_INF)[..., None]),
                        torch.zeros(()))
        ms.append(m.reshape(B, Sq, H))
        ls.append(p.sum(-1).reshape(B, Sq, H))
        accs.append(torch.einsum("bqhgk,bkhd->bqhgd", p,
                                 v[:, ks].float()).reshape(B, Sq, H, dv))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def splitkv_merge(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The split-KV kernel's merge, plainly: with M the max of the ranges'
    m, weights w = exp(m − M) (0 for a range with no visible key), O = Σ w
    acc / Σ w l, or zeros for a row with no visible key at all; in
    ``dtype``."""
    M = m.amax(0)
    w = torch.where(m == -math.inf, torch.zeros(()),
                    torch.exp(m - M.clamp_min(NEG_INF)))
    L = (w * l).sum(0)
    o = (w[..., None] * acc).sum(0)
    inv = torch.where(L > 0, 1.0 / L.clamp_min(1e-30), torch.zeros(()))
    return (o * inv[..., None]).to(dtype)


def attention_splitkv_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, q_positions: torch.Tensor,
                          kv_positions: torch.Tensor, kchunk: int,
                          causal: bool = True, window: int = 0,
                          scale: Optional[float] = None,
                          prefix_len: int = 0) -> torch.Tensor:
    """:func:`attention_ref` computed as the split-KV kernel orders it:
    partials over key ranges of ``kchunk``, then the merge. The CPU tests
    hold it against :func:`attention_ref` and the Pallas kernel."""
    m, l, acc = splitkv_partials(q, k, v, q_positions=q_positions,
                                 kv_positions=kv_positions, kchunk=kchunk,
                                 causal=causal, window=window, scale=scale,
                                 prefix_len=prefix_len)
    return splitkv_merge(m, l, acc, q.dtype)


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
