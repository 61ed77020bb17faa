"""Mamba-2 SSD mixer (state-space duality, arXiv:2405.21060), the
counterpart of ``repro/models/ssm.py``.

Training and prefill use the chunked dual form: quadratic attention-like
compute inside chunks and a linear recurrence across chunk states
(:func:`repro_torch.models.scan.linear_scan`, log depth, where JAX runs a
``lax.scan``). Decode is the O(1)-per-token stateful step, updating its
cache in place (the port's departure 4, ``models/attention.py``). The
recurrence is sequence-local: on a TP ring the mixer runs replicated
(``core/tp.py::sp_replicated_mixer``), its weights whole on every rank.

The decay math is f32 whatever the compute type, and every cast to the
compute type sits where JAX's does: ``A_log``, ``dt_bias`` and ``D`` are f32
parameters whatever the parameter type.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_init_, softplus
from repro_torch.models.scan import linear_scan

NEG_INF = -1e30
Cache = Dict[str, torch.Tensor]   # {"h": (B, H, P, N), "conv": (B, W-1, C)}


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, nheads, conv_ch


class SSM(nn.Module):
    """SSD parameters, JAX's names and shapes: w_in (d, z + xBC + dt
    widths), conv_w (conv_width, conv_ch), conv_b, A_log / dt_bias / D
    (nheads,) in f32, norm_scale (d_inner,), w_out (d_inner, d)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        s, d = cfg.ssm, cfg.d_model
        d_inner, nheads, conv_ch = _dims(cfg)
        par = lambda t: nn.Parameter(t, requires_grad=False)
        empty = lambda *sh: par(torch.empty(sh, dtype=dtype, device=device))
        f32 = dict(dtype=torch.float32, device=device)
        self.w_in = empty(d, 2 * d_inner + 2 * s.n_groups * s.d_state
                          + nheads)
        self.conv_w = empty(s.conv_width, conv_ch)
        self.conv_b = par(torch.zeros(conv_ch, dtype=dtype, device=device))
        self.A_log = par(torch.log(torch.linspace(1.0, 16.0, nheads, **f32)))
        self.dt_bias = par(torch.zeros(nheads, **f32))
        self.D = par(torch.ones(nheads, **f32))
        self.norm_scale = par(torch.zeros(d_inner, dtype=dtype,
                                          device=device))
        self.w_out = empty(d_inner, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_in, self.conv_w, self.w_out):
            dense_init_(w, generator)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., l) -> (..., l, l) with S[i,j] = sum_{k=j+1..i} x[k] (j<=i),
    NEG_INF above the diagonal."""
    cs = torch.cumsum(x, -1)
    S = cs[..., :, None] - cs[..., None, :]
    l = x.shape[-1]
    mask = torch.tril(torch.ones(l, l, dtype=torch.bool, device=x.device))
    return torch.where(mask, S, torch.full((), NEG_INF, dtype=S.dtype,
                                           device=S.device))


def _ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD. x: (b,s,h,p); dt: (b,s,h) post-softplus; A: (h,)
    negative; B, C: (b,s,g,n). Returns (y (b,s,h,p), h_final (b,h,p,n))."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    assert s % chunk == 0, (s, chunk)
    c, l = s // chunk, chunk
    hg = h // g   # heads per group
    dtype = x.dtype

    def cshape(t):   # (b,s,...) -> (b,c,l,...)
        return t.reshape(b, c, l, *t.shape[2:])

    xc, dtc, Bc, Cc = map(cshape, (x, dt, B, C))
    # decay math in f32 (exp/cumsum are precision-sensitive under bf16)
    dA = dtc.float() * A.float()[None, None, None, :]        # (b,c,l,h)
    dA_cs = torch.cumsum(dA, dim=2)

    # intra-chunk (the "attention-like" quadratic term)
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))           # (b,c,h,l,l)
    CB = torch.einsum("bclgn,bcmgn->bcglm", Cc.float(), Bc.float())
    CB = CB.repeat_interleave(hg, dim=2)                     # (b,c,h,l,m)
    gate = (CB * L).to(dtype)
    xdt = xc * dtc.to(dtype)[..., None]                      # (b,c,l,h,p)
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", gate, xdt)

    # chunk states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)    # (b,c,l,h)
    Bh = Bc.repeat_interleave(hg, dim=3)                     # (b,c,l,h,n)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", Bh,
                          decay_states.to(dtype), xdt)

    # inter-chunk recurrence: h_c = decay_c·h_{c-1} + state_c
    chunk_decay = torch.exp(dA_cs[:, :, -1, :]).to(dtype)    # (b,c,h)
    if h0 is None:
        h0 = torch.zeros(b, h, p, n, dtype=dtype, device=x.device)
    hs = linear_scan(chunk_decay[..., None, None], states, dim=1, h0=h0)
    hT = hs[:, -1]
    hprevs = torch.cat([h0[:, None], hs[:, :-1]], dim=1)     # (b,c,h,p,n)

    # inter-chunk contribution
    Ch = Cc.repeat_interleave(hg, dim=3)                     # (b,c,l,h,n)
    state_decay = torch.exp(dA_cs).to(dtype)                 # (b,c,l,h)
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", Ch, hprevs, state_decay)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, hT


def _split_in(proj: torch.Tensor, cfg: ArchConfig):
    d_inner, nheads, conv_ch = _dims(cfg)
    return torch.split(proj, [d_inner, conv_ch, nheads], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. xBC: (b,s,ch); w: (width,ch)."""
    width, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(width))
    return out + bias[None, None, :]


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    y = y * F.silu(z)
    yf = y.float()
    out = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + eps)
    return (out * (1.0 + scale.float())).to(y.dtype)


def ssm_forward(params: SSM, x: torch.Tensor, cfg: ArchConfig,
                h0: Optional[torch.Tensor] = None,
                conv0: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """x: (B,S,d). Returns y or (y, (ssm_state, conv_state)); the conv
    state is the last conv_width − 1 inputs of the conv, zero-padded on the
    left where S is shorter."""
    s = cfg.ssm
    bsz, S, _ = x.shape
    d_inner, nheads, conv_ch = _dims(cfg)
    dtype = x.dtype

    proj = x @ params.w_in.to(dtype)
    z, xBC, dt = _split_in(proj, cfg)
    conv_w, conv_b = params.conv_w.to(dtype), params.conv_b.to(dtype)
    if conv0 is not None:
        ext = torch.cat([conv0.to(dtype), xBC], dim=1)
        conv_out = _causal_conv(ext, conv_w, conv_b)[:, conv0.shape[1]:]
    else:
        conv_out = _causal_conv(xBC, conv_w, conv_b)
    conv_out = F.silu(conv_out)
    gn = s.n_groups * s.d_state
    xs, B, C = torch.split(conv_out, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(bsz, S, nheads, s.head_dim)
    B = B.reshape(bsz, S, s.n_groups, s.d_state)
    C = C.reshape(bsz, S, s.n_groups, s.d_state)

    A = -torch.exp(params.A_log)
    dt = softplus(dt.float() + params.dt_bias)

    chunk = min(s.chunk_size, S)
    while S % chunk:
        chunk //= 2
    if h0 is not None:
        h0 = h0.to(dtype)
    y, hT = _ssd_chunked(xs, dt, A, B, C, chunk, h0=h0)
    y = y + xs * params.D.to(dtype)[None, None, :, None]
    y = y.reshape(bsz, S, d_inner)
    y = _gated_norm(y, z, params.norm_scale)
    out = y @ params.w_out.to(dtype)
    if return_state:
        return out, (hT, conv_state(xBC, s.conv_width))
    return out


def conv_state(u: torch.Tensor, width: int) -> torch.Tensor:
    """The last width − 1 rows of u (B, S, ch), zero-padded on the left
    where S < width − 1."""
    S = u.shape[1]
    if S >= width - 1:
        return u[:, S - (width - 1):, :]
    return F.pad(u, (0, 0, width - 1 - S, 0))


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                   device: torch.device) -> Cache:
    s = cfg.ssm
    d_inner, nheads, conv_ch = _dims(cfg)
    return {
        "h": torch.zeros(batch, nheads, s.head_dim, s.d_state, dtype=dtype,
                         device=device),
        "conv": torch.zeros(batch, s.conv_width - 1, conv_ch, dtype=dtype,
                            device=device),
    }


def ssm_decode(params: SSM, x: torch.Tensor, cache: Cache,
               cfg: ArchConfig) -> Tuple[torch.Tensor, Cache]:
    """One-token step. x: (B,1,d). Returns (y (B,1,d), cache), the cache
    updated in place."""
    s = cfg.ssm
    bsz = x.shape[0]
    d_inner, nheads, conv_ch = _dims(cfg)
    dtype = x.dtype

    proj = x[:, 0] @ params.w_in.to(dtype)                 # (B, ·)
    z, xBC, dt = _split_in(proj, cfg)

    window = torch.cat([cache["conv"].to(dtype), xBC[:, None]], dim=1)
    w = params.conv_w.to(dtype)
    conv_out = torch.einsum("bwc,wc->bc", window, w) + params.conv_b.to(dtype)
    conv_out = F.silu(conv_out)

    gn = s.n_groups * s.d_state
    xs, B, C = torch.split(conv_out, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(bsz, nheads, s.head_dim)
    B = B.reshape(bsz, s.n_groups, s.d_state)
    C = C.reshape(bsz, s.n_groups, s.d_state)
    hg = nheads // s.n_groups
    Bh = B.repeat_interleave(hg, dim=1)                    # (B, h, n)
    Ch = C.repeat_interleave(hg, dim=1)

    A = -torch.exp(params.A_log)
    dt_f = softplus(dt.float() + params.dt_bias)          # (B, h)
    decay = torch.exp(dt_f * A[None, :]).to(dtype)         # (B, h)

    dx = xs * dt_f.to(dtype)[..., None]                    # (B, h, p)
    h_new = (cache["h"].to(dtype) * decay[..., None, None]
             + dx[..., None] * Bh[:, :, None, :])          # (B, h, p, n)
    y = torch.einsum("bhpn,bhn->bhp", h_new, Ch)
    y = y + xs * params.D.to(dtype)[None, :, None]
    y = y.reshape(bsz, d_inner)
    y = _gated_norm(y, z, params.norm_scale)
    out = (y @ params.w_out.to(dtype))[:, None]
    cache["h"].copy_(h_new)
    cache["conv"].copy_(window[:, 1:])
    return out, cache

