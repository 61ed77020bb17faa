"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427), the
counterpart of ``repro/models/rglru.py``.

h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ u_t),   a_t = a^{c·r_t}

Training and prefill evaluate the linear recurrence in log depth
(:func:`repro_torch.models.scan.linear_scan`, JAX's ``associative_scan``);
decode is the O(1) stateful step, updating its cache in place (the port's
departure 4, ``models/attention.py``). Gates use per-channel (diagonal)
weights, as JAX's do. The recurrence is sequence-local: on a TP ring the
mixer runs replicated (``core/tp.py::sp_replicated_mixer``), its weights
whole on every rank. The gates, ``Lambda`` and the recurrence are f32
whatever the parameter and compute types.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_init_, softplus
from repro_torch.models.scan import linear_scan
from repro_torch.models.ssm import conv_state

_C = 8.0   # Griffin's recurrence-gate temperature
Cache = Dict[str, torch.Tensor]   # {"h": (B, w), "conv": (B, W-1, w)}


def _lru_width(cfg: ArchConfig) -> int:
    return cfg.rglru.block_width or cfg.rglru.lru_width or cfg.d_model


class RGLRU(nn.Module):
    """RG-LRU parameters, JAX's names and shapes: w_y (gate branch) and w_x
    (recurrence branch) (d, w), conv_w (conv_width, w), conv_b, the four
    gate vectors and ``Lambda`` (w,) in f32, w_out (w, d)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, w, cw = cfg.d_model, _lru_width(cfg), cfg.rglru.conv_width
        par = lambda t: nn.Parameter(t, requires_grad=False)
        empty = lambda *sh: par(torch.empty(sh, dtype=dtype, device=device))
        zeros32 = lambda: par(torch.zeros(w, dtype=torch.float32,
                                          device=device))
        self.w_y = empty(d, w)
        self.w_x = empty(d, w)
        self.conv_w = empty(cw, w)
        self.conv_b = par(torch.zeros(w, dtype=dtype, device=device))
        self.gate_a_w = zeros32()
        self.gate_a_b = zeros32()
        self.gate_i_w = zeros32()
        self.gate_i_b = zeros32()
        # a = sigmoid(Λ); init so a^c ≈ 0.9..0.999 over channels
        self.Lambda = par(torch.linspace(2.0, 6.0, w, dtype=torch.float32,
                                         device=device))
        self.w_out = empty(w, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_y, self.w_x, self.conv_w, self.w_out):
            dense_init_(w, generator)


def _gates(params: RGLRU, u: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (..., w) conv output. Returns (a, gated input) in f32."""
    uf = u.float()
    r = torch.sigmoid(uf * params.gate_a_w + params.gate_a_b)
    i = torch.sigmoid(uf * params.gate_i_w + params.gate_i_b)
    log_a = -_C * r * softplus(params.Lambda)   # log(a^{c·r}) <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i * uf


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    width, S = w.shape[0], x.shape[1]
    if x0 is not None:
        ext = torch.cat([x0.to(x.dtype), x], dim=1)
    else:
        ext = F.pad(x, (0, 0, width - 1, 0))
    out = sum(ext[:, i:i + S, :] * w[i][None, None, :] for i in range(width))
    return out + b[None, None, :]


def rglru_forward(params: RGLRU, x: torch.Tensor, cfg: ArchConfig,
                  h0: Optional[torch.Tensor] = None,
                  conv0: Optional[torch.Tensor] = None,
                  return_state: bool = False):
    """x: (B,S,d) -> (B,S,d) [, (h_state, conv_state)]; the conv state is
    the last conv_width − 1 inputs of the conv, zero-padded on the left
    where S is shorter."""
    dtype = x.dtype
    y = F.gelu(x @ params.w_y.to(dtype), approximate="tanh")
    u = x @ params.w_x.to(dtype)
    uc = _causal_conv(u, params.conv_w.to(dtype), params.conv_b.to(dtype),
                      x0=conv0)
    a, bu = _gates(params, uc)                 # f32 (B, S, w)
    # the carried state folds into step 0: b0' = a0·h0 + b0
    h = linear_scan(a, bu, dim=1,
                    h0=None if h0 is None else h0.float())
    out = (h.to(dtype) * y) @ params.w_out.to(dtype)
    if return_state:
        return out, (h[:, -1].to(dtype),
                     conv_state(u, cfg.rglru.conv_width))
    return out


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Cache:
    w, cw = _lru_width(cfg), cfg.rglru.conv_width
    return {"h": torch.zeros(batch, w, dtype=dtype, device=device),
            "conv": torch.zeros(batch, cw - 1, w, dtype=dtype,
                                device=device)}


def rglru_decode(params: RGLRU, x: torch.Tensor, cache: Cache,
                 cfg: ArchConfig) -> Tuple[torch.Tensor, Cache]:
    """One-token step. x: (B,1,d). Returns (out (B,1,d), cache), the cache
    updated in place."""
    dtype = x.dtype
    xt = x[:, 0]
    y = F.gelu(xt @ params.w_y.to(dtype), approximate="tanh")
    u = xt @ params.w_x.to(dtype)

    window = torch.cat([cache["conv"].to(dtype), u[:, None]], dim=1)
    w = params.conv_w.to(dtype)
    uc = torch.einsum("bwc,wc->bc", window, w) + params.conv_b.to(dtype)

    a, bu = _gates(params, uc)
    h = a * cache["h"].float() + bu
    out = ((h.to(dtype) * y) @ params.w_out.to(dtype))[:, None]
    cache["h"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    return out, cache
