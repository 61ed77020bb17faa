"""Shared layer primitives: initializers, norms, rotary embeddings,
activations. Counterpart of ``repro/models/layers.py``.

Norms and rope compute in f32 and return the input's type. Parameters keep
JAX's ``(d_in, d_out)`` layout, so a projection is ``x @ w``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                fan_in: int = 0) -> torch.Tensor:
    """Truncated-normal fan-in init, cut at two standard deviations; the
    fan-in is ``w.shape[0]`` (the ``d_in`` axis) unless ``fan_in`` names it
    (an expert stack (E, d_in, d_out) passes d_in)."""
    std = 1.0 / math.sqrt(max(fan_in or w.shape[0], 1))
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def embed_init_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return nn.init.normal_(w, std=0.02, generator=generator)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(kind: str, x: torch.Tensor, scale: torch.Tensor,
               eps: float = 1e-6,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gemma-style rmsnorm, ``x * rsqrt(mean(x²) + eps) * (1 + scale)``, or
    layernorm, ``(x - μ) * rsqrt(var + eps) * scale + bias``; other kinds
    raise."""
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * scale.float() \
            + bias.float()
    else:
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    return out.to(x.dtype)


class Norm(nn.Module):
    """Norm parameters: an rmsnorm's ``scale``, zeros at init (a
    ``(1 + 0)`` scale); a layernorm's ``scale``, ones, and ``bias``,
    zeros."""

    def __init__(self, kind: str, dim: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.kind = kind
        fill = torch.ones if kind == "layernorm" else torch.zeros
        self.scale = nn.Parameter(fill(dim, dtype=dtype, device=device),
                                  requires_grad=False)
        self.bias = None
        if kind == "layernorm":
            self.bias = nn.Parameter(
                torch.zeros(dim, dtype=dtype, device=device),
                requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.kind, x, self.scale, bias=self.bias)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S). Split-half
    convention: the first and second halves of D form the rotated pairs."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs            # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name in ("gelu", "gelu_mlp"):
        return F.gelu(x, approximate="tanh")
    raise NotImplementedError(f"activation {name!r} is not ported yet")


def gated(name: str) -> bool:
    """Whether ``name`` is a gated activation (``act(x @ w_gate) * x @ w_up``;
    ``gelu_mlp`` is the non-gated ``act(x @ w_up)``)."""
    return name in ("silu", "gelu")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
