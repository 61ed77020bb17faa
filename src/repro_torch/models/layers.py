"""Shared layer primitives: initializers, norms, rotary embeddings,
activations. Counterpart of ``repro/models/layers.py``.

Norms and rope compute in f32 and return the input's type. Parameters keep
JAX's ``(d_in, d_out)`` layout, so a projection is ``x @ w``.
"""
from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Truncated-normal fan-in init (fan-in = ``w.shape[0]``, the ``d_in``
    axis), cut at two standard deviations."""
    std = 1.0 / math.sqrt(max(w.shape[0], 1))
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def embed_init_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return nn.init.normal_(w, std=0.02, generator=generator)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(kind: str, x: torch.Tensor, scale: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style rmsnorm, ``x * rsqrt(mean(x²) + eps) * (1 + scale)``.
    Every ported arch uses it; other kinds raise."""
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


class Norm(nn.Module):
    """Norm parameters: ``scale``, zeros at init (a ``(1 + 0)`` scale)."""

    def __init__(self, kind: str, dim: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.kind = kind
        self.scale = nn.Parameter(
            torch.zeros(dim, dtype=dtype, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.kind, x, self.scale)


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
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise NotImplementedError(f"activation {name!r} is not ported yet")


def gated(name: str) -> bool:
    """Whether ``name`` is a gated activation (``act(x @ w_gate) * x @ w_up``);
    only gated MLPs are ported."""
    return name in ("silu", "gelu")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
