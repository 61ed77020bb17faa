"""Dense FFN blocks (gated MLP). Counterpart of the dense part
of ``repro/models/ffn.py``; MoE is ROADMAP A10."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import activation, dense_init_, gated


class MLP(nn.Module):
    """w_up (d, d_ff), w_gate (d, d_ff) and w_down (d_ff, d)."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        mk = lambda *s: nn.Parameter(
            torch.empty(s, dtype=dtype, device=device), requires_grad=False)
        self.w_up = mk(d_model, d_ff)
        self.w_down = mk(d_ff, d_model)
        self.w_gate = mk(d_model, d_ff)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_up, self.w_down, self.w_gate):
            dense_init_(w, generator)


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError("MoE FFN is not ported yet (ROADMAP A10)")
    if not gated(cfg.act):
        raise NotImplementedError(f"non-gated MLP ({cfg.act!r}) is not ported "
                                  "yet")


def init_ffn(cfg: ArchConfig, dtype: torch.dtype,
             device: torch.device) -> MLP:
    _dense_only(cfg)
    return MLP(cfg.d_model, cfg.d_ff, dtype, device)


def mlp_forward(params: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    dtype = x.dtype
    gate = activation(act, x @ params.w_gate.to(dtype))
    h = gate * (x @ params.w_up.to(dtype))
    return h @ params.w_down.to(dtype)


def ffn_forward(params: MLP, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Unified FFN entry (dense only). The JAX version also returns the MoE
    aux loss, which is 0 for every dense FFN."""
    _dense_only(cfg)
    return mlp_forward(params, x, cfg.act)
