"""Int8 gradient compression with error feedback for the data-parallel
all-reduce.

Counterpart of ``repro/optim/compression.py``. Each gradient tensor is
quantized to int8 with one scale, agreed over the replicas first (the max,
so that the codes are summable), before the all-reduce over the ``data``
group, and dequantized after: 4x less on the wire. An error-feedback buffer
keeps each replica's quantization residual, so that the averaged update
stays unbiased over steps. On the port's gloo transport the codes travel as
int32 (JAX's ``psum`` of ``q.astype(int32)``); the 4x is the int8 payload a
transport that sums int8 codes would move.

    grads, ef = compressed_psum(local_grads, ef, data_group)

``grads``/``ef`` are dicts name -> tensor.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.sharding import TPGroup

Tree = Dict[str, torch.Tensor]


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(grads: Tree) -> Tree:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def _pmax(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    if group.size == 1:
        return x
    every = group.all_gather(x.reshape(1), 0)
    return every.max()


def compressed_psum(grads: Tree, error_feedback: Tree, group: TPGroup,
                    mean: bool = True) -> Tuple[Tree, Tree]:
    """Quantized sum over ``group`` (the data axis) with error feedback.

    Each tensor: x = g + ef; scale = max over the replicas of max|x| / 127;
    q = int8(round(x / scale)); the sum of the codes over the group, times
    the scale (/ n with ``mean``); ef' = x - deq(q). Returns (reduced,
    ef')."""
    n = group.size
    red, new_ef = {}, {}
    for k, g in grads.items():
        x = g.to(torch.float32) + error_feedback[k]
        scale = torch.clamp(x.abs().max() / 127.0, min=1e-12)
        scale = _pmax(scale, group)
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        total = group.all_reduce(q.to(torch.int32))
        reduced = total.to(torch.float32) * scale
        if mean:
            reduced = reduced / n
        red[k] = reduced.to(g.dtype)
        new_ef[k] = x - _dequantize(q, scale)
    return red, new_ef


def wire_bytes_saved(grads: Tree) -> Tuple[int, int]:
    """(f32 bytes, int8 bytes) an all-reduce moves: the 4x headline."""
    f32 = sum(g.numel() * 4 for g in grads.values())
    return f32, f32 // 4
