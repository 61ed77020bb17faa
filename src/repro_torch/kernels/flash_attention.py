"""Hopper flash attention: build, bind and launch ``csrc/flash_attention.cu``.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface on first use (never at import; see
:mod:`repro_torch.kernels.nvcc`); ``ctypes`` loads it.
:func:`flash_attention` checks its inputs, allocates the output, launches on
PyTorch's current stream and raises on any CUDA error the launch returns.
``launches`` counts the launches made.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel``; the note at the
top of the CUDA source says what bounds it and what the design does about it.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0        # kernel launches since the counter was last set to 0
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile the kernel unless this source's library already exists (see
    :func:`repro_torch.kernels.nvcc.build`)."""
    return nvcc.build(SOURCE)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v, q_positions, kv_positions) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3] or not 1 <= v.shape[3] <= k.shape[3]:
        raise ValueError("expected q (B,Sq,H,dh), k (B,Skv,Hkv,dh) and v "
                         "(B,Skv,Hkv,dv) with dv <= dh; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, dhk = k.shape
    if k.shape[0] != B or dhk != dh or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if dh % 4 or dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh}: the kernel takes multiples of 4 up "
                         f"to {MAX_HEAD_DIM}")
    if tuple(q_positions.shape) != (B, Sq) \
            or tuple(kv_positions.shape) != (B, Skv):
        raise ValueError("positions must be (B,Sq) and (B,Skv)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q/k/v of one "
                        f"type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q_positions.dtype != torch.int32 or kv_positions.dtype != torch.int32:
        raise TypeError("positions must be int32")
    ts = (q, k, v, q_positions, kv_positions)
    if any(t.device != q.device for t in ts) or q.device.type != "cuda":
        raise ValueError("all inputs must lie on one CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel: q (B,Sq,H,dh), k (B,Skv,Hkv,dh), v (B,Skv,Hkv,dv)
    with dv <= dh on one CUDA device, int32 positions (−1 = masked key).
    Returns (B,Sq,H,dv) in q's type; a row with no visible key holds zeros.

    The kernel takes v at the head dim of q and k: a narrower v (MLA's
    value dim 64 under a query/key dim 96) is zero-padded to dh, and the
    zero columns give zero output columns, which are cut off again (the
    result is then a view with row stride dh)."""
    global launches
    _check(q, k, v, q_positions, kv_positions)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    dv = v.shape[3]
    if dv < dh:
        v = torch.nn.functional.pad(v, (0, dh - dv))
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    out = torch.empty_like(q)
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), out.data_ptr(), B, Sq, Skv, H, Hkv, dh,
            int(causal), int(window), scale, _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    launches += 1
    return out if dv == dh else out[..., :dv]
