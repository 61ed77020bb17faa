"""Hopper matrix product: build, bind and launch ``csrc/matmul.cu``.

Built like the flash-attention kernel (:mod:`repro_torch.kernels.nvcc`:
nvcc for ``sm_90a`` on first use, ``ctypes``). :func:`matmul` checks its
inputs, allocates the output, launches on PyTorch's current stream and raises
on any CUDA error the launch returns. ``launches`` counts the launches made.

Replaces ``repro/kernels/matmul.py::_matmul_kernel``; the note at the top of
the CUDA source says what bounds it and what the design does about it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "matmul.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 65535 * 64          # the grid's y extent times the CTA's rows

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
        lib.matmul_fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                                   + [ctypes.c_void_p])
        lib.matmul_fwd.restype = ctypes.c_int
        lib.matmul_error_string.argtypes = [ctypes.c_int]
        lib.matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected a (M,K) and b (K,N); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1 \
            or a.shape[0] > _MAX_ROWS:
        raise ValueError(f"the kernel takes 1 <= M <= {_MAX_ROWS} and K, N "
                         f">= 1; got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype \
            or out_dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16 a, b of one "
                        f"type and a float32 or bfloat16 output; got "
                        f"{a.dtype}, {b.dtype} -> {out_dtype}")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("a and b must lie on one CUDA device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the kernel takes contiguous row-major a and b")


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the kernel: a (M, K) @ b (K, N) -> (M, N) in ``out_dtype``
    (default a's type), all arithmetic in f32."""
    global launches
    out_dtype = a.dtype if out_dtype is None else out_dtype
    _check(a, b, out_dtype)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    lib = _load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.matmul_fwd(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N,
                             K, _DTYPES[a.dtype], _DTYPES[out_dtype], stream)
    if err:
        raise RuntimeError("matmul launch failed: "
                           + lib.matmul_error_string(err).decode())
    launches += 1
    return out
