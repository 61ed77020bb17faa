"""Hopper matrix product with an RMSNorm epilogue: build, bind and launch
``csrc/matmul_rmsnorm.cu``.

Built like the other kernels (:mod:`repro_torch.kernels.nvcc`: nvcc for
``sm_90a`` on first use, ``ctypes``). :func:`matmul_rmsnorm` checks its
inputs, picks the rows per CTA (:func:`block_rows`), allocates the output,
launches on PyTorch's current stream and raises on any CUDA error the launch
returns. ``launches`` counts the launches made.

Replaces ``repro/kernels/matmul_ln.py::_matmul_ln_kernel``; the note at the
top of the CUDA source says what bounds it and what the design does about
it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "matmul_rmsnorm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS = (64, 32, 16, 8, 4)      # the CTA row counts the source instantiates
_MAX_SMEM = 232448              # 227 KB, the most a CTA may opt in to
_SMS = 132                      # H100 SXM streaming multiprocessors

launches = 0        # kernel launches since the counter was last set to 0
_lib: Optional[ctypes.CDLL] = None


def smem_bytes(bm: int, n: int) -> int:
    """Dynamic shared memory of one CTA (the source's ``smem_bytes``): the
    (bm, n) f32 row accumulator, the transposed a stage (16 x (bm + 4)) and
    the b stage (16 x 4096/bm)."""
    return 4 * (bm * n + 16 * (bm + 4) + 16 * (4096 // bm))


MAX_N = (_MAX_SMEM - smem_bytes(4, 0)) // (4 * 4)   # 10400: a row of BM 4


def block_rows(m: int, n: int) -> int:
    """Rows per CTA: the most whose accumulator fits (so the fewest re-reads
    of b), no more than M needs, and fewer while that leaves SMs idle."""
    if n > MAX_N:
        raise ValueError(f"N = {n}: the kernel holds whole output rows in "
                         f"shared memory, which takes N <= {MAX_N}")
    bm = next(r for r in _ROWS if smem_bytes(r, n) <= _MAX_SMEM)
    while bm > 4 and bm // 2 >= m:
        bm //= 2
    while bm > 8 and -(-m // bm) < _SMS:
        bm //= 2
    return bm


def build() -> Path:
    """Compile the kernel unless this source's library already exists (see
    :func:`repro_torch.kernels.nvcc.build`)."""
    return nvcc.build(SOURCE)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.matmul_rmsnorm_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.matmul_rmsnorm_fwd.restype = ctypes.c_int
        lib.matmul_rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.matmul_rmsnorm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_layout(a: torch.Tensor, b: torch.Tensor,
                 scale: torch.Tensor) -> None:
    """The layouts the kernel takes, on every device: a (M, K) contiguous;
    b (K, N) with unit column stride and row stride >= N (a column slice of
    a wider row-major weight); scale (N,)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected a (M,K) and b (K,N); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if tuple(scale.shape) != (b.shape[1],):
        raise ValueError(f"scale must be (N,) = ({b.shape[1]},); got "
                         f"{tuple(scale.shape)}")
    if not a.is_contiguous():
        raise ValueError(f"a must be contiguous; got strides {a.stride()}")
    if b.shape[1] > 1 and b.stride(1) != 1 or \
            b.shape[0] > 1 and b.stride(0) < b.shape[1]:
        raise ValueError("b must have unit column stride and row stride >= "
                         f"N; got shape {tuple(b.shape)} strides {b.stride()}")


def _check(a, b, scale, out_dtype) -> None:
    check_layout(a, b, scale)
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1:
        raise ValueError(f"the kernel takes M, K, N >= 1; got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype \
            or out_dtype not in _DTYPES \
            or scale.dtype not in (torch.float32, a.dtype):
        raise TypeError(f"the kernel takes float32 or bfloat16 a, b of one "
                        f"type, scale in float32 or theirs, and a float32 or "
                        f"bfloat16 output; got {a.dtype}, {b.dtype}, "
                        f"{scale.dtype} -> {out_dtype}")
    if a.device.type != "cuda" or any(t.device != a.device
                                      for t in (b, scale)):
        raise ValueError("a, b and scale must lie on one CUDA device")


def matmul_rmsnorm(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, *,
                   eps: float = 1e-6,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the kernel: rmsnorm(a (M, K) @ b (K, N)) * (1 + scale) ->
    (M, N) in ``out_dtype`` (default a's type), all arithmetic in f32."""
    global launches
    out_dtype = a.dtype if out_dtype is None else out_dtype
    _check(a, b, scale, out_dtype)
    M, K = a.shape
    N = b.shape[1]
    ldb = b.stride(0) if K > 1 else N
    bm = block_rows(M, N)
    scale = scale.float().contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    lib = _load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.matmul_rmsnorm_fwd(
            a.data_ptr(), b.data_ptr(), scale.data_ptr(), out.data_ptr(), M,
            N, K, ldb, bm, float(eps), _DTYPES[a.dtype], _DTYPES[out_dtype],
            stream)
    if err:
        raise RuntimeError("matmul_rmsnorm launch failed: "
                           + lib.matmul_rmsnorm_error_string(err).decode())
    launches += 1
    return out
