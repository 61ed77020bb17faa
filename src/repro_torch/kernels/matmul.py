"""Hopper matrix product: build, bind and launch ``csrc/matmul.cu``.

Built like the flash-attention kernel (:mod:`repro_torch.kernels.nvcc`:
nvcc for ``sm_90a`` on first use, ``ctypes``). :func:`matmul` checks its
inputs, takes the variant and tile :func:`plan` names (``wgmma``: the shared
TMA + wgmma bf16 mainloop; ``ffma``: f32 on the CUDA cores, and bf16
layouts TMA cannot take), allocates the output, launches once on PyTorch's
current stream and raises on any CUDA error the launch returns.
``launches`` counts the launches made, ``launches_by_variant`` the same by
variant and layout (``"wgmma.nn"``, ``"ffma.nt"``, ...; :func:`layout`).

Each operand may be the transpose of a contiguous tensor, passed as the
strided view it is: aᵀ (M-major, the backward's xᵀ of dw = xᵀ·dy) and bᵀ
(K-major, the backward's wᵀ of dx = dy·wᵀ). Both variants read it where it
lies; no call copies or transposes an operand.

Replaces ``repro/kernels/matmul.py::_matmul_kernel``; the note at the top of
the CUDA source says what bounds it and what the design does about it.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import hopper, nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "matmul.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"wgmma": 1, "ffma": 0}   # name -> the source's variant number
# operand layouts: a then b, "n" as it lies row-major, "t" the transpose of
# a contiguous tensor (BLAS's naming)
LAYOUTS = ("nn", "tn", "nt", "tt")
COUNTERS = tuple(f"{v}.{lay}" for v in VARIANTS for lay in LAYOUTS)
_FFMA_TILE = 64                  # the FFMA kernel's 64 x 64 output tile
_MAX_ROWS = 65535 * 64          # the grid's y extent times the CTA's rows

launches = 0        # kernel launches since the counter was last set to 0
launches_by_variant = dict.fromkeys(COUNTERS, 0)
_lib: Optional[ctypes.CDLL] = None


@dataclass(frozen=True)
class Plan:
    """One call's kernel: the variant, its output tile (BM x BN), its grid
    (CTAs along N, along M), a CTA's dynamic shared memory in bytes and the
    operands' layout (:data:`LAYOUTS`)."""
    variant: str
    bm: int
    bn: int
    grid: Tuple[int, int]
    smem: int
    layout: str = "nn"

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


@functools.lru_cache(maxsize=4096)
def plan(M: int, N: int, K: int, ldb: int, dtype: torch.dtype, *,
         aligned: bool = True, layout: str = "nn",
         lda: Optional[int] = None) -> Plan:
    """The variant and tile of a (M, K) @ (K, N) call in ``layout``
    (:data:`LAYOUTS`), inputs of ``dtype``, ``aligned`` if both bases lie on
    16 bytes. ``lda`` and ``ldb`` are the row strides of a's and b's
    storage: a (M, K) at K (the default), or aᵀ's (K, M) at M; b (K, N) at
    N, or bᵀ's (N, K) at K. bf16 in a layout TMA takes runs the wgmma
    mainloop in every layout, tiled by :func:`hopper.pick_tile` to fill the
    SMs; f32 (no TF32: parity needs full f32) and any other bf16 layout run
    the FFMA kernel."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is none of {LAYOUTS}")
    lda = K if lda is None else lda
    if dtype == torch.bfloat16 and hopper.tma_ok(lda, ldb, aligned):
        bm, bn = hopper.pick_tile(M, N)
        return Plan("wgmma", bm, bn, (hopper.cdiv(N, bn), hopper.cdiv(M, bm)),
                    hopper.smem_bytes(bm, bn), layout)
    t = _FFMA_TILE
    return Plan("ffma", t, t, (hopper.cdiv(N, t), hopper.cdiv(M, t)), 0,
                layout)


def transposed(x: torch.Tensor) -> bool:
    """Whether 2-D ``x`` is the transpose of a contiguous tensor and not
    contiguous itself: the one strided operand the kernel takes."""
    return not x.is_contiguous() and x.T.is_contiguous()


def layout(a: torch.Tensor, b: torch.Tensor) -> str:
    """The :data:`LAYOUTS` name of operands ``a``, ``b``; raises on any
    other non-contiguous operand (a copy would hide a transposing pass)."""
    for name, x in (("a", a), ("b", b)):
        if x.dim() != 2 or not (x.is_contiguous() or transposed(x)):
            raise ValueError(
                f"matmul takes 2-D operands that are contiguous or the "
                f"transpose of a contiguous tensor; got {name} of shape "
                f"{tuple(x.shape)} and strides {tuple(x.stride())}")
    return ("t" if transposed(a) else "n") + ("t" if transposed(b) else "n")


def row_strides(a: torch.Tensor, b: torch.Tensor) -> Tuple[str, int, int]:
    """(layout, lda, ldb): the row strides of a's and b's storage as the
    kernel reads it: K and N row-major; a transposed a's storage is (K, M),
    a transposed b's (N, K), each at the view's column stride."""
    lay = layout(a, b)
    K, N = a.shape[1], b.shape[1]
    return (lay, a.stride(1) if lay[0] == "t" else K,
            b.stride(1) if lay[1] == "t" else N)


def build() -> Path:
    """Compile the kernel unless this source's library already exists (see
    :func:`repro_torch.kernels.nvcc.build`)."""
    return nvcc.build(SOURCE)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.matmul_fwd.argtypes = ([ctypes.c_void_p] * 3
                                   + [ctypes.c_int] * 12 + [ctypes.c_void_p])
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
    layout(a, b)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the kernel: a (M, K) @ b (K, N) -> (M, N) in ``out_dtype``
    (default a's type), products in the input type, sums in f32. Either
    operand may be the transpose of a contiguous tensor (:func:`layout`)."""
    global launches
    out_dtype = a.dtype if out_dtype is None else out_dtype
    _check(a, b, out_dtype)
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):
            return matmul(a, b, out_dtype=out_dtype)
    M, K = a.shape
    N = b.shape[1]
    lay, lda, ldb = row_strides(a, b)
    ta, tb = lay[0] == "t", lay[1] == "t"
    p = plan(M, N, K, ldb, a.dtype,
             aligned=a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0,
             layout=lay, lda=lda)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    lib = _load()
    err = lib.matmul_fwd(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                         lda, ldb, int(ta), int(tb), VARIANTS[p.variant],
                         p.bm, p.bn, _DTYPES[a.dtype], _DTYPES[out_dtype],
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"matmul launch failed ({p}): "
                           + lib.matmul_error_string(err).decode())
    launches += 1
    launches_by_variant[f"{p.variant}.{lay}"] += 1
    return out


def variant_totals(counts=None) -> dict:
    """``launches_by_variant`` (or ``counts``) summed over the layouts:
    launches by variant."""
    counts = launches_by_variant if counts is None else counts
    return {v: sum(n for k, n in counts.items() if k.split(".")[0] == v)
            for v in VARIANTS}
