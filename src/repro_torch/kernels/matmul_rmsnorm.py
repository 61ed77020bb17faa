"""Hopper matrix product with an RMSNorm epilogue: build, bind and launch
``csrc/matmul_rmsnorm.cu``.

Built like the other kernels (:mod:`repro_torch.kernels.nvcc`: nvcc for
``sm_90a`` on first use, ``ctypes``). :func:`matmul_rmsnorm` checks its
inputs, takes the variant :func:`plan` names (``splitk`` for decode rows,
``wgmma`` for many bf16 rows in a cluster, ``ffma`` for the rest),
allocates the output (the split-K workspace is kept per stream), launches
once on PyTorch's current stream and raises on any CUDA error the launch
returns.
``launches`` counts the launches made, ``launches_by_variant`` the same by
variant.

Replaces ``repro/kernels/matmul_ln.py::_matmul_ln_kernel``; the note at the
top of the CUDA source says what bounds each variant and what its design
does about it.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import hopper, nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "matmul_rmsnorm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"splitk": 2, "wgmma": 1, "ffma": 0}  # name -> the source's number
_ROWS = (64, 32, 16, 8, 4)      # the CTA row counts the FFMA kernel has
# splitk: the source's row bounds, threads along N and along K, warps, and
# deepest K slice; the plan's cap on the slices a column block sums at its
# end (one batch of loads in flight). tests/test_torch_plans.py holds these,
# MAX_SMEM and the tiles against the CUDA sources' own constants.
SPLITK_ROWS = (4, 8, 16)
SPLITK_MAX_ROWS = SPLITK_ROWS[-1]
_SK_COLS, _SK_LANES, _SK_WARPS, _SK_MAX_SLICE, _SK_MAX_SPLITS = \
    16, 16, 8, 256, 32
# column blocks a split-K call may have: its finishers wait for each other,
# which is safe while they are fewer than the SMs
SPLITK_MAX_BLOCKS = 64

launches = 0        # kernel launches since the counter was last set to 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)
_lib: Optional[ctypes.CDLL] = None
# the split-K scratch of each (device, stream): f32 partials and int32
# tickets. Made once, so a call allocates nothing but its output; each
# launch leaves the tickets 0 (the CUDA source's reset), so a call needs no
# zeroing launch. Keyed by stream, since two launches running at once must
# not share them; launches on one stream run in order.
_work: Dict[Tuple[int, int], torch.Tensor] = {}
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def smem_bytes(bm: int, n: int) -> int:
    """Dynamic shared memory of one FFMA CTA (the source's ``smem_bytes``):
    the (bm, n) f32 row accumulator, the transposed a stage (16 x (bm + 4))
    and the b stage (16 x 4096/bm)."""
    return 4 * (bm * n + 16 * (bm + 4) + 16 * (4096 // bm))


MAX_N = (hopper.MAX_SMEM - smem_bytes(4, 0)) // (4 * 4)   # 10400: BM 4
# the widest row the wgmma variant's cluster holds
MAX_WGMMA_N = hopper.MAX_CLUSTER * max(hopper.TILES_N)


@dataclass(frozen=True)
class Plan:
    """One call's kernel. ``bm``: rows a CTA (ffma, wgmma) or the row bound
    the source instantiates (splitk); ``bn``: columns a CTA (ffma: its
    column chunk); ``cluster``: CTAs a row (wgmma); ``kslice``: K depth a
    CTA (splitk); ``grid``: CTAs (along N, along M or K); ``smem``: a CTA's
    dynamic shared memory in bytes; ``workspace``: f32 elements of the
    split-K partials and row sums."""
    variant: str
    bm: int
    bn: int
    grid: Tuple[int, int]
    smem: int
    cluster: int = 1
    kslice: int = 0
    workspace: int = 0

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


def _ffma_rows(m: int, n: int) -> int:
    """The FFMA kernel's rows a CTA: the most whose accumulator fits (so the
    fewest re-reads of b), no more than M needs, and fewer while that leaves
    SMs idle."""
    if n > MAX_N:
        raise ValueError(f"N = {n}: the FFMA kernel holds whole output rows "
                         f"in shared memory, which takes N <= {MAX_N}")
    bm = next(r for r in _ROWS if smem_bytes(r, n) <= hopper.MAX_SMEM)
    while bm > 4 and bm // 2 >= m:
        bm //= 2
    while bm > 8 and -(-m // bm) < hopper.SMS:
        bm //= 2
    return bm


@functools.lru_cache(maxsize=4096)
def plan(M: int, N: int, K: int, ldb: int, dtype: torch.dtype, *,
         aligned: bool = True) -> Plan:
    """The variant of a call: a (M, K) @ b (K, N) at row stride ``ldb``,
    inputs of ``dtype``, ``aligned`` if both bases lie on 16 bytes.

    - splitk: M <= 16 (decode) and b's rows in 16-byte loads (N and ldb
      multiples of 8 in bf16, 4 in f32); column blocks of 16 loads (at most
      64 of them), K split into slices (a multiple of 16 deep, at most 256)
      so that the grid covers the SMs, at most 32 slices a block.
    - wgmma: bf16 in a layout TMA takes and N <= 2048, whole rows in one
      cluster of ceil(N / BN) CTAs; the tile by :func:`hopper.pick_tile`.
    - ffma: the rest; raises beyond N = ``MAX_N``.
    """
    es = 2 if dtype == torch.bfloat16 else 4
    vec = 16 // es
    bn = _SK_COLS * vec
    nb = hopper.cdiv(N, bn)
    if M <= SPLITK_MAX_ROWS and aligned and N % vec == 0 and ldb % vec == 0 \
            and nb <= SPLITK_MAX_BLOCKS:
        mt = next(r for r in SPLITK_ROWS if r >= M)
        target = min(_SK_MAX_SPLITS, hopper.cdiv(hopper.SMS, nb))
        kslice = min(_SK_MAX_SLICE,
                     _SK_LANES * hopper.cdiv(K, target * _SK_LANES))
        splits = hopper.cdiv(K, kslice)
        return Plan("splitk", mt, bn, (nb, splits),
                    4 * mt * (kslice + _SK_WARPS * bn), kslice=kslice,
                    workspace=splits * M * N + nb * M)
    if dtype == torch.bfloat16 and hopper.tma_ok(K, ldb, aligned) \
            and N <= MAX_WGMMA_N:
        bm, bn = hopper.pick_tile(M, N, max_cluster=hopper.MAX_CLUSTER)
        cl = hopper.cdiv(N, bn)
        return Plan("wgmma", bm, bn, (cl, hopper.cdiv(M, bm)),
                    hopper.smem_bytes(bm, bn), cluster=cl)
    bm = _ffma_rows(M, N)
    return Plan("ffma", bm, 4096 // bm, (1, hopper.cdiv(M, bm)),
                smem_bytes(bm, N))


def build() -> Path:
    """Compile the kernel unless this source's library already exists (see
    :func:`repro_torch.kernels.nvcc.build`)."""
    return nvcc.build(SOURCE)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.matmul_rmsnorm_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.matmul_rmsnorm_fwd.restype = ctypes.c_int
        lib.matmul_rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.matmul_rmsnorm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _grown(cache: Dict[Tuple[int, int], torch.Tensor], key: Tuple[int, int],
           n: int, make) -> torch.Tensor:
    """The buffer ``cache`` holds for ``key``, made by ``make(n)`` the first
    time and again only to grow."""
    t = cache.get(key)
    if t is None or t.numel() < n:
        t = cache[key] = make(n)
    return t


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
    (M, N) in ``out_dtype`` (default a's type), sums and the norm in f32."""
    global launches
    out_dtype = a.dtype if out_dtype is None else out_dtype
    _check(a, b, scale, out_dtype)
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):
            return matmul_rmsnorm(a, b, scale, eps=eps, out_dtype=out_dtype)
    M, K = a.shape
    N = b.shape[1]
    ldb = b.stride(0) if K > 1 else N
    p = plan(M, N, K, ldb, a.dtype,
             aligned=a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    if scale.dtype != torch.float32 or scale.stride(0) != 1:
        scale = scale.float().contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    lib = _load()
    stream = torch.cuda.current_stream().cuda_stream
    work = tickets = None
    if p.variant == "splitk":
        key = (a.device.index, stream)
        work = _grown(_work, key, p.workspace, lambda n: torch.empty(
            n, dtype=torch.float32, device=a.device)).data_ptr()
        tickets = _grown(_tickets, key, p.grid[0] + 2, lambda n: torch.zeros(
            max(n, 256), dtype=torch.int32, device=a.device)).data_ptr()
    err = lib.matmul_rmsnorm_fwd(
        a.data_ptr(), b.data_ptr(), scale.data_ptr(), out.data_ptr(), work,
        tickets, M, N, K, ldb, VARIANTS[p.variant], p.bm, p.bn, p.cluster,
        p.kslice, float(eps), _DTYPES[a.dtype], _DTYPES[out_dtype], stream)
    if err:
        raise RuntimeError(f"matmul_rmsnorm launch failed ({p}): "
                           + lib.matmul_rmsnorm_error_string(err).decode())
    launches += 1
    launches_by_variant[p.variant] += 1
    return out
