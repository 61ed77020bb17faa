"""Hopper flash attention: build, bind and launch ``csrc/flash_attention.cu``.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface on first use (never at import; see
:mod:`repro_torch.kernels.nvcc`); ``ctypes`` loads it.
:func:`flash_attention` checks its inputs, takes the variant :func:`plan`
names (``wgmma``: the TMA + wgmma bf16 forward; ``splitkv``: decode rows,
the keys split over CTAs; ``ffma``: f32 prefill and the layouts the others
cannot take), allocates the output (the split-KV workspace is kept per
stream), launches once on PyTorch's current stream and raises on any CUDA
error the launch returns. ``launches`` counts the launches made,
``launches_by_variant`` the same by variant.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel``; the note at the
top of the CUDA source says what bounds each variant and what its design
does about it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import hopper, nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"splitkv": 2, "wgmma": 1, "ffma": 0}  # name -> the source's number
# The source's limits, mirrored for the plans; tests/test_torch_plans.py
# holds the two copies equal.
TILE_KEYS = 32              # ffma: keys a K/V tile (kTileKeys)
FFMA_THREADS = 128          # kThreads
FFMA_ROWS = (4, 16, 32)     # query rows a CTA: 32, 8 or 4 lanes a row
FFMA_MAX_DH = 512           # kFfmaMaxDh
WGMMA_BM = 128              # kWgBM: two consumer warpgroups of 64 rows
WGMMA_STAGES = 2            # kWgStages
WGMMA_THREADS = 384         # kWgThreads
# the instantiated (dh, dv) pairs and their key tile (FLASH_WGMMA_TILE)
WGMMA_TILES = {(256, 256): 64, (128, 128): 128, (96, 64): 128}
SPLIT_THREADS = 128         # kSplitThreads
SPLIT_TILE_KEYS = 32        # kSplitTileKeys
SPLIT_ROWS = (4, 16)        # the row bounds splitkv instantiates
SPLIT_MAX_ROWS = SPLIT_ROWS[-1]   # kSplitMaxRows: Sq * G of a kv head
SPLIT_MAX_DH = 256          # kSplitMaxDh
SPLIT_MAX_SPLITS = 64       # kSplitMaxSplits
# the plan's own choice, the fewest tiles a split holds: at decode lengths
# more CTAs in flight beat a longer double-buffered stream per CTA (PERF.md);
# long contexts reach SPLIT_MAX_SPLITS and stream several tiles a range
SPLIT_MIN_TILES = 1

launches = 0        # kernel launches since the counter was last set to 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)
_lib: Optional[ctypes.CDLL] = None
# the split-KV workspace of each (device, stream): f32 partials and int32
# tickets, made once and grown; each launch leaves its tickets 0 (the CUDA
# source's reset), so a call needs no zeroing launch. Keyed by stream, since
# two launches running at once must not share them.
_work: Dict[Tuple[int, int], torch.Tensor] = {}
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


@dataclass(frozen=True)
class Plan:
    """One call's kernel. ``tile``: (query rows, keys) a CTA takes at a
    time -- ffma (rows a CTA, 32), wgmma (128, BN), splitkv (the row bound
    4 or 16, 32); ``splits``: key ranges a (b, kv head) (splitkv; else 1)
    of ``kchunk`` keys each; ``grid``: the launch grid (x, y, z); ``smem``:
    a CTA's dynamic shared memory in bytes; ``workspace``: f32 elements of
    the split-KV partials (0 if none)."""
    variant: str
    tile: Tuple[int, int]
    splits: int
    grid: Tuple[int, int, int]
    smem: int
    kchunk: int = 0
    workspace: int = 0

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def ffma_smem(rows: int, dh: int) -> int:
    """The source's ``ffma_smem``: q, a K and a V tile in f32 at row stride
    dh + 4, the P tile, the positions."""
    return (4 * (rows * (dh + 4) + 2 * TILE_KEYS * (dh + 4)
                 + rows * (TILE_KEYS + 1)) + 4 * (rows + TILE_KEYS))


def wgmma_smem(dh: int, dv: int, bn: int) -> int:
    """The source's ``wgmma_smem``: the Q tile and the K/V stages in 64-column
    bf16 boxes, plus 1 KB of alignment."""
    return (2 * 64 * (hopper.cdiv(dh, 64) * (WGMMA_BM + WGMMA_STAGES * bn)
                      + hopper.cdiv(dv, 64) * WGMMA_STAGES * bn) + 1024)


def splitkv_smem(rows: int, dh: int, dv: int, es: int) -> int:
    """The source's ``splitkv_smem``: two K and V tiles in the input type,
    q in f32, the P tile, the positions."""
    return (es * 2 * SPLIT_TILE_KEYS * (dh + dv + 2 * (16 // es))
            + 4 * (rows * (dh + 4) + rows * (SPLIT_TILE_KEYS + 1) + rows
                   + 2 * SPLIT_TILE_KEYS))


def splitkv_workspace(nrec: int, dv: int) -> int:
    """The source's ``splitkv_workspace``: f32 (m, l) of ``nrec`` partial
    rows, then from a 16-byte boundary acc[dv] of each."""
    return (2 * nrec + 3) // 4 * 4 + nrec * dv


def _splits(B: int, Skv: int, Hkv: int) -> Tuple[int, int]:
    """(splits, kchunk): enough key ranges that the (splits, Hkv, B) grid
    covers the SMs, each at least SPLIT_MIN_TILES tiles, a whole number of
    tiles, at most SPLIT_MAX_SPLITS."""
    tk = SPLIT_TILE_KEYS
    want = min(hopper.cdiv(Skv, SPLIT_MIN_TILES * tk),
               max(1, hopper.SMS // (B * Hkv)), SPLIT_MAX_SPLITS)
    kchunk = tk * hopper.cdiv(hopper.cdiv(Skv, want), tk)
    return hopper.cdiv(Skv, kchunk), kchunk


@functools.lru_cache(maxsize=4096)
def plan(B: int, Sq: int, Skv: int, H: int, Hkv: int, dh: int, dv: int,
         dtype: torch.dtype, aligned: bool = True) -> Plan:
    """The variant of a call: q (B, Sq, H, dh), k (B, Skv, Hkv, dh), v (B,
    Skv, Hkv, dv) of ``dtype``, ``aligned`` if q, k and v all start on 16
    bytes.

    - splitkv: Sq * G <= 16 query rows a kv head (decode), dh and dv <= 256
      in 16-byte vectors (multiples of 8 in bf16, 4 in f32), bf16 or f32;
    - wgmma: bf16 with more rows and (dh, dv) an instantiated pair;
    - ffma: the rest (f32 prefill, dh not a multiple of 8, dh > 256, other
      pairs, bases off 16 bytes); raises beyond dh = ``FFMA_MAX_DH``.
    """
    G = H // Hkv
    rows = Sq * G
    es = 2 if dtype == torch.bfloat16 else 4
    vec = 16 // es
    if rows <= SPLIT_MAX_ROWS and aligned and dh % vec == 0 \
            and dv % vec == 0 and dh <= SPLIT_MAX_DH:
        bound = next(r for r in SPLIT_ROWS if r >= rows)
        splits, kchunk = _splits(B, Skv, Hkv)
        nrec = B * Hkv * splits * rows
        return Plan("splitkv", (bound, SPLIT_TILE_KEYS), splits,
                    (splits, Hkv, B), splitkv_smem(bound, dh, dv, es),
                    kchunk=kchunk,
                    workspace=splitkv_workspace(nrec, dv) if splits > 1
                    else 0)
    if dtype == torch.bfloat16 and aligned and (dh, dv) in WGMMA_TILES:
        bn = WGMMA_TILES[dh, dv]
        return Plan("wgmma", (WGMMA_BM, bn), 1,
                    (H, B, hopper.cdiv(Sq, WGMMA_BM)), wgmma_smem(dh, dv, bn))
    if dh % 4 or dh > FFMA_MAX_DH:
        raise ValueError(f"head dim {dh}: the kernel takes multiples of 4 up "
                         f"to {FFMA_MAX_DH}")
    r = next((x for x in FFMA_ROWS if x >= rows), FFMA_ROWS[-1])
    return Plan("ffma", (r, TILE_KEYS), 1, (hopper.cdiv(rows, r), Hkv, B),
                ffma_smem(r, dh))


def build() -> Path:
    """Compile the kernel unless this source's library already exists (see
    :func:`repro_torch.kernels.nvcc.build`)."""
    return nvcc.build(SOURCE)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
            + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
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
    if dh % 4 or dh > FFMA_MAX_DH or v.shape[3] % 4:
        raise ValueError(f"head dims {dh}, {v.shape[3]}: the kernel takes "
                         f"multiples of 4 up to {FFMA_MAX_DH}")
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
    if any(t.data_ptr() % (4 * q.element_size()) for t in (q, k, v)):
        raise ValueError(f"q, k, v must be {4 * q.element_size()}-byte "
                         "aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """Launch the kernel: q (B,Sq,H,dh), k (B,Skv,Hkv,dh), v (B,Skv,Hkv,dv)
    with dv <= dh on one CUDA device, int32 positions (−1 = masked key),
    the mask of :func:`repro_torch.kernels.ref.visible` (``prefix_len``:
    the prefix-LM prefix, 0 for none). Returns (B,Sq,H,dv) in q's type; a
    row with no visible key holds zeros.

    The wgmma and splitkv variants take v at its own dv. The ffma kernel
    takes v at dh: a narrower v (MLA's value dim 64 under a query/key dim
    96) is zero-padded to dh there, and the zero columns give zero output
    columns, which are cut off again (the result is then a view with row
    stride dh)."""
    global launches
    _check(q, k, v, q_positions, kv_positions)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return flash_attention(q, k, v, q_positions=q_positions,
                                   kv_positions=kv_positions, causal=causal,
                                   window=window, scale=scale,
                                   prefix_len=prefix_len)
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    dv = v.shape[3]
    p = plan(B, Sq, Skv, H, Hkv, dh, dv, q.dtype,
             aligned=not (q.data_ptr() % 16 or k.data_ptr() % 16
                          or v.data_ptr() % 16))
    pad = p.variant == "ffma" and dv < dh
    if pad:
        v = torch.nn.functional.pad(v, (0, dh - dv))
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    out = torch.empty((B, Sq, H, dh if pad else dv), dtype=q.dtype,
                      device=q.device)
    lib = _load()
    stream = torch.cuda.current_stream().cuda_stream
    work = tickets = None
    if p.workspace:
        key = (q.device.index, stream)
        work = _grown(_work, key, p.workspace, lambda n: torch.empty(
            n, dtype=torch.float32, device=q.device)).data_ptr()
        tickets = _grown(_tickets, key, B * Hkv, lambda n: torch.zeros(
            max(n, 256), dtype=torch.int32, device=q.device)).data_ptr()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        kv_positions.data_ptr(), out.data_ptr(), work, tickets, B, Sq, Skv,
        H, Hkv, dh, dh if pad else dv, int(causal), int(window),
        int(prefix_len), scale,
        VARIANTS[p.variant], p.tile[0] if p.variant != "wgmma" else p.tile[1],
        p.kchunk, _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed ({p}): "
                           + lib.flash_attention_error_string(err).decode())
    launches += 1
    launches_by_variant[p.variant] += 1
    return out[..., :dv] if pad else out
