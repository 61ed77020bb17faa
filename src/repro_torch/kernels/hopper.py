"""The Python side of ``csrc/hopper_gemm.cuh``, the bf16 TMA + wgmma
mainloop that the matmul and matmul_rmsnorm kernels share: what layouts it
takes, what shared memory a tile needs, and which tile a call's shape gets.
Pure Python, so the CPU tests hold the plans the card will run."""
from __future__ import annotations

from typing import Optional, Tuple

# The header's and the sources' limits, mirrored here for the plans;
# tests/test_torch_plans.py holds the two copies equal.
SMS = 132                 # H100 SXM streaming multiprocessors
MAX_SMEM = 232448         # 227 KB, the most a CTA may opt in to
STAGES, BK = 4, 64        # the header's kStages, kBK
MAX_CLUSTER = 8           # the portable cluster limit
TILES_M = (128, 64)       # one or two consumer warpgroups of 64 rows
TILES_N = (256, 128, 64)  # wgmma m64nBNk16, fed by 64-column TMA boxes
# The cost model's operations per byte for one SM: its share of the bf16
# wgmma rate (989 TF/s / 132) over its share of L2 bandwidth (about
# 64 B/clock at 1.7 GHz), so a tile's K step costs
# max(2·BM·BN / this, 2·(BM + BN)).
_SM_OPS_PER_BYTE = 68


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(bm: int, bn: int) -> int:
    """Dynamic shared memory of one CTA: the stages of a (BM x 64) and b
    (64 x BN) in bf16, plus 1 KB to align them to the swizzle's period."""
    return STAGES * (bm + bn) * BK * 2 + 1024


def tma_ok(lda: int, ldb: int, aligned: bool = True) -> bool:
    """TMA takes a 16-byte aligned base and row strides of 16-byte multiples:
    bf16 operands whose storages have row strides lda and ldb (K and N for
    a row-major a (M, K) and b (K, N); M and K for aᵀ and bᵀ) need
    lda % 8 == 0 and ldb % 8 == 0 (``aligned``: both bases on 16 bytes)."""
    return aligned and lda % 8 == 0 and ldb % 8 == 0


def _tile_cost(bm: int, bn: int) -> float:
    """Relative time of one K step of a BM x BN tile on one SM."""
    return max(2 * bm * bn / _SM_OPS_PER_BYTE, 2 * (bm + bn))


def pick_tile(M: int, N: int,
              max_cluster: Optional[int] = None) -> Tuple[int, int]:
    """The (BM, BN) with the least waves x tile cost over the 132 SMs (ties to
    the larger tile, then the wider BN). With ``max_cluster``, only tiles
    whose ceil(N / BN) CTAs fit one cluster, so that a cluster holds whole
    rows."""
    best = None
    for bm in TILES_M:
        for bn in TILES_N:
            grid_n = cdiv(N, bn)
            if max_cluster is not None and grid_n > max_cluster:
                continue
            waves = cdiv(grid_n * cdiv(M, bm), SMS)
            key = (waves * _tile_cost(bm, bn), -bm * bn, -bn)
            if best is None or key < best[0]:
                best = (key, (bm, bn))
    if best is None:
        raise ValueError(f"N = {N}: no tile fits {max_cluster} CTAs a row")
    return best[1]
