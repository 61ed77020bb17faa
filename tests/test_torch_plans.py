"""The kernels' launch plans and build cache, on the CPU (no card, no nvcc).

``plan()`` is pure Python: it names the variant a call runs (``wgmma``,
``splitk``, ``splitkv`` or ``ffma``), its tile, cluster, split and shared
memory. These tests hold it at every shape the port's main paths give the
kernels (``chip_smoke.py``'s phase 6 ring GEMMs and attention cores, phase
7/8 MLA latent norms and prefill cores, phase 4/5 paged attention) and at
the TPU kernels' test sweeps, and hold the routing to the FFMA kernels for
f32, unaligned layouts, odd head dims and rows wider than a cluster. The
plans' limits are a Python copy of the CUDA sources' constants, so the
limit tests read the sources and hold the two copies equal. The build cache
test edits a header in a temporary copy of the sources."""
import importlib.util
import itertools
import re
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import hopper, nvcc  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import matmul_rmsnorm as mln  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BF16, F32 = torch.bfloat16, torch.float32


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
TP_SHAPES = {it: CS.tp_matmul_shapes(CS.get_tp_cfg(), it) for it in (2, 4)}
MLA_SHAPES = CS.mla_norm_shapes(CS.get_mla_cfg())
# phase 9's backward calls with a transposed operand: (M, K, N, layout)
TRAIN_SHAPES = CS.train_matmul_shapes(CS.get_tp_cfg())
# tests/test_kernels.py's sweeps (matmul (M, K, N); matmul_ln (M, K, N))
MM_SWEEP = [(128, 128, 128), (256, 512, 128), (64, 384, 96), (32, 32, 32),
            (512, 128, 256), (128, 1024, 64)]
MLN_SWEEP = [(128, 256, 128), (64, 512, 384), (256, 128, 64), (32, 64, 48),
             (128, 2048, 8192)]


def _fits(p) -> None:
    assert 0 <= p.smem <= hopper.MAX_SMEM
    assert p.ctas >= 1


@pytest.mark.parametrize("M,K,N", TP_SHAPES[2] + MM_SWEEP)
def test_matmul_plan_bf16_takes_wgmma_and_fills_the_card(M, K, N):
    p = mm.plan(M, N, K, N, BF16)
    assert p.variant == "wgmma"
    assert p.bm in hopper.TILES_M and p.bn in hopper.TILES_N
    assert p.grid == (hopper.cdiv(N, p.bn), hopper.cdiv(M, p.bm))
    assert p.smem == hopper.smem_bytes(p.bm, p.bn)
    _fits(p)
    # as many CTAs as the card holds in one wave, unless the smallest tile
    # cannot make them
    assert p.ctas >= min(128, hopper.cdiv(M, 64) * hopper.cdiv(N, 64))


@pytest.mark.parametrize("M,K,N", TP_SHAPES[4] + MM_SWEEP)
def test_matmul_plan_f32_takes_ffma(M, K, N):
    p = mm.plan(M, N, K, N, F32)
    assert p.variant == "ffma" and (p.bm, p.bn) == (64, 64)
    _fits(p)


def _train_strides(M, K, N, layout):
    """(lda, ldb) of a contiguous storage in ``layout``: aᵀ's (K, M) at M,
    bᵀ's (N, K) at K."""
    return (M if layout[0] == "t" else K), (K if layout[1] == "t" else N)


@pytest.mark.parametrize("M,K,N,layout", TRAIN_SHAPES)
def test_matmul_plan_backward_layouts(M, K, N, layout):
    """Every transposed call of phase 9's backward: bf16 on the wgmma
    mainloop in its layout, filling the card; f32 on the FFMA kernel."""
    assert layout in ("nt", "tn")
    lda, ldb = _train_strides(M, K, N, layout)
    p = mm.plan(M, N, K, ldb, BF16, layout=layout, lda=lda)
    assert p.variant == "wgmma" and p.layout == layout
    assert p.grid == (hopper.cdiv(N, p.bn), hopper.cdiv(M, p.bm))
    _fits(p)
    assert p.ctas >= min(128, hopper.cdiv(M, 64) * hopper.cdiv(N, 64))
    p32 = mm.plan(M, N, K, ldb, F32, layout=layout, lda=lda)
    assert p32.variant == "ffma" and p32.layout == layout
    # a storage row stride TMA cannot take sends bf16 to FFMA in any layout
    assert mm.plan(M, N, K, ldb, BF16, layout=layout,
                   lda=lda + 1 if layout[0] == "t" else lda,
                   ).variant == ("ffma" if layout[0] == "t" else "wgmma")
    with pytest.raises(ValueError, match="layout"):
        mm.plan(M, N, K, ldb, BF16, layout="xx")


def test_matmul_plan_tiles_and_routing():
    # the cais bf16 gate/up ring step: 128 x 256 would leave 64 CTAs, so
    # 128 x 128 (128 CTAs); the barrier GEMM is big enough for 128 x 256
    assert (mm.plan(1024, 2048, 2048, 2048, BF16).bm,
            mm.plan(1024, 2048, 2048, 2048, BF16).bn) == (128, 128)
    assert mm.plan(8192, 2048, 2048, 2048, BF16).bn == 256
    assert mm.plan(512, 2048, 2048, 2048, BF16).ctas >= 128
    # layouts TMA cannot take: K or N not a multiple of 8, a base off 16
    # bytes
    for M, K, N, aligned in ((300, 33, 256, True), (70, 200, 50, True),
                             (64, 200, 64, False), (1, 7, 5, True)):
        assert mm.plan(M, N, K, N, BF16, aligned=aligned).variant == "ffma"


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("M,K,N,ldb", MLA_SHAPES + [
    (192, 2560, 768, 768), (192, 2560, 256, 288), (2, 2560, 768, 768),
    (2, 2560, 256, 288)])
def test_matmul_rmsnorm_plan_main_path(M, K, N, ldb, dtype):
    """Phase 8's calls (bf16: decode M 4, prefill M 4096) and phase 7's
    (f32, 2 layers: decode M 2, prefill M 192)."""
    p = mln.plan(M, N, K, ldb, dtype)
    _fits(p)
    if M <= mln.SPLITK_MAX_ROWS:
        assert p.variant == "splitk"
        assert p.bm == min(r for r in mln.SPLITK_ROWS if r >= M)
        vec = 8 if dtype == BF16 else 4
        assert p.bn == 16 * vec and p.grid[0] == hopper.cdiv(N, p.bn)
        assert p.kslice % 16 == 0 and 16 <= p.kslice <= 256
        assert p.grid[1] == hopper.cdiv(K, p.kslice) <= 32
        # the grid covers most of the 132 SMs
        assert p.ctas >= 64
        assert p.grid[0] <= mln.SPLITK_MAX_BLOCKS and p.ctas <= hopper.SMS
        assert p.workspace == p.grid[1] * M * N + p.grid[0] * M
    elif dtype == BF16:
        assert p.variant == "wgmma"
        assert p.cluster == p.grid[0] == hopper.cdiv(N, p.bn) <= 8
        assert p.smem == hopper.smem_bytes(p.bm, p.bn)
    else:
        assert p.variant == "ffma"


def test_matmul_rmsnorm_plan_prefill_tiles():
    # the query latent: 3 CTAs of 256 columns a row, 96 CTAs; the KV latent
    # (N 256): 2 x 128 columns at 64 rows, 128 CTAs
    q = mln.plan(4096, 768, 2560, 768, BF16)
    assert (q.bm, q.bn, q.cluster, q.ctas) == (128, 256, 3, 96)
    kv = mln.plan(4096, 256, 2560, 288, BF16)
    assert (kv.bm, kv.bn, kv.cluster, kv.ctas) == (64, 128, 2, 128)


@pytest.mark.parametrize("M,K,N", MLN_SWEEP)
def test_matmul_rmsnorm_plan_tpu_sweep(M, K, N):
    bf, f = mln.plan(M, N, K, N, BF16), mln.plan(M, N, K, N, F32)
    _fits(bf)
    _fits(f)
    assert bf.variant == ("wgmma" if N <= mln.MAX_WGMMA_N else "ffma")
    assert f.variant == "ffma"


def test_matmul_rmsnorm_plan_routes_to_ffma():
    # f32 beyond decode rows
    assert mln.plan(17, 768, 2560, 768, F32).variant == "ffma"
    # an odd ldb: rows off 16 bytes, for decode rows and for many
    assert mln.plan(4, 64, 520, 65, BF16).variant == "ffma"
    assert mln.plan(40, 64, 520, 65, BF16).variant == "ffma"
    # f32 decode rows need ldb % 4; a base off 16 bytes
    assert mln.plan(4, 64, 520, 66, F32).variant == "ffma"
    assert mln.plan(4, 64, 520, 64, BF16, aligned=False).variant == "ffma"
    # N beyond a cluster (8 x 256)
    assert mln.plan(128, 2056, 2048, 2056, BF16).variant == "ffma"
    assert mln.plan(128, 2048, 2048, 2048, BF16).variant == "wgmma"
    # split-K takes at most 64 column blocks (its finishers wait for each
    # other); beyond, decode rows go to the FFMA kernel, which keeps MAX_N
    # and names it
    assert mln.plan(16, 8192, 64, 8192, BF16).variant == "splitk"
    assert mln.plan(16, 4096, 64, 4096, F32).variant == "splitk"
    assert mln.plan(16, 8200, 64, 8200, BF16).variant == "ffma"
    assert mln.plan(16, 4100, 64, 4100, F32).variant == "ffma"
    for M in (16, 17):
        with pytest.raises(ValueError, match=str(mln.MAX_N)):
            mln.plan(M, mln.MAX_N + 8, 64, mln.MAX_N + 8, BF16)
    # M at the split-K bound and one past it
    assert mln.plan(16, 768, 2560, 768, BF16).variant == "splitk"
    assert mln.plan(17, 768, 2560, 768, BF16).variant == "wgmma"


def test_library_path_keys_on_included_headers(tmp_path):
    src = tmp_path / "csrc"
    shutil.copytree(mln.SOURCE.parent, src)
    cu = src / mln.SOURCE.name
    header = src / "hopper_gemm.cuh"
    assert nvcc.includes(cu) == [header]
    before = nvcc.library_path(cu)
    assert before.name.startswith("libmatmul_rmsnorm_")
    assert nvcc.library_path(src / "flash_attention.cu") != before
    # an edit to the shared header changes the key of every source that
    # includes it (all three kernels), and of no other
    assert nvcc.includes(src / "flash_attention.cu") == [header]
    fa_before = nvcc.library_path(src / "flash_attention.cu")
    (src / "plain.cu").write_text("// includes nothing\n")
    plain_before = nvcc.library_path(src / "plain.cu")
    header.write_text(header.read_text() + "\n// edited\n")
    after = nvcc.library_path(cu)
    assert after != before and after.parent == before.parent
    assert nvcc.library_path(src / "flash_attention.cu") != fa_before
    assert nvcc.library_path(src / "plain.cu") == plain_before
    # a header reached through another header counts too
    (src / "inner.cuh").write_text("// v1\n")
    header.write_text(header.read_text() + '#include "inner.cuh"\n')
    assert nvcc.includes(cu) == [header, src / "inner.cuh"]
    k1 = nvcc.library_path(cu)
    (src / "inner.cuh").write_text("// v2\n")
    assert nvcc.library_path(cu) != k1


# ---------------------------------------------------------------------------
# the plans' limits against the CUDA sources'
# ---------------------------------------------------------------------------

CSRC = mln.SOURCE.parent


def _source(name: str) -> str:
    return (CSRC / name).read_text()


def _constants(name: str) -> dict:
    """A source's ``constexpr int kName = value;`` constants."""
    return {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", _source(name))}


def _c_return(name: str, signature: str):
    """The return expression of the function whose signature matches
    ``signature`` in a source, as a Python function of its names (the
    source's constants and the arguments given as keywords)."""
    body = _source(name)[re.search(signature, _source(name)).end():]
    expr = " ".join(re.match(r"[^{]*\{\s*return (.*?);", body, re.S)[1]
                    .split())
    for c, py in (("(size_t)", ""), ("sizeof(float)", "4"), ("/", "//"),
                  ("block_cols<BM>()", "(kTileElems // BM)"),
                  ("splitk_cols<TIn>()", "(kSkCols * kVec)")):
        expr = expr.replace(c, py)
    consts = _constants(name)
    return lambda **kw: eval(expr, {}, {**consts, **kw})


def _cases(name: str, function: str) -> set:
    """The ``case n:`` labels of one dispatch function of a source."""
    body = _source(name).split(f"cudaError_t {function}(")[1]
    body = body[:body.index("\n}\n")]
    return {int(n) for n in re.findall(r"case (\d+):", body)}


@pytest.mark.parametrize("value,source,c_value", [
    (hopper.BK, "hopper_gemm.cuh", lambda c: c["kBK"]),
    (hopper.STAGES, "hopper_gemm.cuh", lambda c: c["kStages"]),
    (hopper.MAX_CLUSTER, "hopper_gemm.cuh", lambda c: c["kMaxCluster"]),
    (hopper.MAX_SMEM, "matmul_rmsnorm.cu", lambda c: c["kMaxSmem"]),
    (mm._FFMA_TILE, "matmul.cu", lambda c: c["kBM"]),
    (mm._FFMA_TILE, "matmul.cu", lambda c: c["kBN"]),
    (mln.SPLITK_MAX_BLOCKS, "matmul_rmsnorm.cu", lambda c: c["kSkMaxBlocks"]),
    (mln._SK_COLS, "matmul_rmsnorm.cu", lambda c: c["kSkCols"]),
    (mln._SK_LANES, "matmul_rmsnorm.cu", lambda c: c["kSkLanes"]),
    (mln._SK_WARPS, "matmul_rmsnorm.cu", lambda c: c["kSkThreads"] // 32),
    (mln._SK_MAX_SLICE, "matmul_rmsnorm.cu", lambda c: c["kSkMaxSlice"]),
    (mln._SK_MAX_SPLITS, "matmul_rmsnorm.cu", lambda c: c["kSkBatch"]),
    (hopper.MAX_SMEM, "flash_attention.cu", lambda c: c["kMaxSmem"]),
    (fa.TILE_KEYS, "flash_attention.cu", lambda c: c["kTileKeys"]),
    (fa.FFMA_THREADS, "flash_attention.cu", lambda c: c["kThreads"]),
    (fa.FFMA_MAX_DH, "flash_attention.cu", lambda c: c["kFfmaMaxDh"]),
    (fa.WGMMA_BM, "flash_attention.cu", lambda c: c["kWgBM"]),
    (fa.WGMMA_STAGES, "flash_attention.cu", lambda c: c["kWgStages"]),
    (fa.WGMMA_THREADS, "flash_attention.cu", lambda c: c["kWgThreads"]),
    (fa.SPLIT_THREADS, "flash_attention.cu", lambda c: c["kSplitThreads"]),
    (fa.SPLIT_TILE_KEYS, "flash_attention.cu",
     lambda c: c["kSplitTileKeys"]),
    (fa.SPLIT_MAX_ROWS, "flash_attention.cu", lambda c: c["kSplitMaxRows"]),
    (fa.SPLIT_MAX_DH, "flash_attention.cu", lambda c: c["kSplitMaxDh"]),
    (fa.SPLIT_MAX_SPLITS, "flash_attention.cu",
     lambda c: c["kSplitMaxSplits"]),
], ids=["BK", "STAGES", "MAX_CLUSTER", "MAX_SMEM", "FFMA_BM", "FFMA_BN",
        "SPLITK_MAX_BLOCKS", "SK_COLS", "SK_LANES", "SK_WARPS",
        "SK_MAX_SLICE", "SK_MAX_SPLITS", "FA_MAX_SMEM", "FA_TILE_KEYS",
        "FA_FFMA_THREADS", "FA_FFMA_MAX_DH", "FA_WGMMA_BM",
        "FA_WGMMA_STAGES", "FA_WGMMA_THREADS", "FA_SPLIT_THREADS",
        "FA_SPLIT_TILE_KEYS", "FA_SPLIT_MAX_ROWS", "FA_SPLIT_MAX_DH",
        "FA_SPLIT_MAX_SPLITS"])
def test_plan_limits_match_the_cuda_sources(value, source, c_value):
    assert value == c_value(_constants(source))


def test_plan_tiles_are_the_instantiated_ones():
    """Every tile, row count and row bound a plan can name has an
    instantiation in the sources to launch (and no other exists)."""
    tiles = {tuple(map(int, t)) for t in re.findall(
        r"HOPPER_TILE\((\d+), (\d+)\)\n", _source("hopper_gemm.cuh"))}
    assert tiles == set(itertools.product(hopper.TILES_M, hopper.TILES_N))
    assert _cases("matmul_rmsnorm.cu", "dispatch_ffma") == set(mln._ROWS)
    assert _cases("matmul_rmsnorm.cu", "dispatch_splitk") == \
        set(mln.SPLITK_ROWS)
    flash = {tuple(map(int, t)) for t in re.findall(
        r"FLASH_WGMMA_TILE\((\d+), (\d+), (\d+)\)\n",
        _source("flash_attention.cu"))}
    assert flash == {(dh, dv, bn) for (dh, dv), bn in fa.WGMMA_TILES.items()}
    assert _cases("flash_attention.cu", "dispatch_ffma_rows") == \
        set(fa.FFMA_ROWS)
    assert _cases("flash_attention.cu", "dispatch_splitkv") == \
        set(fa.SPLIT_ROWS)


def test_plan_shared_memory_matches_the_cuda_sources():
    """The plans' shared memory is the launchers': the mainloop's stages,
    the FFMA kernel's row accumulator and stages, the split-K strip."""
    gemm = _c_return("hopper_gemm.cuh", r"constexpr int smem_bytes\(")
    for bm, bn in itertools.product(hopper.TILES_M, hopper.TILES_N):
        assert hopper.smem_bytes(bm, bn) == gemm(bm=bm, bn=bn)
    ffma = _c_return("matmul_rmsnorm.cu", r"size_t smem_bytes\(int N\)")
    for bm, n in itertools.product(mln._ROWS, (1, 48, 768, mln.MAX_N)):
        assert mln.smem_bytes(bm, n) == ffma(BM=bm, N=n)
    assert mln.smem_bytes(4, mln.MAX_N) <= hopper.MAX_SMEM \
        < mln.smem_bytes(4, mln.MAX_N + 1)
    splitk = _c_return("matmul_rmsnorm.cu",
                       r"size_t splitk_smem\(int kslice\)")
    for M, K, N, ldb in MLA_SHAPES + [(16, 4096, 8192, 8192), (1, 48, 48, 48)]:
        for dtype, vec in ((BF16, 8), (F32, 4)):
            p = mln.plan(M, N, K, ldb, dtype)
            if p.variant == "splitk":
                assert p.smem == splitk(MT=p.bm, kslice=p.kslice, kVec=vec)


def test_flash_plan_smem_and_workspace_match_the_cuda_source():
    """The flash plans' shared memory and split-KV workspace are the
    launchers': each variant's ``*_smem`` and ``splitkv_workspace``."""
    src = "flash_attention.cu"
    ffma = _c_return(src, r"size_t ffma_smem\(int rows, int dh\)")
    for rows, dh in itertools.product(fa.FFMA_ROWS, (16, 36, 256, 512)):
        assert fa.ffma_smem(rows, dh) == ffma(rows=rows, dh=dh)
    assert fa.ffma_smem(32, fa.FFMA_MAX_DH) <= hopper.MAX_SMEM
    wg = _c_return(src, r"constexpr int wgmma_smem\(")
    for (dh, dv), bn in fa.WGMMA_TILES.items():
        assert fa.wgmma_smem(dh, dv, bn) == wg(dh=dh, dv=dv, bn=bn) \
            <= hopper.MAX_SMEM
    split = _c_return(src, r"size_t splitkv_smem\(int rows, int dh, int dv, "
                           r"int es\)")
    ws = _c_return(src, r"constexpr long splitkv_workspace\(")
    for rows, es in itertools.product(fa.SPLIT_ROWS, (2, 4)):
        for dh, dv in ((256, 256), (128, 64), (16, 16)):
            assert fa.splitkv_smem(rows, dh, dv, es) == \
                split(rows=rows, dh=dh, dv=dv, es=es) <= hopper.MAX_SMEM
    for nrec, dv in ((1, 4), (48, 256), (7, 64)):
        assert fa.splitkv_workspace(nrec, dv) == ws(nrec=nrec, dv=dv)


# ---------------------------------------------------------------------------
# flash attention's plans at the main paths' call shapes
# ---------------------------------------------------------------------------

def _flash_main_path():
    """(B, Sq, Skv, H, Hkv, dh, dv) of every flash call of the main paths,
    with the variant each must take in bf16 and in f32: the paged decode
    and prefill chunk of gemma3-1b (phases 3-5), the TP attention core of
    internlm2-1.8b with 1 and 2 microbatches (phase 6), the MLA prefill
    core of minicpm3-4b (phases 7-8), the TPU kernel's own cases
    (phase 3)."""
    from repro_torch.configs import get_arch

    gem, tp, mla = get_arch(CS.ARCH), CS.get_tp_cfg(), CS.get_mla_cfg()
    skv, dh = CS.serving_skv(), gem.resolved_head_dim
    paged = dict(H=gem.num_heads, Hkv=gem.num_kv_heads, dh=dh, dv=dh)
    tdh = tp.resolved_head_dim
    core = dict(H=tp.num_heads // CS.TP_WORLD, Hkv=tp.num_kv_heads
                // CS.TP_WORLD, dh=tdh, dv=tdh)
    m = mla.mla
    mdh = m.qk_nope_head_dim + m.qk_rope_head_dim
    return [
        ("decode", dict(B=CS.REQUESTS, Sq=1, Skv=skv, **paged),
         "splitkv", "splitkv"),
        ("prefill_chunk", dict(B=CS.REQUESTS, Sq=CS.PREFILL_CHUNK, Skv=skv,
                               **paged), "wgmma", "ffma"),
        ("tp_core_mb2", dict(B=CS.TP_BATCH // 2, Sq=CS.TP_SEQ,
                             Skv=CS.TP_SEQ, **core), "wgmma", "ffma"),
        ("tp_core_mb1", dict(B=CS.TP_BATCH, Sq=CS.TP_SEQ, Skv=CS.TP_SEQ,
                             **core), "wgmma", "ffma"),
        ("mla_prefill", dict(B=CS.MLA_REQUESTS, Sq=CS.MLA_PROMPT,
                             Skv=CS.MLA_PROMPT, H=mla.num_heads,
                             Hkv=mla.num_heads, dh=mdh, dv=m.v_head_dim),
         "wgmma", "ffma"),
        ("tpu_8x512", dict(B=8, Sq=512, Skv=512, H=1, Hkv=1, dh=128,
                           dv=128), "wgmma", "ffma"),
        ("tpu_16x2048", dict(B=16, Sq=2048, Skv=2048, H=1, Hkv=1, dh=128,
                             dv=128), "wgmma", "ffma"),
    ]


FLASH_MAIN = _flash_main_path()


def _flash_plan(c, dtype, **kw):
    return fa.plan(c["B"], c["Sq"], c["Skv"], c["H"], c["Hkv"], c["dh"],
                   c["dv"], dtype, **kw)


def test_flash_main_path_shapes_are_the_models():
    """The widths of the main paths as the configs give them: gemma3-1b 4
    query heads on 1 kv head at 256; a TP rank's 4 / 2 heads at 128; MLA 40
    heads at 96 / 64."""
    got = {name: (c["H"], c["Hkv"], c["dh"], c["dv"])
           for name, c, _, _ in FLASH_MAIN}
    assert got["decode"] == got["prefill_chunk"] == (4, 1, 256, 256)
    assert got["tp_core_mb2"] == (4, 2, 128, 128)
    assert got["mla_prefill"] == (40, 40, 96, 64)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("name,c,bf16,f32", FLASH_MAIN,
                         ids=[f[0] for f in FLASH_MAIN])
def test_flash_plan_main_path(name, c, bf16, f32, dtype):
    p = _flash_plan(c, dtype)
    assert p.variant == (bf16 if dtype == BF16 else f32)
    _fits(p)
    G = c["H"] // c["Hkv"]
    if p.variant == "wgmma":
        bn = fa.WGMMA_TILES[c["dh"], c["dv"]]
        assert p.tile == (fa.WGMMA_BM, bn) and p.splits == 1
        assert p.grid == (c["H"], c["B"], hopper.cdiv(c["Sq"], fa.WGMMA_BM))
        assert p.smem == fa.wgmma_smem(c["dh"], c["dv"], bn)
        # gemma's dh 256 takes the narrow key tile: O alone is 128 f32
        # registers a thread
        assert bn == (64 if c["dh"] == 256 else 128)
    elif p.variant == "splitkv":
        rows = c["Sq"] * G
        assert p.tile == (min(r for r in fa.SPLIT_ROWS if r >= rows),
                          fa.SPLIT_TILE_KEYS)
        assert p.kchunk % fa.SPLIT_TILE_KEYS == 0
        assert p.kchunk >= fa.SPLIT_MIN_TILES * fa.SPLIT_TILE_KEYS
        assert p.splits == hopper.cdiv(c["Skv"], p.kchunk) > 1
        assert p.grid == (p.splits, c["Hkv"], c["B"])
        # the decode grid covers many SMs (the first slice's kernel had
        # B * Hkv = 4 CTAs) but no more than the card holds in one wave
        assert 32 <= p.ctas <= hopper.SMS
        nrec = c["B"] * c["Hkv"] * p.splits * rows
        assert p.workspace == fa.splitkv_workspace(nrec, c["dv"])
        es = 2 if dtype == BF16 else 4
        assert p.smem == fa.splitkv_smem(p.tile[0], c["dh"], c["dv"], es)
    else:
        rows = c["Sq"] * G
        assert p.tile[0] in fa.FFMA_ROWS and p.splits == 1
        assert p.grid == (hopper.cdiv(rows, p.tile[0]), c["Hkv"], c["B"])
        assert p.smem == fa.ffma_smem(p.tile[0], c["dh"])


def test_flash_plan_decode_splits():
    # gemma3-1b decode: 720 keys, 4 rows of one kv head -> 23 ranges of one
    # 32-key tile, 92 CTAs
    p = fa.plan(4, 1, 720, 4, 1, 256, 256, BF16)
    assert (p.splits, p.kchunk, p.ctas) == (23, 32, 92)
    # a short context is one range, and needs no workspace
    p = fa.plan(4, 1, 32, 4, 1, 256, 256, BF16)
    assert (p.variant, p.splits, p.workspace) == ("splitkv", 1, 0)
    assert fa.plan(4, 1, 33, 4, 1, 256, 256, BF16).splits == 2
    # a batch that fills the SMs alone takes one range a CTA
    assert fa.plan(132, 1, 4096, 8, 1, 128, 128, BF16).splits == 1
    # a long context stops at the split cap
    p = fa.plan(1, 1, 1 << 20, 4, 1, 128, 128, BF16)
    assert p.splits <= fa.SPLIT_MAX_SPLITS
    assert p.splits * p.kchunk >= 1 << 20
    # at the row bound and one past it
    assert fa.plan(1, 4, 720, 16, 4, 128, 128, BF16).variant == "splitkv"
    assert fa.plan(1, 4, 720, 16, 4, 128, 128, BF16).tile[0] == 16
    assert fa.plan(1, 5, 720, 16, 4, 128, 128, BF16).variant == "wgmma"
    assert fa.plan(1, 5, 720, 16, 4, 128, 128, F32).variant == "ffma"


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_flash_plan_routes_to_ffma(dtype):
    # f32 prefill: full f32, no TF32
    assert fa.plan(1, 4096, 4096, 4, 2, 128, 128, F32).variant == "ffma"
    # dh 36 (and the CUDA tests' dh 16 beyond decode rows), prefill and
    # decode: not 16-byte vectors in bf16, not an instantiated pair
    assert fa.plan(2, 7, 45, 4, 2, 36, 36, BF16).variant == "ffma"
    assert fa.plan(2, 1, 45, 4, 2, 36, 36, BF16).variant == "ffma"
    assert fa.plan(3, 40, 16, 2, 2, 16, 16, dtype).variant == "ffma"
    # dh beyond 256: no wgmma pair, beyond split-KV's registers
    for Sq in (1, 300):
        assert fa.plan(2, Sq, 300, 4, 2, 320, 320, dtype).variant == "ffma"
        assert fa.plan(2, Sq, 300, 4, 2, 512, 512, dtype).variant == "ffma"
    # a base off 16 bytes, for decode rows as for many
    for Sq in (1, 300):
        assert fa.plan(2, Sq, 300, 4, 1, 256, 256, dtype,
                       aligned=False).variant == "ffma"
    # a (dh, dv) pair the wgmma variant is not built for
    assert fa.plan(2, 300, 300, 4, 4, 64, 64, dtype).variant == "ffma"
    with pytest.raises(ValueError, match=str(fa.FFMA_MAX_DH)):
        fa.plan(2, 300, 300, 4, 4, 520, 520, dtype)
