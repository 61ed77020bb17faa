"""The Hopper kernels (flash attention, matmul, matmul_rmsnorm) against
their plain PyTorch versions, on the card. Every test here needs an NVIDIA GPU with nvcc; on a
machine without one they skip. Run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import matmul_rmsnorm as mln  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# the kernel and its plain version both compute in f32 from the same inputs:
# f32 within tests/test_kernels.py's TOL; bf16 within one rounding of the
# output (one bf16 step is at most |x|/128)
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-4),
       torch.bfloat16: dict(rtol=1 / 128, atol=2e-3)}
# flash attention's wgmma variant rounds each probability to bf16 before
# p @ v (as JAX's model does): at most 2^-8 p, so an output element moves by
# at most 2^-8 sum_j p_j |v_j| / l, added to TOL on that variant only
# (chip_smoke.py ``P_ROUNDING``)
P_ROUNDING = 2.0 ** -8

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def paged_case(dev, dtype, *, B, Sq, Skv, H, Hkv, dh, ctx, q0, seed=0):
    """Inputs shaped as attention_paged gives them: row b's new tokens sit at
    positions q0[b].. (−1 past its chunk), keys at 0..ctx[b]-1 (−1 after);
    ctx 0 is a padding row."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
    q, k, v = mk(B, Sq, H, dh), mk(B, Skv, Hkv, dh), mk(B, Skv, Hkv, dh)
    qpos = torch.full((B, Sq), -1, dtype=torch.int32)
    kpos = torch.full((B, Skv), -1, dtype=torch.int32)
    for b in range(B):
        n = min(Sq, ctx[b] - q0[b]) if ctx[b] else 0
        qpos[b, :n] = torch.arange(q0[b], q0[b] + n)
        kpos[b, :ctx[b]] = torch.arange(ctx[b])
    return q, k, v, qpos.to(dev), kpos.to(dev)


def flash_variant(q, k, v):
    return fa.plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                   k.shape[2], q.shape[3], v.shape[3], q.dtype).variant


def assert_flash_close(got, q, k, v, kw):
    """The kernel against attention_ref: TOL of the type, plus the bf16
    rounding of p on the wgmma variant; a row with no visible key (a padding
    query under the causal mask) exactly zeros."""
    want = ref.attention_ref(q, k, v, **kw).float()
    tol = TOL[q.dtype]
    limit = tol["atol"] + tol["rtol"] * want.abs()
    if flash_variant(q, k, v) == "wgmma":
        limit = limit + P_ROUNDING * ref.attention_ref(q, k, v.abs(),
                                                       **kw).float()
    err = (got.float() - want).abs()
    assert bool((err <= limit).all()), \
        f"max |err| {float(err.max()):.3e}, worst err/limit " \
        f"{float((err / limit).max()):.3f}"
    assert torch.isfinite(got).all()
    seen = ref.visible(kw["q_positions"], kw["kv_positions"],
                       causal=kw.get("causal", True),
                       window=kw.get("window", 0),
                       prefix_len=kw.get("prefix_len", 0)).any(-1)
    assert not (~seen).all()
    assert torch.count_nonzero(got[~seen]) == 0   # no visible key: zeros


# the prefix-LM mask (paligemma-3b's training core) and the non-causal one
# (whisper-tiny's encoder and cross-attention) in each variant: (variant,
# B, Sq, Skv, H, Hkv, dh, dtype, causal, prefix_len, window, decode query
# positions or None for positions 0..Sq-1). The wgmma cases put the prefix
# inside a 128-row tile, so a tile's rows straddle it; the split-KV cases
# put the queries inside the prefix, where keys past them are visible
MASK_CASES = [
    ("wgmma", 2, 300, 300, 8, 1, 256, torch.bfloat16, True, 100, 0, None),
    ("wgmma", 2, 300, 300, 8, 1, 256, torch.bfloat16, True, 100, 40, None),
    ("wgmma", 1, 260, 260, 4, 2, 128, torch.bfloat16, True, 260, 0, None),
    ("wgmma", 2, 200, 333, 4, 2, 128, torch.bfloat16, False, 0, 0, None),
    ("ffma", 2, 300, 300, 8, 1, 256, torch.float32, True, 100, 0, None),
    ("ffma", 2, 300, 300, 8, 1, 256, torch.float32, True, 100, 40, None),
    ("ffma", 2, 150, 150, 6, 6, 64, torch.bfloat16, False, 0, 0, None),
    ("ffma", 2, 37, 150, 6, 6, 64, torch.float32, False, 0, 0, None),
    ("splitkv", 2, 1, 300, 8, 1, 256, torch.bfloat16, True, 100, 0,
     [40, 99]),
    ("splitkv", 2, 1, 300, 8, 1, 256, torch.float32, True, 100, 0,
     [40, 150]),
    ("splitkv", 2, 1, 1500, 6, 6, 64, torch.float32, False, 0, 0, [0, 0]),
    ("splitkv", 4, 1, 1500, 6, 6, 64, torch.bfloat16, False, 0, 0,
     [0, 0, 0, 0]),
]


@pytest.mark.parametrize("case", range(len(MASK_CASES)))
def test_flash_prefix_and_non_causal_masks(dev, case):
    (variant, B, Sq, Skv, H, Hkv, dh, dtype, causal, prefix, window,
     q0) = MASK_CASES[case]
    g = torch.Generator(device="cpu").manual_seed(100 + case)
    mk = lambda h, s_: torch.randn(B, s_, h, dh, generator=g).to(dev, dtype)
    q, k, v = mk(H, Sq), mk(Hkv, Skv), mk(Hkv, Skv)
    kpos = torch.arange(Skv, dtype=torch.int32).expand(B, Skv).contiguous()
    qpos = (torch.arange(Sq, dtype=torch.int32).expand(B, Sq).contiguous()
            if q0 is None else torch.tensor(q0, dtype=torch.int32)[:, None])
    kw = dict(q_positions=qpos.to(dev), kv_positions=kpos.to(dev),
              causal=causal, window=window, prefix_len=prefix)
    assert flash_variant(q, k, v) == variant
    before = dict(fa.launches_by_variant)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches_by_variant[variant] == before[variant] + 1
    assert_flash_close(got, q, k, v, kw)
    if causal and prefix and q0 is None:
        # the prefix changes the result: a query inside it sees keys past
        # its own position
        plain = fa.flash_attention(q, k, v, **dict(kw, prefix_len=0))
        assert not torch.equal(plain[:, :prefix - 1], got[:, :prefix - 1])
        torch.testing.assert_close(plain[:, prefix:], got[:, prefix:],
                                   rtol=0, atol=0)


def test_flash_rejects_a_negative_prefix(dev):
    q = torch.zeros(1, 4, 1, 16, device=dev)
    pos = torch.arange(4, dtype=torch.int32, device=dev)[None]
    with pytest.raises(ValueError, match="prefix_len"):
        fa.flash_attention(q, q, q, q_positions=pos, kv_positions=pos,
                           prefix_len=-1)


CASES = {
    # gemma3-1b at serving: G=4, dh=256, Skv past the 512 window, one padding
    # row; decode (S=1) and a 128-token prefill chunk
    "decode": dict(B=4, Sq=1, Skv=720, H=4, Hkv=1, dh=256,
                   ctx=[700, 650, 0, 601], q0=[699, 649, 0, 600]),
    "prefill": dict(B=4, Sq=128, Skv=720, H=4, Hkv=1, dh=256,
                    ctx=[700, 128, 0, 650], q0=[572, 0, 0, 576]),
    # Sq != Skv, G=2, a head dim that is not a multiple of 16, ragged tiles
    "gqa_ragged": dict(B=2, Sq=7, Skv=45, H=4, Hkv=2, dh=36,
                       ctx=[40, 45], q0=[33, 38]),
    "mha_small": dict(B=3, Sq=5, Skv=16, H=2, Hkv=2, dh=16,
                      ctx=[16, 3, 9], q0=[11, 0, 4]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 512, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_paged_inputs(dev, case, window, dtype):
    q, k, v, qpos, kpos = paged_case(dev, dtype, **CASES[case])
    kw = dict(q_positions=qpos, kv_positions=kpos, causal=True, window=window)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_flash_close(got, q, k, v, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,d", [(2, 128, 64), (4, 256, 32),
                                    (1, 512, 128), (2, 300, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_tpu_case(dev, BH, S, d, dtype, causal):
    g = torch.Generator(device="cpu").manual_seed(S + d)
    q, k, v = (torch.randn(BH, S, d, generator=g).to(dev, dtype)
               for _ in range(3))
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(BH, S)
    kw = dict(q_positions=pos.contiguous(), kv_positions=pos.contiguous(),
              causal=causal)
    q4, k4, v4 = q[:, :, None], k[:, :, None], v[:, :, None]
    got = fa.flash_attention(q4, k4, v4, **kw)
    torch.cuda.synchronize()
    assert_flash_close(got, q4, k4, v4, kw)


def test_ops_dispatch_counts_launches_and_rejects(dev):
    q, k, v, qpos, kpos = paged_case(dev, torch.bfloat16, **CASES["decode"])
    before = fa.launches
    ops.flash_attention(q, k, v, q_positions=qpos, kv_positions=kpos)
    assert fa.launches == before + 1
    with pytest.raises(ValueError):      # not contiguous: raise, no fallback
        ops.flash_attention(q, k.transpose(0, 1).contiguous().transpose(0, 1),
                            v, q_positions=qpos, kv_positions=kpos)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), v.half(), q_positions=qpos,
                            kv_positions=kpos)
    assert fa.launches == before + 1


# tests/test_kernels.py's matmul sweep, and the ring-step shapes of the
# tensor-parallel internlm2-1.8b run in chip_smoke.py (B 2, S 4096, 4 ranks)
MATMUL_SHAPES = [(128, 128, 128), (256, 512, 128), (64, 384, 96),
                 (32, 32, 32), (512, 128, 256), (128, 1024, 64),
                 (512, 2048, 2048), (512, 2048, 256), (1024, 512, 2048),
                 (1024, 2048, 2048), (1, 7, 5), (65, 33, 130)]


def assert_matmul_close(got, want, a, b):
    """TOL of the output type plus twice the probabilistic bound on one f32
    summation of the K products, sqrt(K)·2^-24·(|a| @ |b|): the kernel and
    the plain version sum in different orders (chip_smoke.py
    ``matmul_tol``)."""
    tol = TOL[got.dtype]
    mag = a.float().abs() @ b.float().abs()
    limit = (tol["atol"] + tol["rtol"] * want.float().abs()
             + 2 * a.shape[1] ** 0.5 * 2.0 ** -24 * mag)
    err = (got.float() - want.float()).abs()
    assert bool((err <= limit).all()), \
        f"max |err| {float(err.max()):.3e}, worst err/limit " \
        f"{float((err / limit).max()):.3f}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", MATMUL_SHAPES)
def test_matmul_kernel_matches_plain(dev, M, K, N, dtype):
    g = torch.Generator(device="cpu").manual_seed(M * K + N)
    a = torch.randn(M, K, generator=g).to(dev, dtype)
    b = torch.randn(K, N, generator=g).to(dev, dtype)
    got = mm.matmul(a, b)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, N)
    assert_matmul_close(got, ref.matmul_ref(a, b), a, b)


# serving over a TP ring of 4 (chip_smoke.py phase 10), on one rank: the
# decode rows (M = 4), a ragged mixed step (4 x 127), a prefill chunk
# (4 x 128) and the cais gemm_ar ring's partials (64 rows), for
# internlm2-1.8b (q 512, kv 256, ff 2048 columns a rank; d 2048) and
# gemma3-1b (q and kv 256, ff 1728; d 1152)
SERVE_TP_SHAPES = [(4, 2048, 512), (4, 2048, 256), (4, 2048, 2048),
                   (4, 512, 2048), (508, 2048, 512), (508, 512, 2048),
                   (512, 2048, 256), (64, 512, 2048), (64, 2048, 2048),
                   (4, 1152, 256), (4, 1152, 1728), (4, 1728, 1152),
                   (508, 1152, 1728), (64, 256, 1152)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", SERVE_TP_SHAPES)
def test_matmul_serving_ring_shapes(dev, M, K, N, dtype):
    g = torch.Generator(device="cpu").manual_seed(M * K + N)
    a = torch.randn(M, K, generator=g).to(dev, dtype)
    b = torch.randn(K, N, generator=g).to(dev, dtype)
    before = dict(mm.launches_by_variant)
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    variant = "wgmma" if dtype == torch.bfloat16 else "ffma"
    assert mm.launches_by_variant[f"{variant}.nn"] == \
        before[f"{variant}.nn"] + 1
    assert_matmul_close(got, ref.matmul_ref(a, b), a, b)


# the rank-local attention cores of serving over a ring of 4: internlm2's
# 4 q / 2 kv heads at dh 128, and gemma3-1b's 1 q head over its one
# replicated kv head at dh 256 under the 512 window
RING_CASES = {
    "tp_decode": dict(B=4, Sq=1, Skv=720, H=4, Hkv=2, dh=128,
                      ctx=[700, 650, 0, 613], q0=[699, 649, 0, 612]),
    "tp_prefill": dict(B=4, Sq=128, Skv=720, H=4, Hkv=2, dh=128,
                       ctx=[700, 128, 0, 640], q0=[640, 0, 0, 512]),
    "tp_mixed": dict(B=4, Sq=127, Skv=720, H=4, Hkv=2, dh=128,
                     ctx=[257, 257, 383, 383], q0=[256, 256, 256, 256]),
    "repl_decode": dict(B=4, Sq=1, Skv=720, H=1, Hkv=1, dh=256,
                        ctx=[700, 650, 0, 613], q0=[699, 649, 0, 612]),
    "repl_mixed": dict(B=4, Sq=127, Skv=720, H=1, Hkv=1, dh=256,
                       ctx=[513, 513, 639, 639], q0=[512, 512, 512, 512]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_kernel_matches_plain_at_ring_serving_shapes(dev, case, dtype):
    c = RING_CASES[case]
    q, k, v, qpos, kpos = paged_case(dev, dtype, **c)
    kw = dict(q_positions=qpos, kv_positions=kpos, causal=True,
              window=512 if case.startswith("repl") else 0)
    want = {1: "splitkv"}.get(c["Sq"], "wgmma" if dtype == torch.bfloat16
                              else "ffma")
    assert flash_variant(q, k, v) == want
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_flash_close(got, q, k, v, kw)


def test_flash_refuses_a_strided_head_slice(dev):
    """A replicated kv head sliced to a rank's heads is a strided view: the
    kernel refuses it, and the contiguous copy the TP core makes runs."""
    q, k, v, qpos, kpos = paged_case(dev, torch.bfloat16, B=4, Sq=1,
                                     Skv=720, H=1, Hkv=2, dh=256,
                                     ctx=[700, 650, 0, 613],
                                     q0=[699, 649, 0, 612])
    ks, vs = k[:, :, 1:2], v[:, :, 1:2]
    kw = dict(q_positions=qpos, kv_positions=kpos, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q, ks, vs, **kw)
    ks, vs = ks.contiguous(), vs.contiguous()
    got = ops.flash_attention(q, ks, vs, **kw)
    torch.cuda.synchronize()
    assert_flash_close(got, q, ks, vs, kw)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_matmul_out_dtype(dev, out_dtype):
    g = torch.Generator(device="cpu").manual_seed(5)
    a = torch.randn(96, 200, generator=g).to(dev, torch.bfloat16)
    b = torch.randn(200, 72, generator=g).to(dev, torch.bfloat16)
    got = mm.matmul(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype
    assert_matmul_close(got, ref.matmul_ref(a, b, out_dtype), a, b)


def test_matmul_dispatch_counts_launches_and_rejects(dev):
    a = torch.randn(64, 32, device=dev)
    b = torch.randn(32, 16, device=dev)
    before = mm.launches
    ops.matmul(a, b)
    assert mm.launches == before + 1
    with pytest.raises(ValueError):      # strided: raise, no fallback
        ops.matmul(a[:, ::2], b[:16])
    with pytest.raises(TypeError):
        ops.matmul(a.half(), b.half())
    with pytest.raises(TypeError):
        mm.matmul(a, b.bfloat16())
    assert mm.launches == before + 1


# transposed operands, as the backward passes them: aᵀ (xᵀ of dw = xᵀ·dy)
# and bᵀ (wᵀ of dx = dy·wᵀ), read where they lie, in every variant
LAYOUT_SHAPES = [(1, 7, 5), (65, 33, 130), (64, 64, 64), (130, 72, 200),
                 (200, 520, 72), (512, 2048, 256), (2048, 1024, 512)]


def layout_case(dev, M, K, N, dtype, layout, seed=0):
    """a (M, K), b (K, N) of ``dtype`` in ``layout``: "t" stores the operand
    transposed (aᵀ's storage is (K, M), bᵀ's (N, K))."""
    g = torch.Generator(device="cpu").manual_seed(seed + M * K + N)
    a = torch.randn(M, K, generator=g).to(dev, dtype)
    b = torch.randn(K, N, generator=g).to(dev, dtype)
    if layout[0] == "t":
        a = a.T.contiguous().T
    if layout[1] == "t":
        b = b.T.contiguous().T
    return a, b


@pytest.mark.parametrize("layout", ["tn", "nt", "tt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", LAYOUT_SHAPES)
def test_matmul_transposed_layouts(dev, M, K, N, dtype, layout):
    a, b = layout_case(dev, M, K, N, dtype, layout)
    if min(M, K, N) > 1:
        assert mm.layout(a, b) == layout
    layout = mm.layout(a, b)      # a size-1 operand is contiguous either way
    ta, tb = layout[0] == "t", layout[1] == "t"
    p = mm.plan(M, N, K, b.stride(1) if tb else N, dtype,
                aligned=a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0,
                layout=layout, lda=a.stride(1) if ta else K)
    before = dict(mm.launches_by_variant)
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    delta = {k: n - before[k] for k, n in mm.launches_by_variant.items()
             if n != before[k]}
    assert delta == {f"{p.variant}.{layout}": 1}
    if dtype == torch.float32:
        assert p.variant == "ffma"            # full f32, no TF32
    elif M % 8 == 0 and K % 8 == 0 and N % 8 == 0:
        assert p.variant == "wgmma"
    assert got.shape == (M, N) and got.dtype == dtype
    assert_matmul_close(got, ref.matmul_ref(a, b), a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_matches_torch_math(dev, dtype):
    """The differentiable attention core on the card: the forward is the
    kernel (one launch), the backward the VJP of the plain version."""
    g = torch.Generator(device="cpu").manual_seed(11)
    B, S, H, Hkv, dh = 2, 192, 4, 2, 128
    mk = lambda h: torch.randn(B, S, h, dh, generator=g).to(dev, dtype)
    q, k, v = mk(H), mk(Hkv), mk(Hkv)
    pos = torch.arange(S, dtype=torch.int32,
                       device=dev).expand(B, S).contiguous()
    kw = dict(q_positions=pos, kv_positions=pos, causal=True)
    gy = torch.randn(B, S, H, dh, generator=g).to(dev, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa.launches
    out = ops.flash_attention(*leaves, **kw)
    assert fa.launches == before + 1
    out.backward(gy)
    assert fa.launches == before + 1          # the backward is torch math
    want = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.attention_ref(*want, **kw).backward(gy)
    torch.cuda.synchronize()
    # the same torch math on the same inputs: equal up to the library's
    # choice of reduction order
    for got_t, want_t in zip(leaves, want):
        torch.testing.assert_close(got_t.grad.float(), want_t.grad.float(),
                                   rtol=1e-5, atol=1e-5)
    assert_flash_close(out.detach(), q, k, v, dict(kw, window=0))


# flash attention with a value head dim below the query/key dim: MLA's
# prefill core (dh 96 = 64 + 32, dv 64), and a ragged small case
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,dh,dv", [(2, 70, 3, 96, 64),
                                         (1, 33, 2, 36, 8)])
def test_flash_value_dim_below_head_dim(dev, B, S, H, dh, dv, dtype):
    g = torch.Generator(device="cpu").manual_seed(S + dv)
    q, k = (torch.randn(B, S, H, dh, generator=g).to(dev, dtype)
            for _ in range(2))
    v = torch.randn(B, S, H, dv, generator=g).to(dev, dtype)
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    kw = dict(q_positions=pos.contiguous(), kv_positions=pos.contiguous(),
              causal=True)
    before = fa.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.shape == (B, S, H, dv)
    assert_flash_close(got, q, k, v, kw)


# matmul_rmsnorm (M, K, N, ldb): tests/test_kernels.py's sweep and its
# model-norm case, the MLA latent norms of minicpm3-4b as chip_smoke.py
# serves it (prefill M 4096 and decode M 4; the KV latent's b a column
# slice of wkv_a, row stride 288), the TPU kernel's N 8192, ragged edges
MLN_SHAPES = [(128, 256, 128, 128), (64, 512, 384, 384), (256, 128, 64, 64),
              (32, 64, 48, 48), (4096, 2560, 768, 768),
              (4096, 2560, 256, 288), (4, 2560, 768, 768),
              (4, 2560, 256, 288), (128, 2048, 8192, 8192), (1, 7, 5, 9),
              (65, 33, 130, 130), (300, 100, mln.MAX_N, mln.MAX_N)]


def mln_case(dev, M, K, N, ldb, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(M + K + N + seed)
    a = torch.randn(M, K, generator=g).to(dev, dtype)
    b = torch.randn(K, ldb, generator=g).to(dev, dtype)[:, :N]
    scale = (0.1 * torch.randn(N, generator=g)).to(dev)
    return a, b, scale


def assert_mln_close(got, want, a, b, scale):
    """TOL of the output type on out, plus the matmul check's bound on
    z = a @ b carried through the norm: scaled by |1 + scale| / rms(z)
    (chip_smoke.py ``check_mln_case``)."""
    tol = TOL[got.dtype]
    z = ref.matmul_ref(a, b.contiguous(), torch.float32)
    rms = torch.sqrt(z.square().mean(-1, keepdim=True) + 1e-6)
    mag = a.float().abs() @ b.float().abs()
    ztol = (TOL[a.dtype]["atol"] + TOL[a.dtype]["rtol"] * z.abs()
            + 2 * a.shape[1] ** 0.5 * 2.0 ** -24 * mag)
    limit = (tol["atol"] + tol["rtol"] * want.float().abs()
             + ztol * (1 + scale.float()).abs() / rms)
    err = (got.float() - want.float()).abs()
    assert bool((err <= limit).all()), \
        f"max |err| {float(err.max()):.3e}, worst err/limit " \
        f"{float((err / limit).max()):.3f}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,ldb", MLN_SHAPES)
def test_matmul_rmsnorm_kernel_matches_plain(dev, M, K, N, ldb, dtype):
    a, b, scale = mln_case(dev, M, K, N, ldb, dtype)
    got = mln.matmul_rmsnorm(a, b, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.isfinite(got).all()
    assert_mln_close(got, ref.matmul_rmsnorm_ref(a, b, scale), a, b, scale)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_matmul_rmsnorm_out_dtype_and_scale_type(dev, in_dtype, out_dtype):
    a, b, scale = mln_case(dev, 96, 200, 72, 80, in_dtype, seed=5)
    for sc in (scale, scale.to(in_dtype)):
        got = mln.matmul_rmsnorm(a, b, sc, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype
        assert_mln_close(got, ref.matmul_rmsnorm_ref(a, b, sc,
                                                     out_dtype=out_dtype),
                         a, b, sc)


def test_matmul_rmsnorm_dispatch_counts_launches_and_rejects(dev):
    a, b, scale = mln_case(dev, 64, 32, 16, 24, torch.float32)
    before = mln.launches
    ops.matmul_rmsnorm(a, b, scale)
    assert mln.launches == before + 1
    with pytest.raises(ValueError):      # b column-major: raise, no fallback
        ops.matmul_rmsnorm(a, b.T.contiguous().T, scale)
    with pytest.raises(ValueError):      # a not contiguous
        ops.matmul_rmsnorm(a.T.contiguous().T, b, scale)
    with pytest.raises(TypeError):
        ops.matmul_rmsnorm(a.half(), b.half(), scale)
    with pytest.raises(ValueError, match=str(mln.MAX_N)):
        w = torch.zeros(32, mln.MAX_N + 1, device=dev)
        ops.matmul_rmsnorm(a, w, torch.zeros(mln.MAX_N + 1, device=dev))
    with pytest.raises(ValueError):      # scale on another device
        mln.matmul_rmsnorm(a, b, scale.cpu())
    assert mln.launches == before + 1


# ---------------------------------------------------------------------------
# the variants at their edges: which one a call takes (by launches_by_variant)
# and that it agrees with the plain version. K 200 is not a multiple of the
# 64-deep wgmma stage nor of the 16-row split-K lanes.
# ---------------------------------------------------------------------------

VARIANT_ROWS = [1, 4, 15, 16, 17, 63, 64, 65, 4096]
# (N, ldb): a narrow row, the MLA KV latent's column slice (ldb 288), the
# query latent, the widest row a cluster holds, and a row beyond it
VARIANT_COLS = [(48, 48), (256, 288), (768, 768), (2048, 2048),
                (8192, 8192)]


def expected_mln_variant(M, N, ldb, dtype):
    """What the plan must pick for 16-byte aligned rows: split-K for decode
    rows (at most 64 column blocks of 128 bf16 or 64 f32 columns), wgmma for
    bf16 rows one cluster holds, FFMA for the rest."""
    block = 128 if dtype == torch.bfloat16 else 64
    if M <= 16 and N % 8 == 0 and ldb % 8 == 0 and N <= 64 * block:
        return "splitk"
    if dtype == torch.bfloat16 and N <= 2048 and ldb % 8 == 0:
        return "wgmma"
    return "ffma"


def variant_delta(mod, fn):
    before = dict(mod.launches_by_variant)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in mod.launches_by_variant.items()
                 if v != before[k]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,ldb", VARIANT_COLS)
@pytest.mark.parametrize("M", VARIANT_ROWS)
def test_matmul_rmsnorm_variants(dev, M, N, ldb, dtype):
    a, b, scale = mln_case(dev, M, 200, N, ldb, dtype, seed=7)
    want_variant = expected_mln_variant(M, N, ldb, dtype)
    assert mln.plan(M, N, 200, ldb, dtype).variant == want_variant
    got, delta = variant_delta(
        mln, lambda: mln.matmul_rmsnorm(a, b, scale))
    assert delta == {want_variant: 1}
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.isfinite(got).all()
    assert_mln_close(got, ref.matmul_rmsnorm_ref(a, b, scale), a, b, scale)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,ldb,variant", [
    (4, 768, 768, "splitk"), (4, 256, 288, "splitk"),
    (600, 768, 768, "wgmma"), (600, 256, 288, "wgmma"),
    (4, 64, 65, "ffma"), (40, 64, 65, "ffma")])
def test_matmul_rmsnorm_variant_out_types_and_unaligned_ldb(
        dev, M, N, ldb, variant, out_dtype):
    """Both output types through each bf16 variant; an odd ldb (rows not on
    16 bytes) takes the FFMA kernel, for decode rows as for many."""
    a, b, scale = mln_case(dev, M, 520, N, ldb, torch.bfloat16, seed=9)
    got, delta = variant_delta(mln, lambda: mln.matmul_rmsnorm(
        a, b, scale, out_dtype=out_dtype))
    assert delta == {variant: 1} and got.dtype == out_dtype
    assert_mln_close(got, ref.matmul_rmsnorm_ref(a, b, scale,
                                                 out_dtype=out_dtype),
                     a, b, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_rmsnorm_splitk_deterministic_and_tickets_reset(dev, dtype):
    """The split-K reduction sums in a fixed order whichever CTA arrives
    last: two calls give the same bits, and the tickets are 0 again after
    each launch (no zeroing launch between calls)."""
    a, b, scale = mln_case(dev, 4, 2560, 256, 288, dtype, seed=11)
    first = mln.matmul_rmsnorm(a, b, scale)
    for _ in range(3):
        again = mln.matmul_rmsnorm(a, b, scale)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
    for t in mln._tickets.values():
        assert int(t.count_nonzero()) == 0


def expected_mm_variant(K, N, dtype):
    return ("wgmma" if dtype == torch.bfloat16 and K % 8 == 0
            and N % 8 == 0 else "ffma")


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [
    (1, 200, 48), (17, 200, 256), (64, 200, 2048), (65, 520, 256),
    (4096, 200, 2048), (300, 33, 256), (70, 200, 50), (512, 2048, 256),
    (1024, 2048, 2048)])
def test_matmul_variants(dev, M, K, N, dtype, out_dtype):
    g = torch.Generator(device="cpu").manual_seed(M + K + N)
    a = torch.randn(M, K, generator=g).to(dev, dtype)
    b = torch.randn(K, N, generator=g).to(dev, dtype)
    want_variant = expected_mm_variant(K, N, dtype)
    assert mm.plan(M, N, K, N, dtype).variant == want_variant
    got, delta = variant_delta(
        mm, lambda: mm.matmul(a, b, out_dtype=out_dtype))
    assert delta == {f"{want_variant}.nn": 1}     # by variant and layout
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert_matmul_close(got, ref.matmul_ref(a, b, out_dtype), a, b)


# ---------------------------------------------------------------------------
# flash attention's variants: which one a call takes (launches_by_variant)
# and that it agrees with the plain version at its edges
# ---------------------------------------------------------------------------

def flash_case(dev, dtype, *, B, Sq, Skv, H, Hkv, dh, dv, q0=None,
               pad_rows=0, seed=0):
    """Rows at positions q0[b]..q0[b]+Sq-1 (default: the last Sq of Skv
    keys), the last ``pad_rows`` rows of each batch row −1 (padding)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
    q, k, v = mk(B, Sq, H, dh), mk(B, Skv, Hkv, dh), mk(B, Skv, Hkv, dv)
    q0 = [Skv - Sq] * B if q0 is None else q0
    qpos = torch.stack([torch.arange(q0[b], q0[b] + Sq) for b in range(B)])
    if pad_rows:
        qpos[:, Sq - pad_rows:] = -1
    kpos = torch.arange(Skv).expand(B, Skv)
    return (q, k, v, qpos.to(torch.int32).contiguous().to(dev),
            kpos.to(torch.int32).contiguous().to(dev))


def flash_delta(fn):
    before = dict(fa.launches_by_variant)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in fa.launches_by_variant.items()
                 if n != before[k]}


# (dh, dv) pairs the wgmma variant is built for, with Sq and Skv not
# multiples of the tiles (128 rows; 64 or 128 keys) and padding rows
WGMMA_CASES = [
    dict(B=2, Sq=130, Skv=333, H=4, Hkv=1, dh=256, dv=256, pad_rows=5),
    dict(B=1, Sq=200, Skv=200, H=4, Hkv=2, dh=128, dv=128, pad_rows=0),
    dict(B=3, Sq=70, Skv=150, H=5, Hkv=5, dh=96, dv=64, pad_rows=9),
    dict(B=1, Sq=17, Skv=17, H=2, Hkv=1, dh=128, dv=128, pad_rows=1),
]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
@pytest.mark.parametrize("case", range(len(WGMMA_CASES)))
def test_flash_wgmma_variant(dev, case, causal, window):
    c = WGMMA_CASES[case]
    q, k, v, qpos, kpos = flash_case(dev, torch.bfloat16, **c, seed=case)
    kw = dict(q_positions=qpos, kv_positions=kpos, causal=causal,
              window=window)
    assert flash_variant(q, k, v) == "wgmma"
    got, delta = flash_delta(lambda: fa.flash_attention(q, k, v, **kw))
    assert delta == {"wgmma": 1} and got.shape == (*q.shape[:3], c["dv"])
    assert got.is_contiguous()              # v at dv: no pad, no slice
    assert_flash_close(got, q, k, v, kw)


# decode rows: gemma3-1b's (4 query heads on 1 kv head, dh 256) past the
# window with a padding row; GQA 2 at dh 128 with dv 64; 16 rows (Sq 4 x
# G 4); a context of one range (no merge)
SPLITKV_CASES = [
    dict(B=4, Sq=1, Skv=720, H=4, Hkv=1, dh=256, dv=256,
         ctx=[700, 650, 0, 601], q0=[699, 649, 0, 600]),
    dict(B=3, Sq=1, Skv=1000, H=4, Hkv=2, dh=128, dv=64,
         ctx=[1000, 37, 999], q0=[999, 36, 998]),
    dict(B=2, Sq=4, Skv=300, H=8, Hkv=2, dh=64, dv=64,
         ctx=[300, 100], q0=[296, 96]),
    dict(B=2, Sq=1, Skv=32, H=4, Hkv=1, dh=128, dv=128,
         ctx=[32, 12], q0=[31, 11]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 64, 5])
@pytest.mark.parametrize("case", range(len(SPLITKV_CASES)))
def test_flash_splitkv_variant(dev, case, window, dtype):
    c = dict(SPLITKV_CASES[case])
    dv = c.pop("dv")
    q, k, v, qpos, kpos = paged_case(dev, dtype, **c, seed=case)
    v = v[..., :dv].contiguous()
    kw = dict(q_positions=qpos, kv_positions=kpos, causal=True, window=window)
    assert flash_variant(q, k, v) == "splitkv"
    got, delta = flash_delta(lambda: fa.flash_attention(q, k, v, **kw))
    assert delta == {"splitkv": 1} and got.shape == (*q.shape[:3], dv)
    assert_flash_close(got, q, k, v, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_splitkv_deterministic_and_tickets_reset(dev, dtype):
    """Empty splits (the window of 40 leaves most of 720 keys' ranges with
    no visible key) and a padding row: the merge runs in split order
    whichever CTA arrives last, so calls give the same bits, and every
    ticket is 0 again after each launch."""
    c = dict(SPLITKV_CASES[0])
    c.pop("dv")
    q, k, v, qpos, kpos = paged_case(dev, dtype, **c, seed=11)
    kw = dict(q_positions=qpos, kv_positions=kpos, causal=True, window=40)
    p = fa.plan(4, 1, 720, 4, 1, 256, 256, dtype)
    assert p.splits > 1 and p.workspace > 0
    first = fa.flash_attention(q, k, v, **kw)
    for _ in range(3):
        again = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
        for t in fa._tickets.values():
            assert int(t.count_nonzero()) == 0
    assert_flash_close(first, q, k, v, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_ffma_variant(dev, dtype):
    """What the FFMA kernel takes: f32 prefill, dh 36, dh 320 (> 256), bases
    off 16 bytes (bf16 on 8), an (dh, dv) pair wgmma is not built for; v
    narrower than dh is padded there and the output is a view."""
    shapes = [dict(B=2, Sq=70, Skv=90, H=4, Hkv=2, dh=36, dv=36),
              dict(B=1, Sq=40, Skv=64, H=2, Hkv=1, dh=320, dv=320),
              dict(B=2, Sq=3, Skv=64, H=2, Hkv=1, dh=320, dv=256),
              dict(B=2, Sq=50, Skv=50, H=2, Hkv=2, dh=64, dv=32)]
    if dtype == torch.float32:
        shapes.append(dict(B=1, Sq=300, Skv=300, H=4, Hkv=2, dh=128,
                           dv=128))
    for i, c in enumerate(shapes):
        q, k, v, qpos, kpos = flash_case(dev, dtype, **c, seed=i)
        kw = dict(q_positions=qpos, kv_positions=kpos, causal=True)
        assert flash_variant(q, k, v) == "ffma"
        got, delta = flash_delta(lambda: fa.flash_attention(q, k, v, **kw))
        assert delta == {"ffma": 1} and got.shape[-1] == c["dv"]
        assert_flash_close(got, q, k, v, kw)
    if dtype == torch.bfloat16:
        # a contiguous view whose base lies 8 bytes past 16
        q, k, v, qpos, kpos = flash_case(dev, dtype, B=1, Sq=1, Skv=64, H=4,
                                         Hkv=1, dh=256, dv=256)
        flat = torch.empty(q.numel() + 4, dtype=dtype, device=dev)
        qo = flat[4:].view(q.shape)
        qo.copy_(q)
        assert qo.data_ptr() % 16 == 8
        kw = dict(q_positions=qpos, kv_positions=kpos, causal=True)
        got, delta = flash_delta(lambda: fa.flash_attention(qo, k, v, **kw))
        assert delta == {"ffma": 1}
        assert_flash_close(got, q, k, v, kw)


def test_flash_launches_by_variant(dev):
    """One launch a call, counted under the planned variant and in
    ``launches``; a refused call counts nothing."""
    bf = torch.bfloat16
    calls = [(dict(B=1, Sq=1, Skv=100, H=4, Hkv=1, dh=128, dv=128), bf,
              "splitkv"),
             (dict(B=1, Sq=64, Skv=100, H=4, Hkv=1, dh=128, dv=128), bf,
              "wgmma"),
             (dict(B=1, Sq=64, Skv=100, H=4, Hkv=1, dh=128, dv=128),
              torch.float32, "ffma")]
    before, total = dict(fa.launches_by_variant), fa.launches
    for c, dtype, _ in calls:
        q, k, v, qpos, kpos = flash_case(dev, dtype, **c)
        fa.flash_attention(q, k, v, q_positions=qpos, kv_positions=kpos)
    torch.cuda.synchronize()
    assert fa.launches == total + len(calls)
    assert {k: n - before[k] for k, n in fa.launches_by_variant.items()} == \
        dict(splitkv=1, wgmma=1, ffma=1)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :, :8].contiguous(), v,
                           q_positions=qpos, kv_positions=kpos)
    assert fa.launches == total + len(calls)


# arctic-480b's attention (56 query heads over 8 kv heads of 128): a served
# decode step and prefill chunk (the engine's block-table width 720) and the
# one-device training core (1 x 2048), bf16 as the model runs them
ARCTIC_CASES = [
    dict(B=4, Sq=1, Skv=720, ctx=[700, 650, 0, 613], q0=[699, 649, 0, 612]),
    dict(B=4, Sq=128, Skv=720, ctx=[700, 128, 0, 640], q0=[640, 0, 0, 512]),
    dict(B=1, Sq=2048, Skv=2048, ctx=[2048], q0=[0])]


@pytest.mark.parametrize("case", range(len(ARCTIC_CASES)))
def test_flash_at_arctic_shapes(dev, case):
    c = ARCTIC_CASES[case]
    q, k, v, qpos, kpos = paged_case(dev, torch.bfloat16, H=56, Hkv=8,
                                     dh=128, seed=case, **c)
    kw = dict(q_positions=qpos, kv_positions=kpos)
    assert flash_variant(q, k, v) == ("splitkv" if c["Sq"] == 1
                                      else "wgmma")
    assert_flash_close(fa.flash_attention(q, k, v, **kw), q, k, v, kw)


def test_adafactor_streams_an_expert_leaf_as_f64(dev):
    """The port's adafactor on a bf16 expert leaf on the card (16 experts of
    arctic-480b's 7168 x 4864), streamed an expert a slab: each new
    parameter within one bf16 ulp of the formula in f64 (plus the f32
    rounding of p and lr·u), vr and vc within 1e-5, its extra memory below
    one expert's f32 copy times 8."""
    from repro_torch.optim import adafactor, constant_schedule

    E, d, f, lr = 16, 7168, 4864, 1.5e-5
    g_ = torch.Generator(device=dev).manual_seed(0)
    p = (0.02 * torch.randn(E, d, f, generator=g_, device=dev)).to(
        torch.bfloat16)
    g = (1e-3 * torch.randn(E, d, f, generator=g_, device=dev)).to(
        torch.bfloat16)
    p0 = p.clone()
    opt = adafactor(constant_schedule(lr))
    state = opt.init({"w": p})
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt.apply({"w": p}, {"w": g}, state, 0)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 8 * d * f * 4
    us, ssq = [], 0.0
    for e in range(E):
        g64 = g[e].double()
        g2 = g64 * g64 + 1e-30
        vr, vc = g2.mean(-1), g2.mean(-2)
        for got, want in ((state["w"]["vr"][e], vr),
                          (state["w"]["vc"][e], vc)):
            assert float(((got.double() - want).abs() / want).max()) <= 1e-5
        u = g64 * torch.rsqrt(vr / vr.mean())[:, None] * \
            torch.rsqrt(vc)[None, :]
        ssq += float((u * u).sum())
        us.append(u)
    denom = max(1.0, (ssq / p.numel() + 1e-30) ** 0.5)
    for e in range(E):
        step = lr * us[e] / denom
        want = p0[e].double() - step
        limit = 2.0 ** -7 * want.abs() + 2.0 ** -20 * (
            p0[e].double().abs() + step.abs())
        assert bool(((p[e].double() - want).abs() <= limit).all())
