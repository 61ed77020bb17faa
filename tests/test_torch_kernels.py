"""The plain PyTorch versions of the port's kernels against the JAX package
on the CPU. Flash attention: against the Pallas kernel in interpret mode (as
tests/test_kernels.py runs it) where Sq == Skv, and against the model's
``attention_core`` for position masks with Sq != Skv, GQA, a window and −1
positions. Matmul: against the Pallas kernel in interpret mode at
tests/test_kernels.py's shapes. Tolerances are tests/test_kernels.py's TOL.
The split-KV decode kernel's order of work (partials over key ranges, then
their merge) has a plain model in ``ref``; it is held against
``attention_ref`` and the Pallas kernel in interpret mode.
Also: on the CPU the dispatch takes the plain version and never a kernel."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.models.attention import attention_core  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-1)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,d", [(2, 64, 32), (1, 96, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_kernel(BH, S, d, dtype, causal):
    q, k, v = (rand(S + d + i, BH, S, d) for i in range(3))
    want = jops.flash_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                causal=causal, bq=32, bkv=32)
    got = ref.flash_attention_ref(
        *(torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)),
        causal=causal)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def position_case(seed, B, Sq, Skv, H, Hkv, dh):
    """Rows: a chunk at the end of its context with −1 padding after it, a
    decode-like row, a fully padded row; keys −1 past each context."""
    q, k, v = (rand(seed + i, *s) for i, s in enumerate(
        [(B, Sq, H, dh), (B, Skv, Hkv, dh), (B, Skv, Hkv, dh)]))
    ctx = [Skv, max(Skv - 2, 1), 0][:B]
    qpos = np.full((B, Sq), -1, np.int32)
    kpos = np.full((B, Skv), -1, np.int32)
    for b, c in enumerate(ctx):
        n = min(Sq - 1 if b == 0 else 1, c)
        qpos[b, :n] = np.arange(c - n, c)
        kpos[b, :c] = np.arange(c)
    return q, k, v, qpos, kpos


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("Sq,Skv", [(6, 13), (5, 5), (9, 4)])
def test_plain_matches_attention_core(Sq, Skv, H, Hkv, window):
    q, k, v, qpos, kpos = position_case(Sq * Skv + H, 3, Sq, Skv, H, Hkv, 8)
    want = np.asarray(attention_core(
        *map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(qpos),
        kv_positions=jnp.asarray(kpos), causal=True, window=window))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              q_positions=torch.from_numpy(qpos),
                              kv_positions=torch.from_numpy(kpos),
                              causal=True, window=window).numpy()
    keep = qpos >= 0
    assert keep.any()
    np.testing.assert_allclose(got[keep], want[keep], **TOL["float32"])
    assert not got[~keep].any()        # rows with no visible key: zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,d,kchunk", [(2, 64, 32, 32), (1, 96, 16, 40),
                                           (3, 50, 8, 7)])
@pytest.mark.parametrize("causal", [True, False])
def test_splitkv_model_matches_pallas_kernel(BH, S, d, kchunk, dtype,
                                             causal):
    """Causal over arange: every row's ranges past its own position hold
    no visible key (m = −inf), and the merge weighs them 0."""
    q, k, v = (rand(S + d + kchunk + i, BH, S, d) for i in range(3))
    want = jops.flash_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                causal=causal, bq=S, bkv=S)
    pos = torch.arange(S, dtype=torch.int32).expand(BH, S)
    got = ref.attention_splitkv_ref(
        *(torch.from_numpy(a).to(TDT[dtype])[:, :, None] for a in (q, k, v)),
        q_positions=pos, kv_positions=pos, kchunk=kchunk,
        causal=causal)[:, :, 0]
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("window", [0, 3, 9])
@pytest.mark.parametrize("kchunk", [4, 7, 32])
@pytest.mark.parametrize("Sq,H,Hkv", [(1, 4, 1), (1, 4, 2), (2, 4, 2),
                                      (4, 4, 1)])
def test_splitkv_model_matches_attention_ref(Sq, H, Hkv, kchunk, window):
    """Decode-shaped rows (Sq * G <= 16) over 29 keys in ranges of
    ``kchunk``: a padding row (no visible key anywhere: zeros), ranges past a
    row's context and ranges the window cuts away (no visible key in the
    range), f32 at TOL."""
    q, k, v, qpos, kpos = position_case(Sq * 7 + kchunk + window, 3, Sq,
                                        29, H, Hkv, 8)
    v = v[..., :6].copy()                   # dv below dh, as MLA's
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kw = dict(q_positions=torch.from_numpy(qpos),
              kv_positions=torch.from_numpy(kpos), causal=True,
              window=window)
    got = ref.attention_splitkv_ref(tq, tk, tv, kchunk=kchunk, **kw)
    want = ref.attention_ref(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL["float32"])
    assert torch.isfinite(got).all()
    assert not got[torch.from_numpy(qpos) < 0].any()
    m, l, acc = ref.splitkv_partials(tq, tk, tv, kchunk=kchunk, **kw)
    assert m.shape[0] == -(-29 // kchunk)
    seen = m.amax(0) > -np.inf
    assert seen.any() and (~seen).any()     # a row with and one without keys
    # a row that sees keys, with some range holding none of them: weight 0,
    # l 0, acc 0 there, never NaN
    empty = (m == -np.inf) & seen
    if kchunk < 29:
        assert empty.any()
    assert not l[empty].any() and not acc[empty].any()
    assert torch.isfinite(l).all() and torch.isfinite(acc).all()


def test_splitkv_model_window_cuts_whole_ranges():
    """A decode row at position 60 with a window of 10 sees keys 51..60:
    the ranges of 8 keys before 48 and after 63 contribute nothing, and the
    merge equals attention over the window alone."""
    q, k, v = rand(1, 1, 1, 2, 8), rand(2, 1, 70, 1, 8), rand(3, 1, 70, 1, 8)
    qpos = torch.tensor([[60]], dtype=torch.int32)
    kpos = torch.arange(70, dtype=torch.int32)[None]
    kw = dict(q_positions=qpos, kv_positions=kpos, causal=True, window=10)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    m, _, _ = ref.splitkv_partials(tq, tk, tv, kchunk=8, **kw)
    live = (m[:, 0, 0, 0] > -np.inf).nonzero().flatten().tolist()
    assert live == [6, 7]                   # keys 48..63
    got = ref.attention_splitkv_ref(tq, tk, tv, kchunk=8, **kw)
    win = ref.attention_ref(tq, tk[:, 51:61], tv[:, 51:61],
                            q_positions=qpos, kv_positions=kpos[:, 51:61],
                            causal=True)
    np.testing.assert_allclose(got.numpy(), win.numpy(), **TOL["float32"])


def test_cpu_dispatch_never_reaches_the_kernel():
    q, k, v, qpos, kpos = position_case(0, 2, 3, 7, 2, 1, 8)
    before = fa.launches
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              q_positions=torch.from_numpy(qpos),
                              kv_positions=torch.from_numpy(kpos))
    assert out.shape == q.shape and fa.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                           q_positions=torch.from_numpy(qpos),
                           kv_positions=torch.from_numpy(kpos))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [
    (128, 128, 128), (256, 512, 128), (64, 384, 96), (32, 32, 32),
    (512, 128, 256), (128, 1024, 64),
])
def test_matmul_plain_matches_pallas_kernel(M, K, N, dtype):
    a, b = rand(M * K, M, K), rand(K * N + 1, K, N)
    want = jops.matmul(jnp.asarray(a, dtype), jnp.asarray(b, dtype))
    got = ops.matmul(torch.from_numpy(a).to(TDT[dtype]),
                     torch.from_numpy(b).to(TDT[dtype]))
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_matmul_out_dtype_and_dispatch():
    a, b = rand(1, 5, 7), rand(2, 7, 3)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    before = mm.launches
    got = ops.matmul(ta, tb, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and mm.launches == before
    want = ta.float().numpy() @ tb.float().numpy()
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])
    with pytest.raises(ValueError, match="contiguous"):
        # the kernel's layouts, on every device: contiguous operands or the
        # transpose of one (ta.T passes since the backward's slice); a
        # strided slice is neither
        ops.matmul(ta[:, ::2], tb[:4])
    with pytest.raises(ValueError, match="CUDA"):
        mm.matmul(ta, tb)
