"""The plain PyTorch version of the flash-attention kernel against the JAX
package on the CPU: against the Pallas kernel in interpret mode (as
tests/test_kernels.py runs it) where Sq == Skv, and against the model's
``attention_core`` for position masks with Sq != Skv, GQA, a window and −1
positions. Tolerances are tests/test_kernels.py's TOL. Also: on the CPU the
dispatch takes the plain version and never the kernel."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.models.attention import attention_core  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
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
