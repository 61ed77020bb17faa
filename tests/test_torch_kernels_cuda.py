"""The Hopper flash-attention kernel against its plain PyTorch version, on
the card. Every test here needs an NVIDIA GPU with nvcc; on a machine
without one they skip. Run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# the kernel and its plain version both compute in f32 from the same inputs:
# f32 within tests/test_kernels.py's TOL; bf16 within one rounding of the
# output (one bf16 step is at most |x|/128)
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-4),
       torch.bfloat16: dict(rtol=1 / 128, atol=2e-3)}

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


def assert_rows_close(got, want, qpos, dtype):
    keep = qpos >= 0
    torch.testing.assert_close(got[keep].float(), want[keep].float(),
                               **TOL[dtype])


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
    assert_rows_close(got, ref.attention_ref(q, k, v, **kw), qpos, dtype)
    pad = qpos < 0
    assert torch.count_nonzero(got[pad]) == 0   # no visible key: zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,d", [(2, 128, 64), (4, 256, 32),
                                    (1, 512, 128), (2, 300, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_tpu_case(dev, BH, S, d, dtype, causal):
    g = torch.Generator(device="cpu").manual_seed(S + d)
    q, k, v = (torch.randn(BH, S, d, generator=g).to(dev, dtype)
               for _ in range(3))
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(BH, S)
    got = fa.flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                             q_positions=pos.contiguous(),
                             kv_positions=pos.contiguous(), causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got[:, :, 0].float(), want.float(),
                               **TOL[dtype])


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
