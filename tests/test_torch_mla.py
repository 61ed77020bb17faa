"""The port's MLA slice against the JAX package on the CPU, in f32 at smoke
size: ``matmul_rmsnorm``'s plain version against the Pallas kernel in
interpret mode (tests/test_kernels.py's shapes and TOL) and against the
model's norm, with b a column slice; flash attention with a value head dim
below the query/key dim against ``attention_core``; the MLA forward,
prefill and absorbed decode (outputs and latent caches within 1e-5);
``LM.prefill`` + ``decode_step`` for minicpm3-4b and gemma3-1b (dense and
sliding-window caches); the engine's dense fallback (greedy tokens identical
to ``repro.serve.Engine``'s); the parameter count; and the dispatch rule
(a CPU call never reaches the kernel, the kernel refuses CPU tensors and a
bad ``b`` layout)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import matmul_rmsnorm as mln  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM, attention  # noqa: E402
from repro_torch.models.layers import apply_norm  # noqa: E402
from repro_torch.runtime import SMOKE  # noqa: E402
from repro_torch.serve import (DenseEngine, Engine, Request,  # noqa: E402
                               ServeConfig)

# tests/test_kernels.py's TOL; the model paths at test_torch_model.py's 1e-5
KTOL = {"float32": dict(rtol=2e-5, atol=2e-4),
        "bfloat16": dict(rtol=2e-2, atol=2e-1)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = dict(rtol=1e-5, atol=1e-5)

# minicpm3-4b at smoke widths with 3 layers; gemma3-1b with 8 (one full
# 6-layer period of 5 sliding-window layers and 1 global, plus 2 trailing)
ARCHS = {"minicpm3-4b": dict(num_layers=3), "gemma3-1b": dict(num_layers=8)}


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(JAX cfg, JAX model, JAX params, port cfg, port LM) sharing weights."""
    over = ARCHS[arch]
    jcfg = jax_get_arch(arch).smoke().scaled(**over)
    cfg = get_arch(arch).smoke().scaled(**over)
    jmodel = jax_build_model(jcfg, JAX_SMOKE)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    lm = LM(cfg, SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(lm, jax.tree.map(np.asarray, jparams))
    return jcfg, jmodel, jparams, cfg, lm


def assert_caches_close(got, want_stacked, cfg, **tol):
    want = bridge.unstack_layers(jax.tree.map(np.asarray, want_stacked), cfg)
    assert len(got) == len(want) == cfg.num_layers
    for li, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), f"layer {li}"
        for n in w:
            np.testing.assert_allclose(g[n].numpy(), w[n], **tol,
                                       err_msg=f"layer {li} {n}")


# ---------------------------------------------------------------------------
# matmul_rmsnorm: the plain version on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(128, 256, 128), (64, 512, 384),
                                   (256, 128, 64)])
def test_matmul_rmsnorm_plain_matches_pallas_kernel(M, K, N, dtype):
    a, b = rand(M + K, M, K), rand(K + N, K, N)
    scale = rand(N, N) * 0.1
    want = jops.matmul_rmsnorm(jnp.asarray(a, dtype), jnp.asarray(b, dtype),
                               jnp.asarray(scale))
    got = ops.matmul_rmsnorm(torch.from_numpy(a).to(TDT[dtype]),
                             torch.from_numpy(b).to(TDT[dtype]),
                             torch.from_numpy(scale))
    assert got.dtype == TDT[dtype] and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **KTOL[dtype])


def test_matmul_rmsnorm_matches_model_norm():
    """The epilogue equals the port's apply_norm(rmsnorm) of the product
    (tests/test_kernels.py's model-norm case)."""
    a, b = torch.from_numpy(rand(0, 32, 64)), torch.from_numpy(rand(1, 64, 48))
    scale = torch.from_numpy(rand(2, 48)) * 0.1
    got = ops.matmul_rmsnorm(a, b, scale)
    want = apply_norm("rmsnorm", a @ b, scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **KTOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_rmsnorm_column_slice_of_b(dtype):
    """b as MLA passes it: wkv_a[:, :kv_rank], row stride kv_rank + rope.
    The same values as the contiguous copy, and a bf16 scale, which the
    kernel also takes, gives the f32 scale's result."""
    a = torch.from_numpy(rand(3, 24, 40)).to(TDT[dtype])
    w = torch.from_numpy(rand(4, 40, 19)).to(TDT[dtype])
    scale = torch.from_numpy(rand(5, 16)) * 0.1
    b = w[:, :16]
    assert b.stride() == (19, 1)
    got = ops.matmul_rmsnorm(a, b, scale, out_dtype=torch.float32)
    want = ops.matmul_rmsnorm(a, b.contiguous(), scale,
                              out_dtype=torch.float32)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(
        ops.matmul_rmsnorm(a, b, scale.to(TDT[dtype])),
        ops.matmul_rmsnorm(a, b, scale.to(TDT[dtype]).float()), rtol=0,
        atol=0)


def test_matmul_rmsnorm_cpu_dispatch_and_kernel_refusals():
    a = torch.from_numpy(rand(6, 8, 12))
    w = torch.from_numpy(rand(7, 12, 10))
    scale = torch.zeros(10)
    before = mln.launches
    out = ops.matmul_rmsnorm(a, w, scale)
    assert out.shape == (8, 10) and mln.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        mln.matmul_rmsnorm(a, w, scale)          # the kernel takes no CPU
    with pytest.raises(ValueError, match="column stride"):
        ops.matmul_rmsnorm(a, w.T.contiguous().T, scale)
    with pytest.raises(ValueError, match="column stride"):
        ops.matmul_rmsnorm(a, w[:, ::2], scale[:5])
    with pytest.raises(ValueError, match="contiguous"):
        ops.matmul_rmsnorm(a.T.contiguous().T, w, scale)
    with pytest.raises(ValueError, match="scale"):
        ops.matmul_rmsnorm(a, w, scale[:9])
    assert mln.launches == before
    # the plan: decode rows split K over the SMs, bf16 prefill rows take
    # wgmma in a cluster, the rest (f32 here, N 8192) the FFMA kernel, whose
    # rows per CTA are the most the accumulator allows, shrunk for small M
    # and for idle SMs; N beyond its row limit raises, naming it
    bf16, f32 = torch.bfloat16, torch.float32
    assert mln.plan(4, 768, 2560, 768, bf16).variant == "splitk"
    assert mln.plan(4096, 768, 2560, 768, bf16).variant == "wgmma"
    assert (mln.plan(4096, 768, 2560, 768, f32).variant,
            mln.plan(4096, 768, 2560, 768, f32).bm) == ("ffma", 16)
    assert mln.plan(128, 8192, 2048, 8192, bf16).bm == 4
    assert mln.smem_bytes(4, mln.MAX_N) <= 232448 < mln.smem_bytes(
        4, mln.MAX_N + 1)
    with pytest.raises(ValueError, match=str(mln.MAX_N)):
        mln.plan(17, mln.MAX_N + 1, 8, mln.MAX_N + 1, f32)


# ---------------------------------------------------------------------------
# flash attention with dv < dh (the MLA prefill's core)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dh,dv", [(24, 16), (12, 4)])
def test_flash_value_dim_below_head_dim_matches_attention_core(dh, dv):
    B, S, H = 2, 9, 3
    q, k = rand(10, B, S, H, dh), rand(11, B, S, H, dh)
    v = rand(12, B, S, H, dv)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    scale = 1 / np.sqrt(20.0)
    want = np.asarray(jax_attn.attention_core(
        *map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(pos),
        kv_positions=jnp.asarray(pos), causal=True, scale=scale))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              q_positions=torch.from_numpy(pos),
                              kv_positions=torch.from_numpy(pos),
                              causal=True, scale=scale)
    assert got.shape == (B, S, H, dv)
    np.testing.assert_allclose(got.numpy(), want, **KTOL["float32"])


# ---------------------------------------------------------------------------
# the MLA mixer against repro's
# ---------------------------------------------------------------------------


def test_mla_forward_prefill_decode_match_jax():
    jcfg, _, _, cfg, _ = pair("minicpm3-4b")
    jp = jax.jit(functools.partial(jax_attn.init_mla, cfg=jcfg))(
        jax.random.key(3))
    # nonzero norm scales, so (1 + scale) is exercised
    jp = dict(jp, q_norm=jnp.asarray(rand(20, *jp["q_norm"].shape) * 0.1),
              kv_norm=jnp.asarray(rand(21, *jp["kv_norm"].shape) * 0.1))
    mla = attention.MLA(cfg, torch.float32, torch.device("cpu"))
    mla.load_state_dict({n: torch.from_numpy(np.array(a))
                         for n, a in jp.items()})
    B, S, s_max = 2, 7, 12
    x = rand(22, B, S, cfg.d_model)
    want = jax.jit(functools.partial(jax_attn.mla_forward, cfg=jcfg))(
        jp, jnp.asarray(x))
    got = attention.mla_forward(mla, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jout, jcache = jax.jit(functools.partial(
        jax_attn.mla_prefill, cfg=jcfg, s_max=s_max))(jp, jnp.asarray(x))
    jdecode = jax.jit(functools.partial(jax_attn.mla_decode, cfg=jcfg))
    out, cache = attention.mla_prefill(mla, torch.from_numpy(x), cfg,
                                       s_max=s_max)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for n in ("c_kv", "k_rope"):
        assert cache[n].shape == jcache[n].shape
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]),
                                   **TOL)
    idx = np.array([S, S], np.int32)
    for t in range(3):
        xt = rand(30 + t, B, 1, cfg.d_model)
        jout, jcache = jdecode(jp, jnp.asarray(xt), jcache,
                               jnp.asarray(idx + t))
        out, same = attention.mla_decode(mla, torch.from_numpy(xt), cache,
                                         torch.from_numpy(idx + t), cfg)
        assert same is cache                       # updated in place
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL,
                                   err_msg=f"decode step {t}")
        for n in ("c_kv", "k_rope"):
            np.testing.assert_allclose(cache[n].numpy(),
                                       np.asarray(jcache[n]), **TOL)


# ---------------------------------------------------------------------------
# LM.prefill / decode_step against repro's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_steps_match_jax(arch):
    """A 10-token prompt (past gemma's smoke window of 8, so the ring
    buffer wraps) into caches of 16 slots, then three decode steps."""
    jcfg, jmodel, jparams, cfg, lm = pair(arch)
    B, S, s_max = 2, 10, 16
    toks = np.random.default_rng(7).integers(1, cfg.vocab_size, (B, S)
                                             ).astype(np.int32)
    jlogits, jcaches = jax.jit(functools.partial(
        jmodel.prefill, s_max=s_max))(jparams, jnp.asarray(toks))
    jdecode = jax.jit(jmodel.decode_step)
    logits, caches = lm.prefill(torch.from_numpy(toks), s_max=s_max)
    assert logits.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert_caches_close(caches, jcaches, cfg, **TOL)
    idx = np.full((B,), S, np.int32)
    tok = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None]
    for t in range(3):
        jlogits, jcaches = jdecode(jparams, jnp.asarray(tok), jcaches,
                                   jnp.asarray(idx + t))
        logits, caches = lm.decode_step(torch.from_numpy(tok), caches,
                                        torch.from_numpy(idx + t))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL, err_msg=f"decode step {t}")
        assert_caches_close(caches, jcaches, cfg, **TOL)
        tok = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None]
    fresh = lm.init_cache(B, s_max)
    assert [sorted(c) for c in fresh] == [sorted(c) for c in caches]
    assert all(f[n].shape == c[n].shape and f[n].dtype == c[n].dtype
               for f, c in zip(fresh, caches) for n in c)


# ---------------------------------------------------------------------------
# serving: the engine's dense fallback, the launcher
# ---------------------------------------------------------------------------


def test_engine_falls_back_to_dense_with_jax_greedy_tokens():
    jcfg, jmodel, jparams, cfg, lm = pair("minicpm3-4b")
    # two prompt lengths: two static batches, the longer one left-padded
    prompts = [np.arange(1, 8, dtype=np.int32), np.arange(9, 14,
                                                          dtype=np.int32),
               np.arange(30, 37, dtype=np.int32)]
    kw = dict(max_batch=2, s_max=16)
    jeng = JaxEngine(jmodel, jparams, jcfg, JAX_SMOKE, JaxServeConfig(**kw))
    want = jeng.run([JaxRequest(rid=i, prompt=p, max_new_tokens=4)
                     for i, p in enumerate(prompts)])
    eng = Engine(lm, cfg, SMOKE, ServeConfig(**kw), device="cpu")
    assert not eng.paged and isinstance(eng._dense, DenseEngine)
    got = eng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                   for i, p in enumerate(prompts)])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == 4 for r in got)
    # 2 batches of 1 prefill + 3 decode steps each
    assert eng.steps == eng.last_report["steps"] == 8
    with pytest.raises(NotImplementedError, match="paged"):
        lm.serve_step(torch.zeros(1, 1, dtype=torch.int32), [], None)
    with pytest.raises(ValueError, match="s_max"):
        DenseEngine(lm, cfg, SMOKE, ServeConfig(s_max=8), device="cpu").run(
            [Request(rid=0, prompt=prompts[0], max_new_tokens=4)])


def test_dense_engine_matches_paged_engine_on_gemma():
    _, _, _, cfg, lm = pair("gemma3-1b")
    prompts = [(np.arange(1, 12) * 7 % cfg.vocab_size).astype(np.int32)] * 2
    kw = dict(max_batch=2, s_max=16, block_size=4, prefill_chunk=4)
    out = []
    for cls in (Engine, DenseEngine):
        eng = cls(lm, cfg, SMOKE, ServeConfig(**kw), device="cpu")
        out.append([r.out_tokens for r in eng.run(
            [Request(rid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)])])
    assert out[0] == out[1]


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_launcher_serves_minicpm3(engine):
    eng, reqs = serve.main(["--arch", "minicpm3-4b", "--smoke", "--device",
                            "cpu", "--engine", engine, "--requests", "2",
                            "--max-new", "3"])
    assert all(len(r.out_tokens) == 3 for r in reqs)
    assert eng.steps == 3                      # one batch: 1 prefill + 2


def test_param_count_matches_jax_for_full_minicpm3():
    cfg, jcfg = get_arch("minicpm3-4b"), jax_get_arch("minicpm3-4b")
    assert dataclasses.asdict(cfg.mla) == dataclasses.asdict(jcfg.mla)
    assert cfg.param_count() == jcfg.param_count() == 4_073_875_968
    assert cfg.smoke().param_count() == jcfg.smoke().param_count()
