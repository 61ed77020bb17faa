"""The port's enc-dec family (whisper-tiny) against the JAX package on the
CPU, f32: layernorm and the non-gated ``gelu_mlp`` within 1e-6; the
non-gated MLP, the cross-attention (its K/V and the attention) and an
encoder block within ``F32_RTOL`` of the output's max; ``EncDecLM.loss``
and every grad against ``jax.value_and_grad`` (loss within 1e-5 relative,
grads within ``GRAD_RTOL`` of each tensor's max); ``prefill`` and
``decode_step`` logits and caches within ``F32_RTOL``; the dense engine's
greedy tokens with ``src_embed`` identical to ``repro``'s; the pipeline's
``src_embed`` bit-equal to JAX's; the bridge's round trip; the raise on a
TP group. Parameters cross through ``bridge.load_jax_params``. The smoke
config has 4 query over 2 kv heads where whisper-tiny has 6 over 6
(ROADMAP C), so these tests exercise GQA too."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402
from repro.serve import DenseEngine as JaxDenseEngine  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import EncDecLM, build_model, encdec  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import ffn as tffn  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.runtime import SMOKE, Runtime  # noqa: E402
from repro_torch.serve import DenseEngine, Engine, Request  # noqa: E402
from repro_torch.serve import ServeConfig  # noqa: E402
from repro_torch.sharding import TPGroup  # noqa: E402

ARCH = "whisper-tiny"
LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
F32_RTOL = 1e-5           # |Δ| <= 1e-5 * max(1, max|ref|)
GRAD_RTOL = 1e-5          # per tensor: 1e-5 * max(1, max|g|)


def rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def f32_close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = F32_RTOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def _np(t):
    return t.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def pair():
    jc, tc = jax_get_arch(ARCH).smoke(), get_arch(ARCH).smoke()
    jmodel = jax_build_model(jc, JAX_SMOKE)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    model = EncDecLM(tc, SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return jc, jmodel, jparams, tc, model


def src(seed, B):
    tc = pair()[3]
    return rand(seed, B, tc.encoder.max_source_len, tc.d_model)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 384)])
def test_layernorm(shape):
    x = rand(0, *shape)
    scale, bias = rand(1, shape[-1], scale=0.5) + 1, rand(2, shape[-1])
    want = jl.apply_norm("layernorm", {"scale": jnp.asarray(scale),
                                       "bias": jnp.asarray(bias)},
                         jnp.asarray(x))
    got = tl.apply_norm("layernorm", torch.from_numpy(x),
                        torch.from_numpy(scale), bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_layernorm_module_inits_as_jax():
    """A layernorm's scale starts at ones and its bias at zeros, as JAX's
    ``init_norm`` (an rmsnorm's scale at zeros: the ``(1 + scale)``
    form)."""
    norm = tl.Norm("layernorm", 16, torch.float32, torch.device("cpu"))
    want = jl.init_norm("layernorm", 16)
    assert sorted(dict(norm.named_parameters())) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(_np(getattr(norm, k)), np.asarray(v))
    assert tl.Norm("rmsnorm", 16, torch.float32,
                   torch.device("cpu")).bias is None


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_gelu_mlp_activation(scale):
    x = rand(5, 4, 33, scale=scale)
    want = jl.activation("gelu_mlp", jnp.asarray(x))
    got = tl.activation("gelu_mlp", torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    assert tl.gated("gelu_mlp") is False == jl.gated("gelu_mlp")


def test_non_gated_mlp():
    jc, _, jparams, tc, model = pair()
    p = jax.tree.map(np.asarray, jparams["dec_blocks"]["ffn"])
    p = {k: v[0] for k, v in p.items()}
    assert sorted(p) == ["w_down", "w_up"]
    mlp = model.dec_blocks[0].ffn
    assert mlp.w_gate is None and sorted(
        n for n, _ in mlp.named_parameters()) == ["w_down", "w_up"]
    x = rand(6, 2, 5, tc.d_model)
    want = jffn.mlp_forward({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), jc.act)
    got = tffn.mlp_forward(mlp, torch.from_numpy(x), tc.act)
    f32_close(got.numpy(), want, "mlp")


# ---------------------------------------------------------------------------
# attention and blocks
# ---------------------------------------------------------------------------


def _jblock(jparams, stack, i):
    return jax.tree.map(lambda a: a[i], jparams[stack])


@pytest.mark.parametrize("S,T", [(5, 16), (1, 16), (7, 3)])
def test_cross_attention(S, T):
    jc, _, jparams, tc, model = pair()
    jp = _jblock(jparams, "dec_blocks", 1)["cross"]
    blk = model.dec_blocks[1]
    enc, x = rand(7, 2, T, tc.d_model), rand(8, 2, S, tc.d_model)
    jkv = jattn.cross_attention_kv(jp, jnp.asarray(enc), jc)
    kv = tattn.cross_attention_kv(blk.cross, torch.from_numpy(enc), tc)
    for k in ("k", "v"):
        f32_close(kv[k].numpy(), jkv[k], k)
    want = jattn.cross_attention(jp, jnp.asarray(x), jkv, jc)
    got = tattn.cross_attention(blk.cross, torch.from_numpy(x), kv, tc)
    f32_close(got.numpy(), want, "cross")


def test_enc_block_forward():
    jc, _, jparams, tc, model = pair()
    x = src(9, 2)
    want = jencdec.enc_block_forward(_jblock(jparams, "enc_blocks", 0),
                                     jnp.asarray(x), jc)
    got = encdec.enc_block_forward(model.enc_blocks[0], torch.from_numpy(x),
                                   tc)
    f32_close(got.numpy(), want, "enc block")


def test_encode_matches_jax():
    jc, jmodel, jparams, tc, model = pair()
    x = src(10, 2)
    want = jax.jit(jmodel.encode)(jparams, jnp.asarray(x))
    f32_close(model.encode(torch.from_numpy(x)).numpy(), want, "encode")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _batch(seed, B=2, S=12):
    tc = pair()[3]
    toks = np.random.default_rng(seed).integers(0, tc.vocab_size, (B, S + 1)
                                                ).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "src_embed": src(seed + 1, B)}


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    jc, jmodel, jparams, tc, model = pair()
    batch = _batch(11)
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = bridge.state_dict_from_jax(jax.tree.map(np.asarray, grads), tc)
    model.rt = Runtime(compute_dtype="float32", remat=remat,
                       loss_chunk=SMOKE.loss_chunk)
    model.requires_grad_(True)
    try:
        got = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        got.backward()
        assert abs(float(got.detach()) - float(loss)) <= \
            1e-5 * abs(float(loss))
        assert set(want) == {n for n, _ in model.named_parameters()}
        for name, p in model.named_parameters():
            w = want[name].numpy()
            bound = GRAD_RTOL * max(1.0, float(np.abs(w).max()))
            assert float(np.abs(_np(p.grad) - w).max()) <= bound, name
    finally:
        model.rt = SMOKE
        model.requires_grad_(False)
        for p in model.parameters():
            p.grad = None


def test_prefill_and_decode_match_jax():
    """A 10-token prompt over 16 source frames, then three greedy decode
    steps: logits, the self caches and the cross K/V against ``repro``'s."""
    jc, jmodel, jparams, tc, model = pair()
    B, S, s_max = 2, 10, 16
    toks = np.random.default_rng(12).integers(1, tc.vocab_size, (B, S)
                                              ).astype(np.int32)
    frames = src(13, B)
    jlogits, jcaches = jax.jit(functools.partial(jmodel.prefill,
                                                 s_max=s_max))(
        jparams, {"tokens": jnp.asarray(toks),
                  "src_embed": jnp.asarray(frames)})
    logits, caches = model.prefill({"tokens": torch.from_numpy(toks),
                                    "src_embed": torch.from_numpy(frames)},
                                   s_max=s_max)
    f32_close(logits.numpy(), jlogits, "prefill")

    def caches_close(step):
        for part in ("self", "cross"):
            want = jax.tree.map(np.asarray, jcaches[part])
            for li, c in enumerate(caches[part]):
                for k in ("k", "v"):
                    f32_close(c[k].numpy(), want[k][li],
                              f"{step} {part} {li} {k}")

    caches_close("prefill")
    jdecode = jax.jit(jmodel.decode_step)
    idx = np.full((B,), S, np.int32)
    tok = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None]
    for t in range(3):
        jlogits, jcaches = jdecode(jparams, jnp.asarray(tok), jcaches,
                                   jnp.asarray(idx + t))
        logits, caches = model.decode_step(torch.from_numpy(tok), caches,
                                           torch.from_numpy(idx + t))
        f32_close(logits.numpy(), jlogits, f"decode {t}")
        caches_close(f"decode {t}")
        tok = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None]
    fresh, want = model.init_cache(B, s_max), jmodel.init_cache(B, s_max)
    for part in ("self", "cross"):
        for li, c in enumerate(fresh[part]):
            for k in ("k", "v"):
                assert tuple(c[k].shape) == want[part][k].shape[1:]


def test_dense_engine_greedy_tokens_match_jax():
    """Three requests of one prompt length, the engine's ``src_embed`` one
    row each; greedy tokens identical to ``repro``'s dense engine. The
    paged ``Engine`` falls back to the dense one."""
    jc, jmodel, jparams, tc, model = pair()
    prompts = [np.arange(1 + 7 * i, 8 + 7 * i, dtype=np.int32)
               for i in range(3)]
    extras = {"src_embed": src(14, 3)}
    kw = dict(max_batch=4, s_max=16)
    want = JaxDenseEngine(jmodel, jparams, jc, JAX_SMOKE,
                          JaxServeConfig(**kw), extras=extras).run(
        [JaxRequest(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)])
    eng = Engine(model, tc, SMOKE, ServeConfig(**kw), device="cpu",
                 extras=extras)
    assert not eng.paged
    got = eng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                   for i, p in enumerate(prompts)])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert eng.steps == 4                  # 1 prefill + 3 decode
    # the extras' rows must be the batch's requests (JAX does not check)
    two = DenseEngine(model, tc, SMOKE, ServeConfig(**kw), device="cpu",
                      extras=extras)
    with pytest.raises(ValueError, match="extras"):
        two.run([Request(rid=i, prompt=p, max_new_tokens=2)
                 for i, p in enumerate(prompts[:2])])


def test_pipeline_src_embed_equals_jax():
    jc, tc = jax_get_arch(ARCH).smoke(), get_arch(ARCH).smoke()
    for step in (0, 3):
        want = jpipe.make_batch(jc, JaxShape("t", 8, 2, "train"), step,
                                jpipe.DataConfig(5))
        got = pipeline.make_batch(tc, ShapeConfig("t", 8, 2, "train"), step,
                                  pipeline.DataConfig(5))
        assert set(got) == set(want) == {"tokens", "labels", "src_embed"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_bridge_round_trip():
    """JAX's tree -> the port's state dict: every name of the model, every
    shape, the values as JAX holds them (``self`` -> ``self_attn``)."""
    _, _, jparams, tc, model = pair()
    tree = jax.tree.map(np.asarray, jparams)
    sd = bridge.state_dict_from_jax(tree, tc)
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), own[k].numpy())
    np.testing.assert_array_equal(
        own["dec_blocks.1.self_attn.wq"].numpy(),
        tree["dec_blocks"]["self"]["wq"][1])
    np.testing.assert_array_equal(own["enc_norm.bias"].numpy(),
                                  tree["enc_norm"]["bias"])


def test_raises_on_a_group_and_builds_by_config():
    tc = get_arch(ARCH).smoke()
    with pytest.raises(NotImplementedError, match="A15: enc-dec on a ring"):
        build_model(tc, SMOKE, device="cpu", group=TPGroup(0, 2, "gloo"))
    m = build_model(tc, SMOKE, device="cpu", seed=1)
    assert isinstance(m, EncDecLM) and m.tp == m.dp == 1
    assert not m.split_groups()
    with pytest.raises(ValueError, match="no encoder"):
        EncDecLM(get_arch("gemma3-1b").smoke(), SMOKE, device="cpu")


def test_param_count_and_config():
    t, j = get_arch(ARCH), jax_get_arch(ARCH)
    assert t.param_count() == j.param_count() == 36_448_128
    assert t.smoke().param_count() == j.smoke().param_count() == sum(
        p.numel() for p in pair()[4].parameters())
    assert t.is_enc_dec and t.smoke().encoder.max_source_len == 16
    assert (t.smoke().num_heads, t.smoke().num_kv_heads) == (4, 2)


def test_launcher_serves_and_trains():
    from repro_torch.launch import serve, train

    eng, reqs = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "2", "--max-new", "3"])
    assert all(len(r.out_tokens) == 3 for r in reqs) and eng.steps == 3
    trainer = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "2"])
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
