"""The port's VLM family (paligemma-3b, prefix-LM) and the flash core's
prefix-LM and non-causal masks against the JAX package on the CPU, f32:

- the plain attention core with ``prefix_len`` P in {0, 1, 4, Sq} against
  JAX's ``attention_core``, Sq != Skv, with and without a window, GQA
  (within tests/test_kernels.py's f32 TOL); its split-KV order of work with
  a prefix against it;
- non-causal (the enc-dec family's encoder and cross-attention) against
  ``repro.kernels.ops.flash_attention(causal=False)``, the Pallas kernel in
  interpret mode, at Sq == Skv and Sq != Skv;
- ``_FlashAttention``'s VJP with a prefix against ``jax.vjp`` of JAX's
  ``attention_core`` (``GRAD_RTOL``);
- ``VLM.loss`` and every grad against ``jax.value_and_grad`` (loss within
  1e-5 relative, grads within ``GRAD_RTOL`` of each tensor's max);
  ``prefill`` + ``decode_step`` logits and caches within ``F32_RTOL``; the
  dense engine's greedy tokens with ``patch_embed`` identical to
  ``repro``'s; the pipeline's ``patch_embed`` bit-equal to JAX's;
- the reference hazard (ROADMAP C): JAX's ``VLM.prefill`` is causal over
  the image prefix while its loss is prefix-LM, and the port follows both:
  the prefill's last-token logits differ from the prefix-LM forward's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.attention import attention_core  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import VLM, build_model  # noqa: E402
from repro_torch.runtime import SMOKE  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402

ARCH = "paligemma-3b"
TOL = dict(rtol=2e-5, atol=2e-4)   # tests/test_kernels.py's f32 TOL
F32_RTOL = 1e-5           # |Δ| <= 1e-5 * max(1, max|ref|)
GRAD_RTOL = 1e-5          # per tensor: 1e-5 * max(1, max|g|)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def f32_close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = F32_RTOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# the attention core's masks
# ---------------------------------------------------------------------------


def prefix_case(seed, Sq, Skv, H=4, Hkv=2, dh=8, B=2):
    """Queries at the last Sq of Skv positions (row 1's shifted back by 2,
    floored at 0, its last two keys -1), keys 0..Skv-1."""
    q, k, v = (rand(seed + i, *s) for i, s in enumerate(
        [(B, Sq, H, dh), (B, Skv, Hkv, dh), (B, Skv, Hkv, dh)]))
    qpos = np.stack([np.arange(Skv - Sq, Skv)] * B).astype(np.int32)
    kpos = np.stack([np.arange(Skv)] * B).astype(np.int32)
    qpos[1] = np.maximum(qpos[1] - 2, 0)
    kpos[1, -2:] = -1
    return q, k, v, qpos, kpos


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("P", [0, 1, 4, "Sq"])
@pytest.mark.parametrize("Sq,Skv", [(6, 6), (5, 9), (1, 7)])
def test_plain_prefix_mask_matches_attention_core(Sq, Skv, P, window):
    P = Sq if P == "Sq" else P
    q, k, v, qpos, kpos = prefix_case(10 * Sq + Skv + P, Sq, Skv)
    want = np.asarray(attention_core(
        *map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(qpos),
        kv_positions=jnp.asarray(kpos), causal=True, window=window,
        prefix_len=P))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              q_positions=torch.from_numpy(qpos),
                              kv_positions=torch.from_numpy(kpos),
                              causal=True, window=window,
                              prefix_len=P).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    splitkv = ref.attention_splitkv_ref(
        *map(torch.from_numpy, (q, k, v)),
        q_positions=torch.from_numpy(qpos),
        kv_positions=torch.from_numpy(kpos), kchunk=4, causal=True,
        window=window, prefix_len=P).numpy()
    np.testing.assert_allclose(splitkv, got, **TOL)


def test_prefix_opens_keys_past_the_query_inside_the_prefix_only():
    qp = torch.arange(6, dtype=torch.int32)[None]
    vis = ref.visible(qp, qp, causal=True, prefix_len=4)[0]
    assert vis[:4, :4].all()                            # bidirectional
    assert not vis[:4, 4:].any()                        # text stays unseen
    assert torch.equal(vis[4:], torch.tril(torch.ones(6, 6, dtype=bool))[4:])
    assert torch.equal(ref.visible(qp, qp, causal=True, prefix_len=0),
                       torch.tril(torch.ones(6, 6, dtype=bool))[None])
    # non-causal ignores the prefix: every live key
    assert ref.visible(qp, qp, causal=False, prefix_len=4).all()


@pytest.mark.parametrize("Sq,Skv", [(64, 64), (32, 96)])
def test_plain_non_causal_matches_pallas_kernel(Sq, Skv):
    """The encoder's self-attention (Sq == Skv) and a cross-attention (Sq
    != Skv): every key visible, heads folded into the batch."""
    BH, d = 3, 16
    q, k, v = rand(1, BH, Sq, d), rand(2, BH, Skv, d), rand(3, BH, Skv, d)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                                bq=32, bkv=32)
    qp = torch.arange(Sq, dtype=torch.int32).expand(BH, Sq)
    kp = torch.arange(Skv, dtype=torch.int32).expand(BH, Skv)
    got = ops.flash_attention(*(torch.from_numpy(a)[:, :, None]
                                for a in (q, k, v)),
                              q_positions=qp, kv_positions=kp, causal=False)
    np.testing.assert_allclose(got[:, :, 0].numpy(), np.asarray(want), **TOL)


def test_flash_vjp_with_prefix_matches_jax():
    q, k, v, qpos, kpos = prefix_case(5, 9, 9)
    gy = rand(9, *q.shape)
    f = lambda a, b, c: attention_core(
        a, b, c, q_positions=jnp.asarray(qpos),
        kv_positions=jnp.asarray(kpos), causal=True, prefix_len=4)
    _, pull = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = pull(jnp.asarray(gy))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, q_positions=torch.from_numpy(qpos),
                              kv_positions=torch.from_numpy(kpos),
                              causal=True, prefix_len=4)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(gy))
    for t, w, name in zip(leaves, want, "qkv"):
        w = np.asarray(w)
        bound = GRAD_RTOL * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(t.grad.numpy() - w).max()) <= bound, name


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def pair():
    jc, tc = jax_get_arch(ARCH).smoke(), get_arch(ARCH).smoke()
    jmodel = jax_build_model(jc, JAX_SMOKE)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    model = VLM(tc, SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return jc, jmodel, jparams, tc, model


def patches(seed, B):
    tc = pair()[3]
    return rand(seed, B, tc.num_prefix_tokens, tc.vision_width)


def test_loss_and_grads_match_jax():
    jc, jmodel, jparams, tc, model = pair()
    toks = np.random.default_rng(21).integers(0, tc.vocab_size, (2, 13)
                                              ).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "patch_embed": patches(22, 2)}
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = bridge.state_dict_from_jax(jax.tree.map(np.asarray, grads), tc)
    model.requires_grad_(True)
    try:
        got = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        got.backward()
        assert abs(float(got.detach()) - float(loss)) <= \
            1e-5 * abs(float(loss))
        assert set(want) == {n for n, _ in model.named_parameters()}
        assert "vision_proj" in want
        for name, p in model.named_parameters():
            w = want[name].numpy()
            bound = GRAD_RTOL * max(1.0, float(np.abs(w).max()))
            assert float(np.abs(_np(p.grad) - w).max()) <= bound, name
    finally:
        model.requires_grad_(False)
        for p in model.parameters():
            p.grad = None


def test_prefill_and_decode_match_jax():
    """A 10-token prompt behind the 4-token image prefix, then three greedy
    decode steps from position 14: logits and every layer's cache."""
    jc, jmodel, jparams, tc, model = pair()
    B, S, P = 2, 10, tc.num_prefix_tokens
    s_max = P + S + 4
    toks = np.random.default_rng(23).integers(1, tc.vocab_size, (B, S)
                                              ).astype(np.int32)
    img = patches(24, B)
    jlogits, jcaches = jax.jit(functools.partial(jmodel.prefill,
                                                 s_max=s_max))(
        jparams, {"tokens": jnp.asarray(toks),
                  "patch_embed": jnp.asarray(img)})
    logits, caches = model.prefill({"tokens": torch.from_numpy(toks),
                                    "patch_embed": torch.from_numpy(img)},
                                   s_max=s_max)
    f32_close(logits.numpy(), jlogits, "prefill")

    def caches_close(step):
        want = bridge.unstack_layers(jax.tree.map(np.asarray, jcaches), tc)
        for li, (g, w) in enumerate(zip(caches, want)):
            for k in w:
                f32_close(g[k].numpy(), w[k], f"{step} layer {li} {k}")

    caches_close("prefill")
    jdecode = jax.jit(jmodel.decode_step)
    idx = np.full((B,), P + S, np.int32)
    tok = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None]
    for t in range(3):
        jlogits, jcaches = jdecode(jparams, jnp.asarray(tok), jcaches,
                                   jnp.asarray(idx + t))
        logits, caches = model.decode_step(torch.from_numpy(tok), caches,
                                           torch.from_numpy(idx + t))
        f32_close(logits.numpy(), jlogits, f"decode {t}")
        caches_close(f"decode {t}")
        tok = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None]


def test_prefill_is_causal_over_the_prefix_as_jax():
    """ROADMAP C: JAX's ``VLM.prefill`` calls ``stack_prefill`` without
    ``prefix_len`` while ``VLM.loss`` runs the prefix-LM mask, so a served
    prompt sees a different mask from the trained one. The port follows
    both: the prefill's last-token logits equal the causal forward's and
    differ from the prefix-LM forward's."""
    _, _, _, tc, model = pair()
    toks = torch.from_numpy(np.random.default_rng(25).integers(
        1, tc.vocab_size, (2, 6)).astype(np.int32))
    img = torch.from_numpy(patches(26, 2))
    logits, _ = model.prefill({"tokens": toks, "patch_embed": img})
    with torch.no_grad():
        x = model._embed_all(img, toks)
        prefix_lm = model.logits(model._stack(x, tc.num_prefix_tokens)[0]
                                 [:, -1:])
        causal = model.logits(model._stack(x, 0)[0][:, -1:])
    np.testing.assert_allclose(logits.numpy(), causal.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert float((logits - prefix_lm).abs().max()) > 1e-3


def test_engine_greedy_tokens_match_jax():
    """Three requests of one prompt length with one ``patch_embed`` row
    each, through the paged ``Engine``, which falls back to the dense one
    (as JAX's does where there are extras): greedy tokens identical."""
    jc, jmodel, jparams, tc, model = pair()
    prompts = [np.arange(1 + 5 * i, 7 + 5 * i, dtype=np.int32)
               for i in range(3)]
    extras = {"patch_embed": patches(27, 3)}
    kw = dict(max_batch=4, s_max=6 + 4 + tc.num_prefix_tokens)
    want = JaxEngine(jmodel, jparams, jc, JAX_SMOKE, JaxServeConfig(**kw),
                     extras=extras).run(
        [JaxRequest(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)])
    eng = Engine(model, tc, SMOKE, ServeConfig(**kw), device="cpu",
                 extras=extras)
    assert not eng.paged
    got = eng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                   for i, p in enumerate(prompts)])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert eng.steps == 4
    with pytest.raises(NotImplementedError, match="dense engine"):
        model.serve_step(None, None, None)


def test_pipeline_patch_embed_equals_jax():
    jc, tc = jax_get_arch(ARCH).smoke(), get_arch(ARCH).smoke()
    for step in (0, 2):
        want = jpipe.make_batch(jc, JaxShape("t", 8, 3, "train"), step,
                                jpipe.DataConfig(4))
        got = pipeline.make_batch(tc, ShapeConfig("t", 8, 3, "train"), step,
                                  pipeline.DataConfig(4))
        assert set(got) == set(want) == {"tokens", "labels", "patch_embed"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_build_model_param_count_and_bridge():
    t, j = get_arch(ARCH), jax_get_arch(ARCH)
    assert t.param_count() == j.param_count() == 2_511_022_080
    model = pair()[4]
    assert t.smoke().param_count() == j.smoke().param_count() == sum(
        p.numel() for p in model.parameters())
    assert isinstance(build_model(t.smoke(), SMOKE, device="cpu"), VLM)
    tree = jax.tree.map(np.asarray, pair()[2])
    np.testing.assert_array_equal(model.vision_proj.numpy(),
                                  tree["vision_proj"])
    with pytest.raises(ValueError, match="no image prefix"):
        VLM(get_arch("gemma3-1b").smoke(), SMOKE, device="cpu")
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro_torch.configs.registry import ARCHS

    assert set(ARCHS) == set(JAX_ARCHS)


def test_launcher_serves_and_trains():
    from repro_torch.launch import serve, train

    eng, reqs = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "2", "--max-new", "3"])
    assert all(len(r.out_tokens) == 3 for r in reqs) and eng.steps == 3
    assert eng.sc.s_max == 8 + 3 + get_arch(ARCH).smoke().num_prefix_tokens
    trainer = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "2"])
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
