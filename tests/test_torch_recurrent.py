"""The port's recurrent families against the JAX package on the CPU: the
log-depth linear scan (``models/scan.py``) against a sequential loop and
``jax.lax.associative_scan`` (values and ``jax.vjp`` grads); the Mamba-2 SSD
mixer (``_ssd_chunked``, ``ssm_forward``, ``ssm_decode``) and the RG-LRU
mixer (``rglru_forward``, ``rglru_decode``) against ``repro``'s, in f32
(within ``F32_RTOL`` of the output's max) and bf16 (the RMS of the
difference within ``BF16_ROUNDINGS`` roundings of the output's RMS: the two
frameworks round bf16 transcendentals differently, an ulp in about a third
of sigmoid's outputs, so bitwise or element-wise equality is not on offer),
their grads against ``jax.value_and_grad``; the SSM at a prime S (chunk 1)
and at S < conv_width − 1; a prefill's state then decode steps equal to
decoding every token; ``LM.loss`` (and its grads), ``LM.prefill`` and
``LM.decode_step`` of both smoke configs and of each arch at its published
widths cut to one layer pattern period, parameters through
``bridge.load_jax_params``; the dense engine's greedy tokens equal to
``repro``'s; the parameter count. recurrentgemma-2b's published-width case
keeps a vocabulary of 1024: its 256000 x 2560 embedding is 2.6 GB a
package, and the vocabulary is no width of the mixers under test."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM, rglru, ssm  # noqa: E402
from repro_torch.models.scan import linear_scan  # noqa: E402
from repro_torch.runtime import SMOKE  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402

F32_RTOL = 1e-5           # |Δ| <= 1e-5 * max(1, max|ref|), f32
BF16_ROUNDINGS = 2        # rms(Δ) <= 2 * 2^-8 * rms(ref), bf16
GRAD_RTOL = 1e-5          # per tensor: 1e-5 * max(1, max|g|)
ARCHS = ("mamba2-130m", "recurrentgemma-2b")
MIXERS = {"ssm": (jssm, ssm, ssm.SSM, "mamba2-130m"),
          "rglru": (jrglru, rglru, rglru.RGLRU, "recurrentgemma-2b")}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def f32_close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = F32_RTOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def bf16_close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    bound = BF16_ROUNDINGS * 2.0 ** -8 * rms(want)
    assert rms(got - want) <= bound, (what, rms(got - want), bound)
    assert np.isfinite(got).all()


def close(dtype, got, want, what=""):
    (f32_close if dtype == "float32" else bf16_close)(got, want, what)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------


def _loop(a, b, h0):
    h, out = h0, []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return np.stack(out, 1)


def _jax_scan(a, b, h0):
    b = b.at[:, 0].add(a[:, 0] * h0)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    return jax.lax.associative_scan(combine, (a, b), axis=1)[1]


@pytest.mark.parametrize("n", [1, 2, 13, 4096])
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_scan_matches_loop_and_associative_scan(n, with_h0):
    a = np.random.default_rng(n).uniform(0.5, 1.0, (2, n, 3)).astype(
        np.float32)
    b, h0 = rand(n + 1, 2, n, 3), rand(n + 2, 2, 3)
    h0 = h0 if with_h0 else np.zeros_like(h0)
    got = linear_scan(torch.from_numpy(a), torch.from_numpy(b), dim=1,
                      h0=torch.from_numpy(h0) if with_h0 else None)
    f32_close(got.numpy(), _loop(a, b, h0), "loop")
    f32_close(got.numpy(), np.asarray(jax.jit(_jax_scan)(
        *map(jnp.asarray, (a, b, h0)))), "associative_scan")


@pytest.mark.parametrize("n", [13, 4096])
def test_linear_scan_grads_match_jax_vjp(n):
    """The scan's grads (of a, b, h0; a broadcast along the last dim, as
    SSD's chunk decay) against ``jax.vjp`` of the associative scan."""
    a = np.random.default_rng(n).uniform(0.5, 1.0, (2, n, 1)).astype(
        np.float32)
    b, h0, gy = rand(n + 1, 2, n, 4), rand(n + 2, 2, 4), rand(n + 3, 2, n, 4)
    ta, tb, th = (torch.from_numpy(v).requires_grad_(True)
                  for v in (a, b, h0))
    (linear_scan(ta, tb, dim=1, h0=th) * torch.from_numpy(gy)).sum(
        ).backward()

    def grads(a_, b_, h_, g_):
        f = lambda x, y, z: _jax_scan(jnp.broadcast_to(x, y.shape), y, z)
        return jax.vjp(f, a_, b_, h_)[1](g_)

    want = jax.jit(grads)(*map(jnp.asarray, (a, b, h0, gy)))
    for got, want, name in zip((ta.grad, tb.grad, th.grad), want, "abh"):
        f32_close(got.numpy(), np.asarray(want), name)


def test_linear_scan_is_log_depth():
    """⌈log2 n⌉ doubling steps, not n: at n = 4096 the forward makes 12
    multiply-adds of whole tensors and the backward (the adjoint scan) 12
    more, whatever n's factors."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Adds(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Adds.n += func is torch.ops.aten.add.Tensor
            return func(*args, **(kwargs or {}))

    a = torch.rand(1, 4096, 2, requires_grad=True)
    with Adds():
        out = linear_scan(a, torch.rand(1, 4096, 2))
        assert Adds.n == 12
        out.sum().backward()
    assert Adds.n == 24 and a.grad.shape == a.shape
    with pytest.raises(ValueError, match="steps"):
        linear_scan(torch.ones(1, 3, 1), torch.ones(1, 4, 1))


# ---------------------------------------------------------------------------
# the mixers against repro's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def mixer_params(kind):
    """``repro``'s init of the smoke mixer with every leaf moved off its
    constant init (zeros, ones, linspace), as numpy."""
    jmod, _, _, arch = MIXERS[kind]
    init = jssm.init_ssm if kind == "ssm" else jrglru.init_rglru
    tree = jax.tree.map(np.asarray, init(jax.random.key(1),
                                         jax_get_arch(arch).smoke()))
    return {k: (v + rand(len(k), *v.shape, scale=0.3)).astype(v.dtype)
            if k not in ("A_log", "Lambda") else v for k, v in tree.items()}


def mixer_pair(kind, dtype):
    """(JAX cfg, JAX params in ``dtype`` where repro keeps them so, port
    cfg, port module)."""
    jmod, tmod, cls, arch = MIXERS[kind]
    jc, tc = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    tree = mixer_params(kind)
    m = cls(tc, TDT[dtype], torch.device("cpu"))
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in tree.items()})
    jp = {k: jnp.asarray(v).astype(dtype) if getattr(m, k).dtype ==
          TDT[dtype] else jnp.asarray(v) for k, v in tree.items()}
    return jc, jp, tc, m


def test_mixer_f32_leaves_stay_f32_in_bf16():
    for kind, leaves in (("ssm", ("A_log", "dt_bias", "D")),
                         ("rglru", ("gate_a_w", "gate_a_b", "gate_i_w",
                                    "gate_i_b", "Lambda"))):
        _, _, _, m = mixer_pair(kind, "bfloat16")
        for name, p in m.named_parameters():
            want = torch.float32 if name in leaves else torch.bfloat16
            assert p.dtype == want, (kind, name)


def _fwd(kind, jax_side):
    if kind == "ssm":
        return jssm.ssm_forward if jax_side else ssm.ssm_forward
    return jrglru.rglru_forward if jax_side else rglru.rglru_forward


# S 16: two chunks of 8 (SSM); 13: prime, chunk 1, 13 steps of the scan;
# 2: shorter than conv_width − 1, the conv state padded on the left
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 13, 2])
@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_mixer_forward_and_state_match_jax(kind, S, dtype):
    jc, jp, tc, m = mixer_pair(kind, dtype)
    x = rand(S, 2, S, tc.d_model)
    jf = jax.jit(functools.partial(_fwd(kind, True), cfg=jc,
                                   return_state=True))
    want_y, (want_h, want_conv) = jf(jp, jnp.asarray(x).astype(dtype))
    y, (h, conv) = _fwd(kind, False)(m, torch.from_numpy(x).to(TDT[dtype]),
                                     tc, return_state=True)
    assert y.dtype == h.dtype == conv.dtype == TDT[dtype]
    assert conv.shape == want_conv.shape == (2, 3, conv.shape[2])
    close(dtype, _np(y), np.asarray(want_y, np.float32), "y")
    close(dtype, _np(h), np.asarray(want_h, np.float32), "h")
    close(dtype, _np(conv), np.asarray(want_conv, np.float32), "conv")
    if S == 2:       # the left pad is zeros, as JAX's
        assert not conv[:, 0].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(16, 8), (13, 1), (24, 4)])
def test_ssd_chunked_matches_jax(S, chunk, dtype):
    b, h, p, g, n = 2, 4, 8, 1, 16
    x, B, C = rand(1, b, S, h, p), rand(3, b, S, g, n), rand(4, b, S, g, n)
    dt = np.abs(rand(2, b, S, h)) * 0.5
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    h0 = rand(5, b, h, p, n)
    for with_h0 in (False, True):
        jargs = [jnp.asarray(v).astype(dtype) for v in (x,)] + [
            jnp.asarray(dt), jnp.asarray(A)] + [
            jnp.asarray(v).astype(dtype) for v in (B, C)]
        wy, wh = jax.jit(functools.partial(jssm._ssd_chunked, chunk=chunk))(
            *jargs, h0=jnp.asarray(h0).astype(dtype) if with_h0 else None)
        ty = [torch.from_numpy(v).to(TDT[dtype]) for v in (x,)] + [
            torch.from_numpy(dt), torch.from_numpy(A)] + [
            torch.from_numpy(v).to(TDT[dtype]) for v in (B, C)]
        gy, gh = ssm._ssd_chunked(
            *ty, chunk, h0=torch.from_numpy(h0).to(TDT[dtype])
            if with_h0 else None)
        close(dtype, _np(gy), np.asarray(wy, np.float32), "y")
        close(dtype, _np(gh), np.asarray(wh, np.float32), "h")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_mixer_decode_matches_jax_and_prefill_then_decode(kind, dtype):
    """JAX's decode steps from a prefill's state, step for step, the cache
    updated in place; and the prefill state then decoding equals decoding
    every token from an empty cache (f32: within F32_RTOL)."""
    jc, jp, tc, m = mixer_pair(kind, dtype)
    jmod, tmod, _, _ = MIXERS[kind]
    init_j = jssm.init_ssm_cache if kind == "ssm" else \
        jrglru.init_rglru_cache
    init_t = ssm.init_ssm_cache if kind == "ssm" else \
        rglru.init_rglru_cache
    dec_j = jax.jit(functools.partial(
        jssm.ssm_decode if kind == "ssm" else jrglru.rglru_decode, cfg=jc))
    dec_t = ssm.ssm_decode if kind == "ssm" else rglru.rglru_decode
    x = rand(7, 2, 9, tc.d_model)
    S0 = 5
    _, (jh, jconv) = jax.jit(functools.partial(
        _fwd(kind, True), cfg=jc, return_state=True))(
        jp, jnp.asarray(x[:, :S0]).astype(dtype))
    jcache = {"h": jh, "conv": jconv}
    _, (h, conv) = _fwd(kind, False)(
        m, torch.from_numpy(x[:, :S0]).to(TDT[dtype]), tc, return_state=True)
    cache = {"h": h.clone(), "conv": conv.clone()}
    for t in range(S0, 9):
        xt = jnp.asarray(x[:, t:t + 1]).astype(dtype)
        wy, jcache = dec_j(jp, xt, jcache)
        y, same = dec_t(m, torch.from_numpy(x[:, t:t + 1]).to(TDT[dtype]),
                        cache, tc)
        assert same is cache
        close(dtype, _np(y), np.asarray(wy, np.float32), f"step {t}")
        for k in ("h", "conv"):
            close(dtype, _np(cache[k]), np.asarray(jcache[k], np.float32),
                  f"step {t} {k}")
    if dtype != "float32":
        return
    # every token decoded from an empty cache equals the forward
    full = _fwd(kind, False)(m, torch.from_numpy(x), tc)
    empty = init_t(tc, 2, torch.float32, torch.device("cpu"))
    assert {k: v.shape for k, v in empty.items()} == {
        k: v.shape for k, v in init_j(jc, 2, jnp.float32).items()}
    ys = [dec_t(m, torch.from_numpy(x[:, t:t + 1]), empty, tc)[0]
          for t in range(9)]
    f32_close(torch.cat(ys, 1).numpy(), full.numpy(), "decode every token")


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_mixer_grads_match_jax_value_and_grad(kind):
    jc, jp, tc, m = mixer_pair(kind, "float32")
    x, gy = rand(11, 2, 16, tc.d_model), rand(12, 2, 16, tc.d_model)

    def f(p, x_):
        return jnp.sum(_fwd(kind, True)(p, x_, jc) * gy)

    val, (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    m.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = (_fwd(kind, False)(m, tx, tc) * torch.from_numpy(gy)).sum()
    out.backward()
    f32_close(float(out.detach()), float(val), "value")
    for name, p in m.named_parameters():
        bound = GRAD_RTOL * max(1.0, float(np.abs(gp[name]).max()))
        assert float(np.abs(p.grad.numpy() - np.asarray(gp[name])).max()) \
            <= bound, name
    f32_close(tx.grad.numpy(), np.asarray(gx), "dx")


# ---------------------------------------------------------------------------
# the LM against repro's
# ---------------------------------------------------------------------------


def _scaled(arch, which):
    """(JAX cfg, port cfg): the smoke config, or the published widths cut
    to one layer pattern period (recurrentgemma-2b's vocabulary cut to
    1024)."""
    j, t = jax_get_arch(arch), get_arch(arch)
    if which == "smoke":
        return j.smoke(), t.smoke()
    over = dict(num_layers=len(j.layer_pattern))
    if arch == "recurrentgemma-2b":
        over["vocab_size"] = 1024
    return j.scaled(**over), t.scaled(**over)


@functools.lru_cache(maxsize=None)
def lm_pair(arch, which):
    jc, tc = _scaled(arch, which)
    jmodel = jax_build_model(jc, JAX_SMOKE)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    lm = LM(tc, SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(lm, jax.tree.map(np.asarray, jparams))
    return jc, jmodel, jparams, tc, lm


CASES = [(a, w) for a in ARCHS for w in ("smoke", "period")]


@pytest.mark.parametrize("arch,which", CASES)
def test_lm_loss_and_grads_match_jax(arch, which):
    jc, jmodel, jparams, tc, lm = lm_pair(arch, which)
    toks = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 12)
                                             ).astype(np.int32)
    t = jnp.asarray(toks)
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {"tokens": t, "labels": t})
    want = bridge.state_dict_from_jax(jax.tree.map(np.asarray, grads), tc)
    lm.requires_grad_(True)
    try:
        tt = torch.from_numpy(toks)
        got = lm.loss({"tokens": tt, "labels": tt})
        got.backward()
        assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss))
        for name, p in lm.named_parameters():
            w = want[name].numpy()
            bound = GRAD_RTOL * max(1.0, float(np.abs(w).max()))
            assert float(np.abs(p.grad.numpy() - w).max()) <= bound, name
    finally:
        lm.requires_grad_(False)
        for p in lm.parameters():
            p.grad = None


@pytest.mark.parametrize("arch,which", CASES)
def test_prefill_and_decode_steps_match_jax(arch, which):
    """A 10-token prompt (past recurrentgemma's smoke window of 8), then
    three greedy decode steps: logits and every layer's cache ({"h",
    "conv"} or the sliding-window K/V) against ``repro``'s."""
    jc, jmodel, jparams, tc, lm = lm_pair(arch, which)
    B, S, s_max = 2, 10, 16
    toks = np.random.default_rng(7).integers(1, tc.vocab_size, (B, S)
                                             ).astype(np.int32)
    jlogits, jcaches = jax.jit(functools.partial(
        jmodel.prefill, s_max=s_max))(jparams, jnp.asarray(toks))
    jdecode = jax.jit(jmodel.decode_step)
    logits, caches = lm.prefill(torch.from_numpy(toks), s_max=s_max)
    f32_close(logits.numpy(), np.asarray(jlogits), "prefill")

    def caches_close(step):
        want = bridge.unstack_layers(jax.tree.map(np.asarray, jcaches), tc)
        for li, (g, w) in enumerate(zip(caches, want)):
            assert sorted(g) == sorted(w), li
            for k in w:
                f32_close(g[k].numpy(), w[k], f"{step} layer {li} {k}")

    caches_close("prefill")
    idx = np.full((B,), S, np.int32)
    tok = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None]
    for t in range(3):
        jlogits, jcaches = jdecode(jparams, jnp.asarray(tok), jcaches,
                                   jnp.asarray(idx + t))
        logits, caches = lm.decode_step(torch.from_numpy(tok), caches,
                                        torch.from_numpy(idx + t))
        f32_close(logits.numpy(), np.asarray(jlogits), f"decode {t}")
        caches_close(f"decode {t}")
        tok = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None]
    fresh = lm.init_cache(B, s_max)
    assert all(f[n].shape == c[n].shape and f[n].dtype == c[n].dtype
               for f, c in zip(fresh, caches) for n in c)


# ---------------------------------------------------------------------------
# serving, configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_dense_with_jax_greedy_tokens(arch):
    """Both archs take the dense engine (no paged path for a recurrent
    state), grouped by prompt length so no recurrent state sees a pad
    token: greedy tokens identical to ``repro``'s engine."""
    jc, jmodel, jparams, tc, lm = lm_pair(arch, "smoke")
    prompts = [np.arange(1, 8, dtype=np.int32),
               np.arange(9, 14, dtype=np.int32),
               np.arange(30, 37, dtype=np.int32)]
    kw = dict(max_batch=2, s_max=16)
    want = JaxEngine(jmodel, jparams, jc, JAX_SMOKE, JaxServeConfig(**kw)
                     ).run([JaxRequest(rid=i, prompt=p, max_new_tokens=4)
                            for i, p in enumerate(prompts)])
    eng = Engine(lm, tc, SMOKE, ServeConfig(**kw), device="cpu")
    assert not eng.paged
    got = eng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                   for i, p in enumerate(prompts)])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert eng.steps == 8          # 2 length groups: 1 prefill + 3 decode
    with pytest.raises(NotImplementedError, match="paged"):
        lm.serve_step(torch.zeros(1, 1, dtype=torch.int32), [], None)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_and_trains(arch):
    eng, reqs = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                            "--requests", "2", "--max-new", "3"])
    assert all(len(r.out_tokens) == 3 for r in reqs) and eng.steps == 3
    from repro_torch.launch import train

    trainer = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--steps", "2"])
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_registry(arch):
    t, j = get_arch(arch), jax_get_arch(arch)
    assert t.param_count() == j.param_count() == {
        "mamba2-130m": 128_983_488, "recurrentgemma-2b": 2_658_736_640}[arch]
    assert t.smoke().param_count() == j.smoke().param_count()
    assert t.sub_quadratic and t.layer_kinds() == j.layer_kinds()
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro_torch.configs.registry import ARCHS

    # the registry holds every arch of repro's, arctic-480b included
    assert set(ARCHS) == set(JAX_ARCHS)
    with pytest.raises(ValueError, match="not ported"):
        t.scaled(layer_pattern=("xattn",)).layer_kinds()
