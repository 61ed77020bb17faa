"""Serving over a flat TP ring against the JAX package on the CPU: the port's
counterpart of ``tests/multidev_checks.py``'s ``decode.*``,
``serve.mixed_vs_single.*``, ``serve.backend_dispatch_gemm_ar`` and
``train_grad.decode_gemm_ar.*`` cells, on gloo rings of 2 and 4 ranks at
smoke widths, in f32, each held to JAX on one CPU device within 1e-5:

- ``sp_block(..., seq_sharded=False)`` on a ring (the
  replicated-activation layout) at S = 1 and S = 3, ``barrier`` and
  ``cais``, against JAX's ``block_forward``, and its graph-built grads (x
  and every weight, the replicated norm scales and K/V included, not
  multiplied by the ring size) against ``jax.grad``;
- ``LM.serve_step`` over the four-step prefill/decode/prefill/mixed
  schedule of ``multidev_checks.py`` plus a mixed step whose length splits
  over the ring, on deepseek-7b (kv heads sharded) and gemma3-1b (one kv
  head replicated, sliding window), against JAX's ``serve_step``; the
  mixed step against the single-mode steps within 1e-6; the final pools
  against JAX's (this rank's heads);
- the ``gemm_ar`` dispatches through the backend, forward and backward, and
  the matmul and flash calls against the graph-derived counts;
- the ring ``Engine``'s greedy tokens against the one-device port
  ``Engine``'s, with every step's logits bitwise equal across ranks.

The ranks run in their own processes (``tests/torch_rank_cells.py``, no
JAX), spawned once per world size."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.attention import KVView as JaxKVView  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402

import torch_rank_cells as cells  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import tp as tp_mod  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.runtime import SMOKE  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MIXED_TOL = 1e-6            # multidev_checks' serve.mixed_vs_single pin
BLOCK_ARCH = "internlm2-1.8b"
BLOCK_S = (1, 3)
# deepseek-7b with 4 kv heads shards them at 2 and 4 ranks (as
# multidev_checks' serve cells); gemma3-1b's one kv head replicates, and a
# window of 4 slides inside the schedule's 7 positions
SERVE = {"deepseek-7b": dict(num_layers=2, num_kv_heads=4),
         "gemma3-1b": dict(window=4)}
ENGINE_ARCH = "deepseek-7b"
ENGINE_PROMPTS = [(np.arange(1, 20) % 256).astype(np.int32),
                  np.arange(40, 46, dtype=np.int32),
                  (np.arange(1, 20) % 256).astype(np.int32)]
ENGINE_KW = dict(max_batch=2, max_active=2, s_max=32, block_size=4,
                 prefill_chunk=4)


def schedule():
    """multidev_checks' steps over two rows (block tables [[0, 1], [2, 3]],
    block size 4): row 0 prefills 5 tokens, decodes one, row 1 prefills 3,
    then a mixed step repeats row 0's decode beside row 1's prefill; then a
    mixed step of length 4 (splits over 2 and 4 ranks): row 0 decodes at 6,
    row 1 prefills positions 3..6. Returns [(tokens, (bt, pos, ctx,
    last))]."""
    bt = np.array([[0, 1], [2, 3]], np.int32)
    a = np.array
    return [
        (a([[1, 2, 3, 4, 5], [0] * 5], np.int32),
         (bt, a([[0, 1, 2, 3, 4], [-1] * 5], np.int32), a([5, 0], np.int32),
          a([4, 0], np.int32))),
        (a([[7], [0]], np.int32),
         (bt, a([[5], [-1]], np.int32), a([6, 0], np.int32),
          a([0, 0], np.int32))),
        (a([[0] * 3, [9, 8, 7]], np.int32),
         (bt, a([[-1] * 3, [0, 1, 2]], np.int32), a([0, 3], np.int32),
          a([0, 2], np.int32))),
        (a([[7, 0, 0], [9, 8, 7]], np.int32),
         (bt, a([[5, -1, -1], [0, 1, 2]], np.int32), a([6, 3], np.int32),
          a([0, 2], np.int32))),
        (a([[11, 0, 0, 0], [3, 5, 7, 9]], np.int32),
         (bt, a([[6, -1, -1, -1], [3, 4, 5, 6]], np.int32),
          a([7, 7], np.int32), a([0, 3], np.int32))),
    ]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def block_case():
    """(numpy block params with random norm scales, {S: x}, {S: (JAX
    block_forward output, (dx, dparams) of mean(out²))}) on one device."""
    cfg = jax_get_arch(BLOCK_ARCH).smoke()
    params = _np(jtr.init_block(jax.random.key(25), "attn", cfg,
                                jnp.float32))
    rng = np.random.default_rng(27)
    for norm in ("norm1", "norm2"):
        params[norm]["scale"] = 0.1 * rng.standard_normal(
            params[norm]["scale"].shape).astype(np.float32)
    x_full = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    xs = {S: x_full[:, :S].copy() for S in BLOCK_S}

    def loss(x, p):
        out, _ = jtr.block_forward("attn", p, x, cfg, JAX_SMOKE)
        return jnp.mean(out ** 2), out

    grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    want = {}
    for S, x in xs.items():
        (_, out), grads = grad(jnp.asarray(x), params)
        want[S] = (np.asarray(out), _np(grads))
    return params, xs, want


@functools.lru_cache(maxsize=None)
def serve_case(arch):
    """(numpy params, JAX serve_step logits per step, final pools per
    layer) on one device."""
    cfg = jax_get_arch(arch).smoke().scaled(**SERVE[arch])
    model = jax_build_model(cfg, JAX_SMOKE)
    params = model.init(jax.random.key(31))
    pools = model.init_pools(8, 4)
    step = jax.jit(model.serve_step)
    logits = []
    for toks, view in schedule():
        lg, pools = step(params, jnp.asarray(toks), pools,
                         JaxKVView(*map(jnp.asarray, view)))
        logits.append(np.asarray(lg))
    return _np(params), logits, bridge.unstack_layers(_np(pools), cfg)


@functools.lru_cache(maxsize=None)
def engine_case():
    """(numpy params, the one-device port Engine's greedy tokens)."""
    cfg = get_arch(ENGINE_ARCH).smoke().scaled(**SERVE[ENGINE_ARCH])
    params, _, _ = serve_case(ENGINE_ARCH)
    lm = LM(cfg, SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(lm, params)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(ENGINE_PROMPTS)]
    Engine(lm, cfg, SMOKE, ServeConfig(**ENGINE_KW), device="cpu").run(
        reqs, seed=0)
    return params, [r.out_tokens for r in reqs]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ring(request):
    params, xs, _ = block_case()
    serve = ({a: (SERVE[a], serve_case(a)[0]) for a in SERVE}, schedule())
    engine = (ENGINE_ARCH, SERVE[ENGINE_ARCH], engine_case()[0],
              ENGINE_PROMPTS, 4, ENGINE_KW)
    return request.param, run_ranks(cells.serve_tp_cells, request.param,
                                    (BLOCK_ARCH, params, xs), serve, engine)


def _shard(a, name, cfg, r, n):
    dim = tp_mod.param_shard_dim("blocks.0." + name, cfg, n)
    if dim is None:
        return a
    s = a.shape[dim] // n
    return np.take(a, range(r * s, (r + 1) * s), axis=dim)


BLOCK_RUNS = [(S, m) for S in BLOCK_S for m in ("barrier", "cais")]


@pytest.mark.parametrize("run", BLOCK_RUNS,
                         ids=[f"s{S}-{m}" for S, m in BLOCK_RUNS])
def test_decode_block_matches_jax(ring, run):
    """decode.s1_block_parity / decode.ragged_s_parity against one JAX
    device, and decode.s1_backend_dispatch: one gemm_ar a sub-layer."""
    n, res = ring
    S, mode = run
    want, _ = block_case()[2][S]
    for r in res:
        out, _, _, (fwd_ar, _), _, _ = r[("block", S, mode)]
        np.testing.assert_allclose(out, want, **TOL)
        assert fwd_ar == 2
    assert not any(r["_jax_imported"] for r in res)


@pytest.mark.parametrize("run", BLOCK_RUNS,
                         ids=[f"s{S}-{m}" for S, m in BLOCK_RUNS])
def test_decode_block_grads_match_jax(ring, run):
    """train_grad.decode_gemm_ar.{s1,ragged_s3}: x and every weight against
    jax.grad on one device, each rank's shard; the replicated weights' grads
    are complete on every rank (not summed over the ring)."""
    n, res = ring
    S, mode = run
    cfg = get_arch(BLOCK_ARCH).smoke()
    _, (dx_want, dp_want) = block_case()[2][S]
    flat = {f"{m}.{leaf}": g for m, sub in dp_want.items()
            for leaf, g in sub.items()}
    for rank, r in enumerate(res):
        _, dx, dws, _, _, _ = r[("block", S, mode)]
        np.testing.assert_allclose(dx, dx_want, **TOL)
        assert dws.keys() == flat.keys()
        for name, g in dws.items():
            np.testing.assert_allclose(
                g, _shard(flat[name], name, cfg, rank, n), **TOL,
                err_msg=name)


@pytest.mark.parametrize("run", BLOCK_RUNS,
                         ids=[f"s{S}-{m}" for S, m in BLOCK_RUNS])
def test_decode_block_dispatch_and_calls(ring, run):
    """train_grad.decode_gemm_ar.backend_dispatch: the backward dispatches
    more gemm_ar than the forward's two (each gemm_col adjoint is one); the
    matmul calls equal the forward and training graphs' counts."""
    n, res = ring
    for r in res:
        _, _, _, (fwd_ar, bwd_ar), made, derived = r[("block",) + run]
        assert bwd_ar > fwd_ar >= 2
        assert list(made) == derived and min(derived) > 0


SERVE_RUNS = [(a, m) for a in SERVE for m in ("barrier", "cais")]


@pytest.mark.parametrize("run", SERVE_RUNS,
                         ids=["-".join(r) for r in SERVE_RUNS])
def test_serve_step_matches_jax(ring, run):
    n, res = ring
    arch, mode = run
    _, want, want_pools = serve_case(arch)
    cfg = get_arch(arch).smoke().scaled(**SERVE[arch])
    kv = cfg.num_kv_heads
    for rank, r in enumerate(res):
        logits, pools, _ = r[("serve",) + run]
        for got, w, (_, view) in zip(logits, want, schedule()):
            # padding rows differ by design (zeros here, the mean of v in
            # JAX) and are never read
            live = view[1][np.arange(2), view[3]] >= 0
            np.testing.assert_allclose(got[live], w[live], **TOL)
        for got, w in zip(pools, want_pools):
            for name in ("k", "v"):
                wp = w[name]
                if kv % n == 0:
                    s = kv // n
                    wp = wp[:, :, rank * s:(rank + 1) * s]
                np.testing.assert_allclose(got[name], wp, **TOL)
    for step in range(len(want)):           # every rank the same logits
        assert all(np.array_equal(r[("serve",) + run][0][step],
                                  res[0][("serve",) + run][0][step])
                   for r in res)


@pytest.mark.parametrize("run", SERVE_RUNS,
                         ids=["-".join(r) for r in SERVE_RUNS])
def test_serve_mixed_matches_single(ring, run):
    """serve.mixed_vs_single: the mixed step's rows equal the same rows
    served in the single-mode steps."""
    n, res = ring
    for r in res:
        lg = r[("serve",) + run][0]
        err = max(np.abs(lg[3][0] - lg[1][0]).max(),
                  np.abs(lg[3][1] - lg[2][1]).max())
        assert err <= MIXED_TOL


@pytest.mark.parametrize("run", SERVE_RUNS,
                         ids=["-".join(r) for r in SERVE_RUNS])
def test_serve_dispatch_and_calls(ring, run):
    """serve.backend_dispatch_gemm_ar, per call: two gemm_ar a layer each
    step (the port executes every call); matmul calls equal matmul_calls of
    the optimized serve graphs; one flash call a layer a step."""
    n, res = ring
    cfg = get_arch(run[0]).smoke().scaled(**SERVE[run[0]])
    for r in res:
        for ar, made, derived, flash in r[("serve",) + run][2]:
            assert ar == 2 * cfg.num_layers
            assert made == derived > 0
            assert flash == cfg.num_layers


def test_engine_on_the_ring(ring):
    n, res = ring
    _, want = engine_case()
    for r in res:
        tokens, logits, steps = r["engine"]
        assert tokens == want
        assert len(logits) == steps > 0
        for got, ref in zip(logits, res[0]["engine"][1]):
            assert np.array_equal(got, ref)     # bitwise across ranks
