"""arctic-480b (128 experts top-2 beside a dense residual MLP, trained with
adafactor) in the port against the JAX package on the CPU, f32, at smoke
size (4 experts, group 16): the config and its parameter count, the
bf16-parameter runtime, ``LM.loss`` and its grads, the prefill and decode
logits, three ``Trainer`` steps with adafactor against JAX's ``Trainer``,
the paged ``Engine``'s greedy tokens against ``repro.serve.Engine``'s, and
one adafactor train step on gloo rings of 2 and 4 (experts split by whole
expert; ``tests/torch_rank_cells.py``, no JAX) against JAX's one device.

Routing is discrete: each comparison holds where the routing is the same
function on both sides, as ``tests/test_torch_moe.py`` arranges it: the
ring routes each rank's B·S_loc tokens as one group and one device groups
of ``group_size`` over the batch-major flattening, one function at B = 1
and S_loc = group_size (S = 16·world)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.launch.specs import runtime_for as jax_runtime_for  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402
from repro.train import Trainer as JaxTrainer  # noqa: E402
from repro.train import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa

import torch_rank_cells as cells  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.core.tp import param_shard_dim  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import LM, build_model  # noqa: E402
from repro_torch.optim import constant_schedule, make_optimizer  # noqa: E402
from repro_torch.runtime import SMOKE, runtime_for  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

ARCH = "arctic-480b"
TOL = dict(rtol=1e-5, atol=1e-5)     # f32, the same math summed in orders
GRAD_RTOL = 1e-5                     # per tensor: 1e-5 * max(1, max|g|)
WORLDS = (2, 4)
LR = 1e-3


def _np(t):
    return t.detach().cpu().numpy()


@functools.lru_cache(maxsize=None)
def pair():
    """(JAX smoke cfg, its model, numpy params from key 0, the port's cfg,
    the port's LM holding the same params)."""
    jc, tc = jax_get_arch(ARCH).smoke(), get_arch(ARCH).smoke()
    jm = jax_build_model(jc, JAX_SMOKE)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    lm = LM(tc, SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(lm, params)
    return jc, jm, params, tc, lm


def test_config_param_count_and_runtime_equal_repro():
    for smoke in (False, True):
        j, t = jax_get_arch(ARCH), get_arch(ARCH)
        if smoke:
            j, t = j.smoke(), t.smoke()
        assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
        assert t.param_count() == j.param_count()
        assert t.optimizer == j.optimizer == "adafactor"
    # 480 B parameters: bf16 parameters, as JAX's runtime gives them
    assert get_arch(ARCH).param_count() > 4.7e11
    rt, jrt = runtime_for(get_arch(ARCH)), jax_runtime_for(
        jax_get_arch(ARCH))
    assert (rt.param_dtype, rt.compute_dtype) == \
        (jrt.param_dtype, jrt.compute_dtype) == ("bfloat16", "bfloat16")
    _, _, params, tc, lm = pair()
    assert tc.moe.dense_residual_d_ff == 64 and lm.blocks[0].ffn.dense
    assert sum(p.numel() for p in lm.parameters()) == tc.param_count()


@functools.lru_cache(maxsize=None)
def tokens():
    return np.random.default_rng(3).integers(0, 256, (2, 32)).astype(
        np.int32)


def test_loss_and_grads_match_jax():
    jc, jm, params, tc, lm = pair()
    t = tokens()
    batch = {"tokens": jnp.asarray(t), "labels": jnp.asarray(t)}
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, batch)
    want = bridge.state_dict_from_jax(jax.tree.map(np.asarray, grads), tc)
    lm.requires_grad_(True)
    try:
        got = lm.loss({"tokens": torch.from_numpy(t),
                       "labels": torch.from_numpy(t)})
        got.backward()
        got = float(got.detach())
        assert abs(got - float(loss)) <= 1e-5 * abs(float(loss))
        for name, p in lm.named_parameters():
            g = want[name].numpy()
            bound = GRAD_RTOL * max(1.0, float(np.abs(g).max()))
            assert float(np.abs(_np(p.grad) - g).max()) <= bound, name
        # the dense residual MLP and every expert take part
        assert all(float(lm.blocks[0].ffn.get_parameter(k).grad.abs().max())
                   > 0 for k in ("dense.w_up", "w_up", "router"))
    finally:
        for p in lm.parameters():
            p.grad = None
        lm.requires_grad_(False)


def test_prefill_and_decode_logits_match_jax():
    """A 32-token prompt, then three greedy decode steps: the logits
    against ``repro``'s (every step routes its tokens as JAX's does)."""
    jc, jm, params, tc, lm = pair()
    t = tokens()
    B, S, s_max = t.shape[0], t.shape[1], 40
    jl, jcache = jax.jit(functools.partial(jm.prefill, s_max=s_max))(
        params, jnp.asarray(t))
    logits, caches = lm.prefill(torch.from_numpy(t), s_max=s_max)
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **TOL)
    jdecode = jax.jit(jm.decode_step)
    idx = np.full((B,), S, np.int32)
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for k in range(3):
        jl, jcache = jdecode(params, jnp.asarray(tok), jcache,
                             jnp.asarray(idx + k))
        logits, caches = lm.decode_step(torch.from_numpy(tok), caches,
                                        torch.from_numpy(idx + k))
        np.testing.assert_allclose(_np(logits), np.asarray(jl), **TOL)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


TRAIN_STEPS = 3


def test_trainer_adafactor_matches_jax():
    """Three ``Trainer`` steps (adafactor, the arch's optimizer; the data
    pipeline keyed on the step) from the same parameters: every parameter
    within 1e-5 of JAX's ``Trainer``, every step's loss within 1e-5."""
    jc, jm, params, tc, _ = pair()
    shape = (16, 4)
    jtr = JaxTrainer(jm, jopt.make_optimizer(jc.optimizer,
                                             jopt.constant_schedule(LR)),
                     jc, JShapeConfig("t", *shape, "train"), JAX_SMOKE,
                     JaxTrainerConfig(total_steps=TRAIN_STEPS,
                                      log_every=100))
    jstate = jtr.run()
    lm = build_model(tc, SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(lm, params)
    tr = Trainer(lm, make_optimizer(tc.optimizer, constant_schedule(LR)),
                 tc, ShapeConfig("t", *shape, "train"), SMOKE,
                 TrainerConfig(total_steps=TRAIN_STEPS, log_every=0))
    state = tr.run()
    assert tr.opt.name == "adafactor"
    for a, b in zip(tr.history, jtr.history):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
    want = bridge.state_dict_from_jax(jax.tree.map(np.asarray,
                                                   jstate["params"]), tc)
    for k, p in state["params"].items():
        np.testing.assert_allclose(_np(p), want[k].numpy(), rtol=0,
                                   atol=1e-5)
    # the state is JAX's too: the same groups, within 1e-5 of their scale
    jopt_state = bridge.train_state_from_jax(
        {"params": jstate["params"], "opt": jax.tree.map(
            np.asarray, jstate["opt"]), "step": jstate["step"]}, tc)["opt"]
    for g, st in jopt_state.items():
        for s_, w in st.items():
            got = _np(state["opt"][g][s_])
            np.testing.assert_allclose(got, w.numpy(), rtol=1e-5, atol=0)


def test_engine_greedy_matches_jax():
    from repro.serve import Engine as JaxEngine
    from repro.serve import Request as JaxRequest
    from repro.serve import ServeConfig as JaxServeConfig
    from repro_torch.serve import Engine, Request, ServeConfig
    from repro_torch.serve.engine import paged_supported

    jc, jm, params, tc, lm = pair()
    long = (np.arange(1, 20) % tc.vocab_size).astype(np.int32)
    short = np.arange(40, 46, dtype=np.int32)
    prompts = [long, short, long]
    kw = dict(max_batch=2, max_active=2, s_max=32, block_size=4,
              prefill_chunk=4)
    jeng = JaxEngine(jm, jax.tree.map(jnp.asarray, params), jc, JAX_SMOKE,
                     JaxServeConfig(**kw))
    want = jeng.run([JaxRequest(rid=i, prompt=p, max_new_tokens=4)
                     for i, p in enumerate(prompts)])
    assert paged_supported(lm, tc)
    eng = Engine(lm, tc, SMOKE, ServeConfig(**kw), device="cpu")
    got = eng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                   for i, p in enumerate(prompts)])
    assert eng.paged
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]


# ---------------------------------------------------------------------------
# one adafactor step on a ring: experts split by whole expert
# ---------------------------------------------------------------------------


def ring_tokens(n):
    return np.random.default_rng(20 + n).integers(0, 256, (1, 16 * n)) \
        .astype(np.int32)


@functools.lru_cache(maxsize=None)
def ring_spawns():
    """Both spawns at once in threads (the ranks run while this process
    computes JAX's steps)."""
    from concurrent.futures import ThreadPoolExecutor

    _, _, params, tc, _ = pair()
    pool = ThreadPoolExecutor(len(WORLDS))
    futures = {n: pool.submit(
        run_ranks, cells._moe_step_cell, n, tc, params,
        {"tokens": ring_tokens(n), "labels": ring_tokens(n)}, LR,
        "adafactor") for n in WORLDS}
    pool.shutdown(wait=False)
    return futures


@functools.lru_cache(maxsize=None)
def jax_step(n):
    """One JAX adafactor step on one device: (loss, grad norm, {param:
    updated value})."""
    jc, jm, params, tc, _ = pair()
    o = jopt.adafactor(jopt.constant_schedule(LR))
    p = jax.tree.map(jnp.asarray, params)
    state = {"params": p, "opt": o.init(p), "step": jnp.zeros((), jnp.int32)}
    t = jnp.asarray(ring_tokens(n))
    state, m = jax.jit(jax_make_train_step(jm, o, JAX_SMOKE))(
        state, {"tokens": t, "labels": t})
    new = bridge.state_dict_from_jax(jax.tree.map(np.asarray,
                                                  state["params"]), tc)
    return (float(m["loss"]), float(m["grad_norm"]),
            {k: v.numpy() for k, v in new.items()})


@pytest.mark.parametrize("n", WORLDS)
def test_ring_adafactor_step_matches_one_device(n):
    """One cais ring step with adafactor (the expert leaves split by whole
    expert, their Σu² summed over the ring; wk/wv whole at world 4) against
    JAX's one-device step: loss and grad norm within 1e-5, every
    parameter within 1e-5."""
    futures = ring_spawns()
    loss, gnorm, want = jax_step(n)
    _, _, _, tc, _ = pair()
    res = futures[n].result()
    assert abs(res[0][0] - loss) <= 1e-5 * abs(loss)
    assert abs(res[0][1] - gnorm) <= 1e-5 * abs(gnorm)
    assert param_shard_dim("blocks.0.ffn.w_up", tc, n) == 0
    for name, w in want.items():
        dim = param_shard_dim(name, tc, n)
        parts = [r[2][name] for r in res]
        got = parts[0] if dim is None else np.concatenate(parts, axis=dim)
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5, err_msg=name)
