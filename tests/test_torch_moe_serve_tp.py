"""MoE serving on a TP ring against the JAX package on the CPU, in f32, on
gloo rings of 2 and 4 ranks at smoke widths: mixtral-8x7b's smoke config (4
experts, sliding window), arctic-480b's (4 experts beside a dense residual
MLP of 64) and mixtral's with 3 experts (E % ring != 0: every rank holds
and runs them all, with no reduction).

- ``LM.serve_step`` over the prefill / decode / prefill / mixed schedule
  of ``tests/multidev_checks.py`` (plus a mixed step whose length splits
  over the ring), ``barrier`` and ``cais``, flat and, at world 4, on a
  tp_in 2 x tp_out 2 mesh (grouped EP), against JAX's ``serve_step`` on one
  device: routing first (equal, or different only at gaps below
  ``ROUTE_TOL``), then the live rows' logits within 1e-5 and the final
  pools (this rank's kv heads) where routing agreed;
- routing and logits bitwise equal across ranks, padding rows routed (and
  taking capacity) as JAX routes them;
- every expert computed once over the TP group (or by every rank where
  they replicate); the matmul and flash calls and the MoE's all-reduce
  nodes against the recorded serve graphs' counts (one all-reduce an MoE
  layer a step);
- ``planner="perfsim"``: logits bitwise greedy's, no plan-cache lookup;
- the ring ``Engine``'s greedy tokens against the one-device port
  ``Engine``'s and JAX's.

The ranks run in their own processes (``tests/torch_moe_serve_cells.py``,
no JAX), spawned once per world size."""
import dataclasses
import functools
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models.attention import KVView as JaxKVView  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
import torch_moe_serve_cells as cells  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.runtime import SMOKE  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402
from test_torch_serve_tp import schedule  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# name: (arch, overrides, JAX init key)
CASES = {"mixtral": ("mixtral-8x7b", {}, 0),
         "arctic": ("arctic-480b", {}, 1),
         "e3": ("mixtral-8x7b", {"moe": {"num_experts": 3}}, 2)}
MESH_2D = dict(tp_in=2, tp_out=2)
# (case, mode, planner, mesh) a world runs
RUNS = {2: [("mixtral", "barrier", "greedy", None),
            ("mixtral", "cais", "greedy", None),
            ("mixtral", "cais", "perfsim", None),
            ("arctic", "cais", "greedy", None),
            ("e3", "cais", "greedy", None)],
        4: [("mixtral", "barrier", "greedy", None),
            ("mixtral", "cais", "greedy", None),
            ("mixtral", "cais", "perfsim", None),
            ("mixtral", "cais", "greedy", MESH_2D),
            ("arctic", "cais", "greedy", None),
            ("arctic", "barrier", "greedy", MESH_2D),
            ("e3", "cais", "greedy", None)]}
ALL_RUNS = [(n,) + r for n in sorted(RUNS) for r in RUNS[n]]
ENGINE_PROMPTS = [(np.arange(1, 20) % 256).astype(np.int32),
                  np.arange(40, 46, dtype=np.int32),
                  (np.arange(1, 20) % 256).astype(np.int32)]
ENGINE_KW = dict(max_batch=2, max_active=2, s_max=32, block_size=4,
                 prefill_chunk=4)


def _run_id(run):
    n, case, mode, planner, mesh = run
    return f"w{n}-{case}-{mode}" + ("-perfsim" if planner == "perfsim"
                                    else "") + ("-2d" if mesh else "")


def _cfgs(name):
    """(JAX cfg, port cfg) of a case."""
    arch, over, _ = CASES[name]
    over = dict(over)
    moe = over.pop("moe", {})
    j, t = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    return (j.scaled(moe=dataclasses.replace(j.moe, **moe), **over),
            t.scaled(moe=dataclasses.replace(t.moe, **moe), **over))


@functools.lru_cache(maxsize=None)
def jax_params(name):
    """(the JAX model, its params, numpy params) of a case."""
    jc, _ = _cfgs(name)
    model = jax_build_model(jc, JAX_SMOKE)
    params = model.init(jax.random.key(CASES[name][2]))
    return model, params, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """(JAX serve_step logits per step, final pools per layer, routing
    records (one a layer a step)) on one device."""
    _, tc = _cfgs(name)
    model, params, _ = jax_params(name)
    rec = []
    inner = jffn._top2_dispatch

    def recorded(probs, capacity):
        out = inner(probs, capacity)
        jax.debug.callback(lambda p, d: rec.append(CS.compact_routing(
            torch.from_numpy(np.array(p)), torch.from_numpy(np.array(d)))),
            probs, out[0], ordered=True)
        return out

    jffn._top2_dispatch = recorded
    try:
        step = jax.jit(model.serve_step)
        pools = model.init_pools(8, 4)
        logits = []
        for toks, view in schedule():
            lg, pools = step(params, jnp.asarray(toks), pools,
                             JaxKVView(*map(jnp.asarray, view)))
            logits.append(np.asarray(lg))
    finally:
        jffn._top2_dispatch = inner
    return (logits, bridge.unstack_layers(jax.tree.map(np.asarray, pools),
                                          tc), rec)


def _spawn(n):
    cases = {}
    for case, mode, planner, mesh in RUNS[n]:
        arch, over, _ = CASES[case]
        entry = cases.setdefault(case, (arch, over, jax_params(case)[2], []))
        entry[3].append((mode, planner, mesh))
    with tempfile.TemporaryDirectory() as root:
        return run_ranks(cells.serve_cells, n, cases, schedule(),
                         ("mixtral", ENGINE_PROMPTS, 4, ENGINE_KW), root)


@functools.lru_cache(maxsize=None)
def _ring_spawns():
    """Both spawns (one per world size) started at once in threads, so the
    ranks run while this process computes the JAX references."""
    from concurrent.futures import ThreadPoolExecutor

    for name in CASES:
        jax_params(name)
    pool = ThreadPoolExecutor(len(RUNS))
    futures = {n: pool.submit(_spawn, n) for n in RUNS}
    pool.shutdown(wait=False)
    return futures


@pytest.fixture(scope="module", autouse=True)
def _start_ring_spawns():
    """Start the spawns with the module's first test."""
    _ring_spawns()


def ring_run(n):
    """Every case of one spawn of ``n`` gloo ranks, one result a rank."""
    return _ring_spawns()[n].result()


def _result(run):
    n, case, mode, planner, mesh = run
    return [r[(case, mode, planner, mesh is not None)] for r in ring_run(n)]


def _held(routes, want, layers):
    """(routing diff, the steps held: those before the first step with a
    routing difference)."""
    diff = CS.routing_differences(routes, want)
    first = diff["first"]
    return diff, len(schedule()) if first is None else first // layers


@pytest.mark.parametrize("run", ALL_RUNS, ids=[_run_id(r) for r in ALL_RUNS])
def test_serve_step_matches_jax(run):
    """Routing first, then the live rows' logits within 1e-5 and the final
    pools (this rank's kv heads) where routing agreed."""
    n, case = run[0], run[1]
    _, tc = _cfgs(case)
    want, want_pools, want_routes = jax_case(case)
    L = tc.num_layers
    for rank, (logits, pools, routes, _, _, _) in enumerate(_result(run)):
        assert len(routes) == len(want_routes) == len(schedule()) * L
        diff, held = _held(routes, want_routes, L)
        assert CS.routing_rule(diff), diff
        assert held > 0
        for got, w, (_, view) in zip(logits[:held], want, schedule()):
            # padding rows differ by design (zeros here, the mean of v in
            # JAX) and are never read
            live = view[1][np.arange(2), view[3]] >= 0
            np.testing.assert_allclose(got[live], w[live], **TOL)
        if held < len(schedule()):
            continue
        kv = tc.num_kv_heads
        for got, w in zip(pools, want_pools):
            for name in ("k", "v"):
                wp = w[name]
                if kv % n == 0:
                    s = kv // n
                    wp = wp[:, :, rank * s:(rank + 1) * s]
                np.testing.assert_allclose(got[name], wp, **TOL)
    assert not any(r["_jax_imported"] for r in ring_run(n))


@pytest.mark.parametrize("run", ALL_RUNS, ids=[_run_id(r) for r in ALL_RUNS])
def test_ranks_route_and_serve_bitwise_alike(run):
    """A rank that routed otherwise would corrupt the all-reduce silently:
    routing and logits are bitwise rank 0's at every step."""
    res = _result(run)
    head = res[0]
    for r in res[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(r[0], head[0]))
        for (g, p), (g0, p0) in zip(r[2], head[2]):
            assert np.array_equal(g, g0) and np.array_equal(p, p0)


@pytest.mark.parametrize("run", ALL_RUNS, ids=[_run_id(r) for r in ALL_RUNS])
def test_padding_rows_route_as_jax(run):
    """Every token of a step routes, padding included (a serving step's
    output depends on its batch): each record holds B·S tokens, and the
    padding tokens take the experts and capacity slots JAX gives them."""
    _, tc = _cfgs(run[1])
    L = tc.num_layers
    want = jax_case(run[1])[2]
    routes = _result(run)[0][2]
    padded = 0
    for i, (toks, view) in enumerate(schedule()):
        pad = (view[1] < 0).reshape(-1)
        for layer in range(L):
            got, w = routes[i * L + layer][0], want[i * L + layer][0]
            assert got.shape[0] == toks.size
            if _held(routes, want, L)[1] > i:
                assert np.array_equal(got[pad], w[pad])
                padded += int(pad.sum())
    assert padded > 0


@pytest.mark.parametrize("world", sorted(RUNS))
def test_every_expert_computed_once(world):
    """Split experts: the ranks' ranges partition [0, E) (on the 2D mesh
    tp_in splits each tp_out share); replicated (E % ring != 0): every rank
    computes all E."""
    for run in [(world,) + r for r in RUNS[world]]:
        _, tc = _cfgs(run[1])
        E = tc.moe.num_experts
        spans = [r[5] for r in _result(run)]
        if run[1] == "e3":
            assert all(s[:2] == (0, E) for s in spans)
            continue
        got = sorted(e for first, end, _ in spans for e in range(first, end))
        assert got == list(range(E)), spans


@pytest.mark.parametrize("run", ALL_RUNS, ids=[_run_id(r) for r in ALL_RUNS])
def test_calls_and_all_reduces_equal_the_serve_graphs(run):
    """Each step: flash once a layer; the matmul calls made equal
    ``tp.serve_launches`` of the recorded serve graphs; one gemm_ar a layer
    (the out-projection) and one all-reduce node an MoE layer where the
    experts split (none where they replicate); every all-reduce the group
    executed is one of those or a gemm_ar's monolithic fallback."""
    n, case, mode = run[:3]
    _, tc = _cfgs(case)
    L = tc.num_layers
    split = tc.moe.num_experts % (2 if run[4] else n) == 0
    for r in _result(run):
        for (toks, _), (ar, red, mm, flash, derived) in zip(schedule(),
                                                           r[3]):
            assert flash == derived["flash"] == L
            assert mm == derived["matmul"] > 0
            assert ar == L
            assert derived["allreduce"] == (L if split else 0)
            fallback = mode == "barrier" or toks.shape[1] % n
            assert red == derived["allreduce"] + (ar if fallback else 0)


@pytest.mark.parametrize("world", sorted(RUNS))
def test_perfsim_equals_greedy_and_plans_nothing(world):
    """JAX plans no MoE serve period: under perfsim the logits are bitwise
    greedy's and the plan cache is never consulted."""
    greedy = _result((world, "mixtral", "cais", "greedy", None))
    perfsim = _result((world, "mixtral", "cais", "perfsim", None))
    for p, g in zip(perfsim, greedy):
        assert all(np.array_equal(a, b) for a, b in zip(p[0], g[0]))
        assert p[4] == (0, 0, 0)


@functools.lru_cache(maxsize=None)
def engine_tokens():
    """(the one-device port Engine's greedy tokens, JAX's)."""
    jc, tc = _cfgs("mixtral")
    lm = LM(tc, SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(lm, jax_params("mixtral")[2])
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(ENGINE_PROMPTS)]
    Engine(lm, tc, SMOKE, ServeConfig(**ENGINE_KW), device="cpu").run(
        reqs, seed=0)
    jmodel, jparams, _ = jax_params("mixtral")
    want = JaxEngine(jmodel, jparams, jc, JAX_SMOKE,
                     JaxServeConfig(**ENGINE_KW)).run(
        [JaxRequest(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(ENGINE_PROMPTS)])
    return [r.out_tokens for r in reqs], [r.out_tokens for r in want]


@pytest.mark.parametrize("world", sorted(RUNS))
def test_engine_on_the_ring(world):
    one, jax_tokens = engine_tokens()
    assert one == jax_tokens
    res = ring_run(world)
    for r in res:
        tokens, logits = r["engine"]
        assert tokens == one
        assert len(logits) > 0
        assert all(np.array_equal(a, b)
                   for a, b in zip(logits, res[0]["engine"][1]))
