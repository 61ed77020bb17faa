"""The port's tensor-parallel training forward against the JAX package on the
CPU: ``LM.loss`` on a gloo ring of 2 and 4 ranks (``barrier`` and ``cais``,
1 and 2 microbatches) on the internlm2-1.8b and deepseek-7b smoke configs
with bridged parameters, within 1e-5 of JAX ``LM.loss`` on one CPU device;
the one-device port's loss likewise; the matmul calls a rank makes equal to
the count derived from the optimized period graphs; and the unported TP
paths raising with their ROADMAP item (paged serving on a ring is
``tests/test_torch_serve_tp.py``). In the world-4 spawn, multidev_checks'
``planner.perfsim_vs_greedy.{barrier,cais}`` cells: a 2-block period at 2
microbatches under the perfsim and the greedy planner, each within 1e-5 of
JAX's one-device blocks and within 1e-6 of each other, with the plans the
ranks cached equal to ``repro``'s ``_plan_period`` for the same ring, keys
included. The ranks run in their own processes
(``tests/torch_rank_cells.py``, no JAX), spawned once per world size."""
import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402
from repro import plan as jplan  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import tp as jtp  # noqa: E402
from repro.core.primitives import CAISConfig as JCAISConfig  # noqa: E402
from repro.hw import HWSpec as JHWSpec  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.plan import cache as jcache  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402

import torch_rank_cells as cells  # noqa: E402
from repro_torch import bridge, hw  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import tp as tp_mod  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.transformer import block_routes  # noqa: E402
from repro_torch.runtime import SMOKE, Runtime, TPConfig  # noqa: E402
from repro_torch.serve import DenseEngine  # noqa: E402
from repro_torch.sharding import TPGroup  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TP_ARCHS = ("internlm2-1.8b", "deepseek-7b")
TOKENS = np.random.default_rng(3).integers(0, 256, (2, 32)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_case(arch):
    """(numpy params, JAX LM.loss on one CPU device) at smoke size, f32."""
    model = jax_build_model(jax_get_arch(arch).smoke(), JAX_SMOKE)
    params = model.init(jax.random.key(0))
    toks = jnp.asarray(TOKENS)
    loss = float(model.loss(params, {"tokens": toks, "labels": toks}))
    return jax.tree.map(np.asarray, params), loss


PLANNER_ARCH = "internlm2-1.8b"


@functools.lru_cache(maxsize=None)
def planner_case():
    """(numpy trees of two blocks with random norm scales, x (2, 16, d),
    JAX's one-device output of the 2-block period)."""
    cfg = jax_get_arch(PLANNER_ARCH).smoke()
    rng = np.random.default_rng(61)
    trees = []
    for j in range(2):
        t = jax.tree.map(np.asarray, jtr.init_block(
            jax.random.key(60 + j), "attn", cfg, jnp.float32))
        for norm in ("norm1", "norm2"):
            t[norm]["scale"] = 0.1 * rng.standard_normal(
                t[norm]["scale"].shape).astype(np.float32)
        trees.append(t)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    y = jnp.asarray(x)
    for t in trees:
        y, _ = jtr.block_forward("attn", t, y, cfg, JAX_SMOKE)
    return trees, x, np.asarray(y)


def jax_period_plans(n: int, mode: str, root) -> dict:
    """{cache key: plan} of ``repro``'s ``_plan_period`` for the planner
    cells' period on a ring of ``n`` (an abstract mesh: planning reads
    shapes only), with the port's H100 spec."""
    cfg = jax_get_arch(PLANNER_ARCH).smoke()
    trees, x, _ = planner_case()
    tpc = jtp.TPContext(mesh=AbstractMesh((1, n), ("data", "model")),
                        backend=mode, cais=JCAISConfig(num_chunks=2),
                        planner="perfsim",
                        hw=JHWSpec(**dataclasses.asdict(hw.H100)))
    base, weights, _, _ = jtp._period_graph(tpc, trees, cfg,
                                            cells.PLANNER_KINDS)
    saved = jcache._DEFAULT
    jcache._DEFAULT = jplan.PlanCache(root=str(root))
    try:
        jtp._plan_period(tpc, base, weights,
                         jax.ShapeDtypeStruct(x.shape, jnp.float32), 2,
                         moe=False, comp_hints=jtp._core_comp_hints(
                             cfg, cells.PLANNER_KINDS, x.shape[0],
                             x.shape[1]))
    finally:
        jcache._DEFAULT = saved
    return cells._plans_on_disk(str(root))


@functools.lru_cache(maxsize=None)
def ring_run(n):
    """One spawn of ``n`` gloo ranks: every loss case, and at world 4 (as
    multidev_checks runs them) the planner cells."""
    cases = {a: jax_case(a)[0] for a in TP_ARCHS}
    if n != 4:
        return run_ranks(cells.loss_cells, n, cases, TOKENS)
    trees, x, _ = planner_case()
    with tempfile.TemporaryDirectory() as root:
        return run_ranks(cells.loss_cells, n, cases, TOKENS,
                         (PLANNER_ARCH, trees, x, root))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ring(request):
    return request.param, ring_run(request.param)


RUNS = [(a, m, mb) for a in TP_ARCHS for m in ("barrier", "cais")
        for mb in (1, 2)]


@pytest.mark.parametrize("run", RUNS, ids=["-".join(map(str, r))
                                           for r in RUNS])
def test_tp_loss_matches_jax(ring, run):
    n, res = ring
    losses = [r[run][0] for r in res]
    assert len(set(losses)) == 1            # every rank holds one loss
    np.testing.assert_allclose(losses[0], jax_case(run[0])[1], **TOL)


@pytest.mark.parametrize("run", RUNS, ids=["-".join(map(str, r))
                                           for r in RUNS])
def test_matmul_calls_match_the_graph(ring, run):
    n, res = ring
    for r in res:
        _, made, derived, overlaps = r[run]
        assert made == derived > 0
        assert (overlaps > 0) == (run[2] == 2)   # a split feeds pass 3


@pytest.mark.parametrize("mode", ["barrier", "cais"])
def test_perfsim_vs_greedy_matches_jax(mode):
    """planner.perfsim_vs_greedy.{mode} at world 4: the schedule may differ,
    the math may not."""
    res = ring_run(4)
    want = planner_case()[2]
    out = {}
    for planner in ("greedy", "perfsim"):
        out[planner] = np.concatenate(
            [r["planner"][(mode, planner)][0] for r in res], axis=1)
        np.testing.assert_allclose(out[planner], want, **TOL)
    assert float(np.abs(out["perfsim"] - out["greedy"]).max()) <= 1e-6


def test_perfsim_plans_match_jax(tmp_path):
    """The ranks plan on the global shapes repro's planner sees (a rank's
    sequence shard times the ring, its weight shards made whole): the
    cached keys and plans equal repro's for the same ring of 4, every rank
    holds the same plans, and the optimized forward pairs what its plan
    says."""
    n, res = 4, ring_run(4)
    plans = res[0]["planner"]["plans"][0]
    want = {}
    for mode in ("barrier", "cais"):
        want.update(jax_period_plans(n, mode, tmp_path / mode))
    assert plans.keys() == want.keys() and len(want) == 2
    for k, w in want.items():
        g = plans[k]
        for f in ("pairing", "num_chunks", "num_microbatches", "backend"):
            assert g[f] == w[f], (k, f)
        for f in ("makespan", "greedy_makespan"):
            assert abs(g[f] - w[f]) <= 1e-12 * abs(w[f])
    by_mode = {p["backend"]: p for p in plans.values()}
    for r in res:
        assert r["planner"]["plans"][0] == plans
        for mode, p in by_mode.items():
            assert r["planner"][(mode, "perfsim")][1] == sorted(
                f"{a}+{b}" for a, b in p["pairing"])
    assert by_mode["cais"]["pairing"]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-7b",
                                  "gemma3-1b"])
def test_one_device_loss_matches_jax(arch):
    """World 1 takes the per-block path (window and tied head on
    gemma3-1b)."""
    params, want = jax_case(arch)
    lm = LM(get_arch(arch).smoke(), SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(lm, params)
    toks = torch.from_numpy(TOKENS)
    got = float(lm.loss({"tokens": toks, "labels": toks}))
    np.testing.assert_allclose(got, want, **TOL)


def test_shard_state_dict_reassembles():
    cfg = get_arch("internlm2-1.8b").smoke()
    full = LM(cfg, SMOKE, device="cpu", seed=0).state_dict()
    for n in (2, 4):
        shards = [bridge.shard_for_group(full, cfg, TPGroup(r, n, "none"))
                  for r in range(n)]
        for name, t in full.items():
            parts = [s[name] for s in shards]
            assert all(p.is_contiguous() for p in parts)
            if parts[0].shape == t.shape:
                assert all(torch.equal(p, t) for p in parts)
            else:
                dim = [a != b for a, b in zip(parts[0].shape,
                                              t.shape)].index(True)
                assert torch.equal(torch.cat(parts, dim), t)
        group = TPGroup(n - 1, n, "gloo")
        lm = LM(cfg, SMOKE, device="cpu", seed=0, group=group)
        for name, t in lm.state_dict().items():
            assert torch.equal(t, shards[n - 1][name])


def test_unported_tp_paths_raise():
    cfg = get_arch("internlm2-1.8b").smoke()
    group = TPGroup(0, 2, "gloo")           # no process group: no wire
    toks = torch.from_numpy(TOKENS)
    batch = {"tokens": toks, "labels": toks}
    # SMOKE's tp mode is "auto": DTensor runs dense attention blocks
    # (tests/test_torch_auto.py); an MoE raises, before any collective
    moe_auto = LM(get_arch("mixtral-8x7b").smoke(), SMOKE, device="cpu",
                  seed=0, group=group)
    with pytest.raises(NotImplementedError, match=r"A5 \(b\)"):
        moe_auto.loss(batch)
    lm = LM(cfg, SMOKE, device="cpu", seed=0, group=group)
    lm.rt = Runtime(compute_dtype="float32", tp=TPConfig(mode="cais"))
    # ragged S trains on a ring in the replicated layout
    # (tests/test_torch_sublayer.py), an MoE too (A11 (b): its LM.loss on
    # a ring of 2 is test_torch_sublayer's moe_ragged case, held to JAX in
    # tests/test_torch_moe_ragged.py). Where it raised, its block now
    # routes to, and builds, the replicated layout's MoE graph
    moe_cfg = get_arch("mixtral-8x7b").smoke()
    moe = LM(moe_cfg, lm.rt, device="cpu", seed=0, group=group)
    tpc = tp_mod.TPContext(group, backend="cais")
    kind = moe_cfg.layer_pattern[0]
    assert block_routes(kind, moe_cfg, tpc, seq_sharded=False) == (
        "block", "block")
    period, _ = tp_mod.build_period(
        tpc, torch.empty((1, 31, moe_cfg.d_model), device="meta"),
        [moe.blocks[0]], moe_cfg, (kind,), seq_sharded=False)
    assert {"route", "expert_ar"} <= {n.op for n in period.graph.nodes}
    # the perfsim planner is ported: its config builds
    assert TPConfig(mode="cais", planner="perfsim").planner == "perfsim"
    # paged serving runs on a ring (tests/test_torch_serve_tp.py); serving
    # over dense caches and the dense engine do not
    with pytest.raises(NotImplementedError, match=r"A11 \(b\), A12"):
        lm.prefill(toks)
    with pytest.raises(NotImplementedError, match=r"A11 \(b\), A12"):
        lm.decode_step(toks[:, :1], [], torch.zeros(2, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match=r"A11 \(b\), A12"):
        DenseEngine(lm, cfg, lm.rt, device="cpu")
    assert tp_mod.TPContext(group, backend="cais",
                            planner="perfsim").planner == "perfsim"
    with pytest.raises(ValueError, match="unknown planner"):
        tp_mod.TPContext(group, backend="cais", planner="persim")


def test_tp_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(get_arch("internlm2-1.8b").smoke(), SMOKE,
           group=TPGroup(0, 2, "gloo"))
