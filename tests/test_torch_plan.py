"""The port's perfsim schedule planner (``repro_torch.core.perfsim`` and
``repro_torch.plan``) against the JAX package's on the CPU: the same graphs,
built by each package's own constructors, lower to the same tasks and
makespans (rel 1e-12) under both backends on flat and two-tier fabrics; the
pairing enumeration, the pairing, period and planner-object searches give
the same plans (pairing, chunks, microbatches, node order) on the graphs
``tests/test_planner.py`` plans; the cache keys are equal; the cache misses,
hits, persists and writes atomically; the calibration of the committed bench
rows and the paper's speedup table are equal; and an optimized graph with a
non-greedy pairing executes as ``repro``'s does (within 1e-5)."""
import dataclasses
import json
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import plan as jplan  # noqa: E402
from repro.core import dataflow as jdf  # noqa: E402
from repro.core import perfsim as jps  # noqa: E402
from repro.core import tp as jtp  # noqa: E402
from repro.hw import V5E as JV5E  # noqa: E402

from repro_torch import hw, plan  # noqa: E402
from repro_torch.core import dataflow as df  # noqa: E402
from repro_torch.core import perfsim as ps  # noqa: E402
from repro_torch.core import tp as tp_mod  # noqa: E402
from repro_torch.plan import __main__ as plan_main  # noqa: E402

REL = 1e-12
BENCH_JSON = os.path.join(os.path.dirname(__file__), os.pardir,
                          "BENCH_pr10.json")
# each package's (dataflow, period builder, perfsim, plan) modules
PKGS = {"repro": (jdf, jtp, jps, jplan),
        "port": (df, tp_mod, ps, plan)}


def _fabric(pkg, **kw):
    f = PKGS[pkg][2].Fabric(n=8)
    return dataclasses.replace(f, **kw) if kw else f


def _two_tier(pkg, **kw):
    base = _fabric(pkg)
    return dataclasses.replace(
        base, n_outer=kw.pop("n_outer", 4),
        bw2=kw.pop("bw2", base.bw / 20), alpha2=kw.pop("alpha2", 2e-4),
        **kw)


def _asym(pkg):
    """tests/test_planner.py's asymmetric two-tier fabric, on which the
    planner's chunking differs from the flat ring's."""
    return dataclasses.replace(_fabric(pkg), alpha=1e-7, n_outer=4,
                               bw2=_fabric(pkg).bw / 20, alpha2=2e-4)


def _pass2(m, g):
    return m.fuse_sublayer_chain(m.fuse_shared_gather(
        m.fuse_compute_aware(g)))


def _period_weights(d, d_ff, blocks):
    out = {}
    for i in range(blocks):
        p = f"b{i}."
        out.update({p + "scale1": (d,), p + "scale2": (d,),
                    p + "wq": (d, d), p + "wk": (d, d), p + "wv": (d, d),
                    p + "wo": (d, d), p + "w_up": (d, d_ff),
                    p + "w_gate": (d, d_ff), p + "w_down": (d_ff, d)})
    return out


def _three_chain(m):
    """tests/test_planner.py's graph where the planner beats greedy: one
    large gemm_rs chain against a small near gather and a large far one."""
    return m.Graph(
        nodes=[m.Node("xa", "input"), m.Node("xb", "input"),
               m.Node("xc", "input"),
               m.Node("ga", "gemm_row", ("xa",), ("wa",)),
               m.Node("rsa", "reduce_scatter", ("ga",)),
               m.Node("agb", "allgather", ("xb",)),
               m.Node("gb", "gemm_col", ("agb",), ("wb",)),
               m.Node("agc", "allgather", ("xc",)),
               m.Node("gc", "gemm_col", ("agc",), ("wc",))],
        outputs=("rsa", "gb", "gc"))


THREE_CHAIN = dict(
    value_shapes={"xa": (8, 512, 4096), "xb": (8, 512, 128),
                  "xc": (8, 512, 4096)},
    weight_shapes={"wa": (4096, 4096), "wb": (128, 128),
                   "wc": (4096, 4096)})
DUAL = dict(value_shapes={"xa": (8, 512, 4096), "xb": (8, 512, 4096)},
            weight_shapes={"wa": (4096, 4096), "wb": (4096, 4096)})
SUBLAYER = dict(value_shapes={"x": (8, 512, 1024)},
                weight_shapes={"w1": (1024, 1024), "w2": (1024, 1024),
                               "scale": (1024,)})


def _period(m, tpm, blocks=2, mb=1):
    core = lambda q, k, v: q                               # noqa: E731
    base = tpm.dense_period_graph([core] * blocks, has_gate=True, act="silu")
    return base if mb == 1 else m.merge_graphs([base] * mb,
                                               share_weights=True)


def _graph_case(pkg, name):
    """(graph, lowering keywords) of one lowering case, built by ``pkg``."""
    m, tpm = PKGS[pkg][:2]
    if name == "sublayer":
        return m.optimize(m.sublayer_graph()), SUBLAYER
    if name == "dual_sublayer":
        return m.optimize(m.dual_sublayer_graph()), DUAL
    weights = _period_weights(256, 512, 2)
    if name == "period_2block":
        return (m.optimize(_period(m, tpm)),
                dict(value_shapes={"x": (4, 256, 256)},
                     weight_shapes=weights))
    merged = _period(m, tpm, mb=2)
    per = (2, 256, 256)
    if name == "period_mb2":
        return (m.optimize(merged),
                dict(value_shapes={"mb0.x": per, "mb1.x": per},
                     weight_shapes=weights))
    tg = m.build_training_graph(_pass2(m, merged))
    g = m.optimize(tg.graph)
    vs = {"mb0.x": per, "mb1.x": per}
    vs.update({gi: per for gi in tg.grad_inputs})
    ws = dict(weights)
    ws.update(m.derived_weight_shapes(tg.graph, ws))
    hints = {f"{p}mb{i}.b{j}.o": 1e9 for p in ("", "adj.")
             for i in range(2) for j in range(2)}
    return g, dict(value_shapes=vs, weight_shapes=ws, comp_hints=hints)


GRAPHS = ["sublayer", "dual_sublayer", "period_2block", "period_mb2",
          "training_mb2"]
FABRICS = {"flat": _fabric, "two_tier": _two_tier}
CHUNKS = [None, 2, (4, 16)]


def _tasks(sim):
    return [(t.tid, t.res, t.dur, t.deps) for t in sim.tasks]


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


# ---------------------------------------------------------------------------
# lowering and simulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fabric", sorted(FABRICS))
@pytest.mark.parametrize("name", GRAPHS)
def test_lowering_matches_repro(name, fabric):
    out = {}
    for pkg in PKGS:
        g, kw = _graph_case(pkg, name)
        f = FABRICS[fabric](pkg)
        lower = PKGS[pkg][3].lower
        out[pkg] = {}
        for backend in ("barrier", "cais"):
            pol = lower.policy_for_backend(backend)
            for c in CHUNKS if backend == "cais" else [None]:
                sim = lower.lower_graph(g, f, pol, num_chunks=c, **kw)
                makespan, busy = sim.run()
                out[pkg][(backend, c)] = (makespan, _tasks(sim), busy,
                                          lower.simulate(g, f, pol,
                                                         num_chunks=c, **kw))
        assert PKGS[pkg][3].graph_signature(g)
    assert plan.graph_signature(_graph_case("port", name)[0]) == \
        jplan.graph_signature(_graph_case("repro", name)[0])
    for k, want in out["repro"].items():
        got = out["port"][k]
        assert got[1] == want[1], k          # the same tasks, durations
        assert got[2] == want[2], k          # and busy intervals
        assert _close(got[0], want[0]) and _close(got[3], want[3]), k
        assert got[0] > 0


def test_policies_fabrics_and_shapes_match_repro():
    for backend in ("barrier", "cais", "auto"):
        for c in (None, 4):
            assert dataclasses.asdict(plan.policy_for_backend(backend, c)) \
                == dataclasses.asdict(jplan.policy_for_backend(backend, c))
    assert {k: dataclasses.asdict(v) for k, v in ps.BASELINES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jps.BASELINES.items()}
    for n_outer in (1, 4):
        assert dataclasses.asdict(plan.fabric_from_hw(hw.V5E, 8,
                                                      n_outer=n_outer)) == \
            dataclasses.asdict(jplan.fabric_from_hw(JV5E, 8,
                                                    n_outer=n_outer))
    g = df.dual_sublayer_graph()
    assert plan.synthesize_shapes(g) == \
        jplan.synthesize_shapes(jdf.dual_sublayer_graph())
    for mb in (1, 4):
        assert plan.microbatch_value_shapes((8, 64, 32), mb) == \
            jplan.microbatch_value_shapes((8, 64, 32), mb)
        assert plan.microbatch_comp_hints({"b0.o": 8.0}, mb) == \
            jplan.microbatch_comp_hints({"b0.o": 8.0}, mb)


def test_paper_model_matches_repro():
    """speedup_table() (the calibrated fabric's predictions of the paper's
    Fig. 11 speedups), the sub-layer runs and the utilization trace."""
    got, want = ps.speedup_table(), jps.speedup_table()
    assert got.keys() == want.keys()
    for m in want:
        assert got[m].keys() == want[m].keys()
        assert all(_close(got[m][b], want[m][b]) for b in want[m])
    assert _close(ps.geomean(got["LLaMA-7B"].values()),
                  jps.geomean(want["LLaMA-7B"].values()))
    f, jf = ps.calibrated_fabric(), jps.calibrated_fabric()
    assert dataclasses.asdict(f) == dataclasses.asdict(jf)
    for name in ("CAIS", "T3", "CoCoNet"):
        mk, busy = ps.run_sublayer(ps.LLAMA_7B, ps.BASELINES[name], f)
        jmk, jbusy = jps.run_sublayer(jps.LLAMA_7B, jps.BASELINES[name], jf)
        assert mk == jmk and busy == jbusy
        assert ps.trace(busy, mk, bins=20) == jps.trace(jbusy, jmk, bins=20)


# ---------------------------------------------------------------------------
# search: the same plans
# ---------------------------------------------------------------------------


def _plan_equal(got, want):
    g, w = got.to_dict(), want.to_dict()
    for k in ("pairing", "num_chunks", "num_microbatches", "backend"):
        assert g[k] == w[k], (k, g[k], w[k])
    assert _close(g["makespan"], w["makespan"])
    assert _close(g["greedy_makespan"], w["greedy_makespan"])


def _order(g):
    return [n.name for n in g.nodes]


SEARCH_CASES = {
    # the planner beats greedy: (rsa, gc) over nearest-first (rsa, gb)
    "three_chain": (lambda m: _pass2(m, _three_chain(m)), _fabric,
                    THREE_CHAIN),
    "dual_sublayer": (lambda m: _pass2(m, m.dual_sublayer_graph()), _fabric,
                      {}),
    # the two-tier cases: the per-axis chunk sweep picks other chunks
    "dual_two_tier": (lambda m: _pass2(m, m.dual_sublayer_graph()),
                      _two_tier, DUAL),
    "dual_asym": (lambda m: _pass2(m, m.dual_sublayer_graph()), _asym,
                  DUAL),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_matches_repro(case):
    build, fab, kw = SEARCH_CASES[case]
    res = {}
    for pkg in PKGS:
        m, _, _, pl = PKGS[pkg]
        g2, f = build(m), fab(pkg)
        enum = [(p, _order(g)) for p, g in pl.enumerate_pairings(g2)]
        plans = {b: pl.search_pairing(g2, fabric=f, backend=b, **kw)
                 for b in ("barrier", "cais")}
        planner = pl.PerfsimPlanner(fabric=f, **kw)
        out = planner.pair(g2)
        res[pkg] = (enum, plans, planner.plan, _order(out),
                    _order(m.optimize(build(m) if case != "three_chain"
                                      else _three_chain(m),
                                      planner=pl.PerfsimPlanner(fabric=f,
                                                                **kw))))
    (enum, plans, p, order, opt), (jenum, jplans, jp, jorder, jopt) = \
        res["port"], res["repro"]
    assert enum == jenum and len(enum) > 1
    for b in plans:
        _plan_equal(plans[b], jplans[b])
    _plan_equal(p, jp)
    assert order == jorder and opt == jopt
    if case == "three_chain":
        assert p.pairing == (("rsa", "gc"),)
        assert p.makespan < p.greedy_makespan
    if case == "dual_asym":
        flat = plan.search_pairing(SEARCH_CASES[case][0](df),
                                   fabric=_fabric("port"), **DUAL)
        assert flat.num_chunks != p.num_chunks


@pytest.mark.parametrize("backend", ["barrier", "cais"])
def test_search_period_matches_repro(backend):
    """The joint (microbatches × pairing × chunks) argmin of a 2-block
    period, and period_planner's plan and cache key, with the TPU spec given
    to both (the port's default is the H100)."""
    res = {}
    for pkg in PKGS:
        m, tpm, _, pl = PKGS[pkg]
        base = _period(m, tpm)
        kw = dict(x_shape=(8, 256, 512),
                  weight_shapes=_period_weights(512, 1024, 2),
                  comp_hints={"b0.o": 3e9, "b1.o": 3e9})
        p = pl.search_period(base, fabric=_fabric(pkg), backend=backend,
                             mb_candidates=(1, 2), **kw)
        hw_ = hw.V5E if pkg == "port" else JV5E
        pp, pairer = pl.period_planner(base, dtype_bytes=4, tp=4,
                                       backend=backend,
                                       mb_candidates=(1, 2), hw=hw_, **kw)
        merged = base if pp.num_microbatches == 1 else m.merge_graphs(
            [base] * pp.num_microbatches, share_weights=True)
        key = pl.plan_key(base, {"x": kw["x_shape"]}, kw["weight_shapes"], 4,
                          pl.fabric_from_hw(hw_, 4), backend,
                          extra={"kind": "period", "mb": [1, 2]})
        res[pkg] = (p, pp, _order(m.optimize(merged, planner=pairer)), key)
    (p, pp, order, key), (jp, jpp, jorder, jkey) = res["port"], res["repro"]
    _plan_equal(p, jp)
    _plan_equal(pp, jpp)
    assert p.makespan <= p.greedy_makespan + 1e-12
    assert order == jorder and key == jkey


def test_plan_key_matches_repro():
    kw = dict(value_shapes={"x": (8, 512, 1024)},
              weight_shapes={"w1": (1024, 1024), "w2": (1024, 1024)},
              dtype_bytes=2, backend="cais", extra={"mb": [1, 2]})
    for n_outer in (1, 4):
        got = plan.plan_key(df.optimize(df.sublayer_graph()),
                            fabric=plan.fabric_from_hw(hw.H100, 4,
                                                       n_outer=n_outer), **kw)
        jhw = type(JV5E)(**dataclasses.asdict(hw.H100))
        want = jplan.plan_key(jdf.optimize(jdf.sublayer_graph()),
                              fabric=jplan.fabric_from_hw(jhw, 4,
                                                          n_outer=n_outer),
                              **kw)
        assert got == want
    assert plan.Plan.from_dict(json.loads(json.dumps(plan.Plan(
        (("a", "b"),), (16, 2), 1, 1.0, 2.0, "cais").to_dict()))).num_chunks \
        == (16, 2)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


def test_cache_miss_hit_persist_and_memo(tmp_path):
    g2 = _pass2(df, df.dual_sublayer_graph())
    cache = plan.PlanCache(root=str(tmp_path))
    p1 = plan.PerfsimPlanner(fabric=_fabric("port"), cache=cache)
    out1 = p1.pair(g2)
    assert cache.stats == {"hits": 0, "misses": 1}
    p2 = plan.PerfsimPlanner(fabric=_fabric("port"), cache=cache)
    out2 = p2.pair(g2)
    assert cache.stats == {"hits": 1, "misses": 1}
    assert p1.plan == p2.plan and _order(out1) == _order(out2)
    # a fresh cache over the same root reloads the persisted JSON
    cache2 = plan.PlanCache(root=str(tmp_path))
    plan.PerfsimPlanner(fabric=_fabric("port"), cache=cache2).pair(g2)
    assert cache2.stats == {"hits": 1, "misses": 0}
    # the memo answers before the key is computed, and only under its key
    for n in range(3):
        p3 = plan.PerfsimPlanner(fabric=_fabric("port"), cache=cache2,
                                 memo_key=("dual",))
        assert _order(p3.pair(g2)) == _order(out1) and p3.plan == p1.plan
        assert cache2.stats == {"hits": 2, "misses": 0}
        assert cache2.memo_hits == n
    assert os.listdir(tmp_path) == [os.listdir(tmp_path)[0]]


def test_cache_root_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "env"))
    assert plan.PlanCache().root == str(tmp_path / "env")
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE")
    assert plan.PlanCache().root == "reports/plans_torch"


def test_cache_writes_are_atomic(tmp_path):
    """Writers racing on one key (the ranks of a ring share the directory)
    and readers opening it from fresh caches: every read is a whole entry,
    and no temporary file is left behind."""
    plans = [{"pairing": [], "blob": "x" * (20000 + i), "i": i}
             for i in range(4)]
    stop, seen, bad = threading.Event(), [], []

    def write(i):
        cache = plan.PlanCache(root=str(tmp_path))
        while not stop.is_set():
            try:
                cache.put("k", plans[i])
            except OSError as e:        # another writer's rename in its way
                bad.append(repr(e))

    def read():
        path = tmp_path / "k.json"
        while not stop.is_set():
            try:
                got = json.loads(path.read_text())
            except FileNotFoundError:
                continue
            except json.JSONDecodeError as e:     # a torn entry
                bad.append(str(e))
                continue
            (seen if got in plans else bad).append(got.get("i"))
            if plan.PlanCache(root=str(tmp_path)).get("k") not in plans:
                bad.append("a cache read an entry that was never written")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=write, args=(i,)) for i in range(4)]
    threads += [threading.Thread(target=read) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        threading.Event().wait(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad and seen
    assert os.listdir(tmp_path) == ["k.json"]


# ---------------------------------------------------------------------------
# calibration, the selfcheck, and execution of a planned graph
# ---------------------------------------------------------------------------


def test_calibrate_matches_repro():
    got, want = plan.calibrate(BENCH_JSON), jplan.calibrate(BENCH_JSON)
    for a, b in ((got.fabric, want.fabric), (got.fabric2, want.fabric2)):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a.keys() == b.keys()
        for k in b:
            if isinstance(b[k], float):
                assert abs(a[k] - b[k]) <= 1e-9 * abs(b[k]), k
            else:
                assert a[k] == b[k], k
    assert got.ratios.keys() == want.ratios.keys()
    assert all(abs(got.ratios[c] - want.ratios[c]) <= 1e-9 * want.ratios[c]
               for c in want.ratios)
    assert got.within_tolerance == want.within_tolerance is True


def test_selfcheck_and_calibrate_entry_point(capsys):
    assert plan_main.main(["--selfcheck", "--calibrate", BENCH_JSON]) == 0
    out = capsys.readouterr().out
    assert "selfcheck: OK" in out and "calibrate: fitted" in out


def test_planned_graph_executes_like_repro():
    """optimize(planner=PerfsimPlanner(...)) with the non-greedy pairing
    (the shapes that force it injected into the planner), executed by the
    port on one device, against repro's df.execute of the same graph
    (tests/test_planner.py's reference-semantics check)."""
    import jax.numpy as jnp

    opt = df.optimize(_three_chain(df), planner=plan.PerfsimPlanner(
        fabric=_fabric("port"), **THREE_CHAIN))
    jopt = jdf.optimize(_three_chain(jdf), planner=jplan.PerfsimPlanner(
        fabric=_fabric("repro"), **THREE_CHAIN))
    assert [n.name for n in opt.nodes if n.op == "overlap_asym"] == \
        ["rsa+gc"]
    assert _order(opt) == _order(jopt)
    rng = np.random.default_rng(0)
    vals = {k: rng.standard_normal((2, 8, d)).astype(np.float32)
            for k, d in (("xa", 16), ("xb", 8), ("xc", 16))}
    w = {k: (0.1 * rng.standard_normal((d, d))).astype(np.float32)
         for k, d in (("wa", 16), ("wb", 8), ("wc", 16))}
    got = df.execute(opt, {k: torch.from_numpy(v) for k, v in vals.items()},
                     {k: torch.from_numpy(v) for k, v in w.items()})
    want = jdf.execute(jopt, {k: jnp.asarray(v) for k, v in vals.items()},
                       {k: jnp.asarray(v) for k, v in w.items()})
    ref = jdf.execute(_three_chain(jdf),
                      {k: jnp.asarray(v) for k, v in vals.items()},
                      {k: jnp.asarray(v) for k, v in w.items()})
    for a, b, c in zip(got, want, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5)


def test_stale_pairing_raises():
    g2 = _pass2(df, _three_chain(df))
    with pytest.raises(df.GraphError, match="not a legal independent pair"):
        df.pair_asymmetric(g2, pairing=[("rsa", "nope")])
    assert _order(df.pair_asymmetric(g2, pairing=[("rsa", "gc")])) == \
        _order(jdf.pair_asymmetric(_pass2(jdf, _three_chain(jdf)),
                                   pairing=[("rsa", "gc")]))
