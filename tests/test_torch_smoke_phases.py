"""``chip_smoke.py``'s phases 9, 10, 11, 12 and 13 on the CPU at smoke
size.

Phase 9: the one-device
reference step and its host store, and the rank body on a gloo ring of 4
(its ``auto`` runs: DTensor's census, no matmul call, a flash core a layer
in the forward and in the remat recompute),
with the plain versions in place of the kernels (so the kernels' launch
counters, which only the card moves, are not read here). Everything else
the phase asserts on the card is held: the ranks' losses, grad norms,
gradients, m, v and parameters against the reference within the phase's
own bounds, the matmul and flash calls against the graph-derived counts,
overlap_asym as the graphs say with a cross-direction pair at 2
microbatches, and every transposed matmul call among the shapes phase 3
checks; its two runs on the 2D (tp_in 2 x tp_out 2) mesh of the same ranks
too.

Phase 10: the one-device serving references and the rank body on a gloo
ring of 4 (internlm2-1.8b, and gemma3-1b's replicated kv head and window),
with a small traffic: every check the phase makes on the card except the
launch counters and variants, and every matmul call shape among those
``serve_matmul_shapes`` predicts for phase 3.

Phase 11: (b) the MoE training step (mixtral-8x7b smoke, batch 1 of 64
tokens, so a rank's 16 tokens are the smoke routing group) with every check
``train_checks`` makes on the card except the launch counters, the routing
of every rank equal to one device's, the backend's expert all-to-all
dispatches equal to the graphs', and every matmul call among those
``moe_matmul_shapes`` predicts; in the same spawn its ragged leg (batch 8
of 6, the replicated layout: every rank routes one device's whole batch,
an ``expert_ar`` node a layer, every matmul among those
``ragged_matmul_shapes`` predicts); (a) the scripted serving schedule
through ``serve_step`` with its routing recorded once a layer a step.

Phase 12: (a) the data 2 x model 2 training step (internlm2-1.8b smoke,
batch 4 of 32) held to one device as phase 9's runs, and each replica's
grads summed in int8 over the data axis within COMPRESS_RTOL; (b) grouped
EP on the 2D mesh (mixtral-8x7b smoke, batch 1 of 64) held as phase 11's,
every concrete expert all-to-all and adjoint on tp_out. Phase 12 (c), the
launcher's ``--mesh debug``, is ``tests/test_torch_train.py``'s.

Phase 13: (a) minicpm3-4b smoke, batch 4 of 32: the norm grads' check, and
the ring's MLA steps (mixers replicated, FFNs through ``sp_ffn``) held to
one device, every kernel call counted against the graphs and every matmul
among ``sp_ffn_matmul_shapes``; (b) internlm2-1.8b smoke in one spawn: the
ragged step (S 31) in the replicated layout, every matmul among
``ragged_matmul_shapes``, and the step with ``sequence_parallel`` off
(S 32), each held to its batch's one-device step."""
import sys
import tempfile

import numpy as np
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:     # the ranks import the rank body by name
    sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402


# the card's phase 9 leaves the 2D barrier run out for time; at smoke size
# it is rehearsed here
PHASE9_RUNS = (CS.TRAIN_RUNS + [("barrier", 1, "float32", "greedy", "2x2")]
               + CS.TRAIN_2D_RUNS)


def _ring(run):
    """The ring a run's fused schedules use: tp_in on the 2D mesh."""
    return CS.MESHES["2x2"]["tp_in"] if run[4:] == ("2x2",) else None


@pytest.fixture(scope="module")
def phase9():
    cfg = get_arch("internlm2-1.8b").smoke()
    batch = make_batch(cfg, ShapeConfig("t", 32, 2, "train"), 0,
                       DataConfig(CS.SEED))
    with tempfile.TemporaryDirectory() as root:
        ref, store = CS.train_reference(batch, root, cfg, "cpu")
        with CS.plan_cache_at(Path(root) / "plans"):
            got = run_ranks(CS.train_legs, 4,
                            [(batch, PHASE9_RUNS, store, ref)], cfg, "cpu",
                            device="cpu", timeout=600)
    return cfg, ref, [g[0]["runs"] for g in got]


@pytest.mark.parametrize("i", range(len(PHASE9_RUNS)),
                         ids=["-".join(map(str, r)) for r in PHASE9_RUNS])
def test_phase9_on_the_cpu(phase9, i):
    cfg, ref, ranks = phase9
    dtype = PHASE9_RUNS[i][2]
    per = [rk[i] for rk in ranks]
    mb = per[0]["mb"]
    f32 = dtype == "float32"
    assert len({p["loss"] for p in per}) == 1
    want = ref["loss"] if f32 else ref["loss_bf16"]
    rtol = CS.F32_LOSS_RTOL if f32 else CS.BF16_LOSS_RTOL
    assert abs(per[0]["loss"] - want) <= rtol * abs(want)
    predicted = {tuple(s) for s in CS.train_matmul_shapes(
        cfg, world=4, batch=2, seq=32, runs=[PHASE9_RUNS[i]],
        ring=_ring(PHASE9_RUNS[i]))}
    auto = PHASE9_RUNS[i][0] == "auto"
    for p in per:
        assert sum(c[-1] for c in p["call_shapes"]) == p["matmul_derived"]
        assert p["overlap_asym"] == p["overlap_asym_nodes"]
        got = {(M, K, N, lay) for M, K, N, _, lay, _ in p["call_shapes"]
               if lay != "nn"}
        if auto:
            # no graph: no matmul call, the flash core a layer in the
            # forward and in its remat recompute, and DTensor's census (one
            # gather in and one reduce-scatter out a sub-layer forward;
            # their adjoints, and the recompute's, backward)
            assert p["matmul_derived"] == 0 and not got
            assert p["flash_derived"] == 2 * cfg.num_layers
            assert p["comm"]["forward"] == {"all_gather_into_tensor": 2.0,
                                            "reduce_scatter_tensor": 2.0}
            bwd = p["comm"]["backward"]
            assert bwd["all_gather_into_tensor"] >= 2
            assert bwd["reduce_scatter_tensor"] >= 2
            assert set(p["comm"]["outside"]) == {"allreduce_"}
        else:
            assert p["flash_derived"] == 3 * mb * cfg.num_layers
            if p["planner"] == "greedy":
                assert bool(p["cross_direction_pairs"]) == (mb > 1)
            assert got and got <= predicted
        if f32:
            assert abs(p["grad_norm"] - ref["grad_norm"]) <= \
                CS.TRAIN_RTOL * ref["grad_norm"]
            for e in p["errs"].values():
                for q in ("grad", "m", "v"):
                    assert e[q][0] <= e[q][1]
                assert e["param"][1] <= 1.0
    if per[0]["plans"] is not None:
        assert all(CS.plan_checks(per).values())


# phase 10's traffic cut to smoke size: prompts of 12-40 tokens, chunks of
# 8 (the ragged mixed step is 7 long), blocks of 4
TRAFFIC = dict(requests=4, prompt_min=12, prompt_max=40, max_new=4, chunk=8,
               block=4)
LAUNCH_CHECKS = ("matmul launches", "flash launches", "flash variants",
                 "matmul variants")


@pytest.fixture(scope="module")
def phase10():
    cfg = get_arch("internlm2-1.8b").smoke()
    rcfg = get_arch(CS.REPL_ARCH).smoke()
    prompts = CS.serve_prompts(cfg, TRAFFIC)
    steps = CS.scripted_steps(cfg, TRAFFIC, CS.SCRIPTED_CHUNKS)
    rsteps = CS.scripted_steps(rcfg, TRAFFIC, CS.REPL_CHUNKS)
    one = CS.serve_reference(cfg, TRAFFIC, prompts, steps,
                             ("float32", "bfloat16"), "cpu")
    rone = CS.serve_reference(rcfg, TRAFFIC, None, rsteps, ("float32",),
                              "cpu")
    with tempfile.TemporaryDirectory() as root, CS.plan_cache_at(root):
        ranks = run_ranks(CS.serve_tp_rank, 4, TRAFFIC, CS.SERVE_TP_RUNS,
                          prompts, steps, rsteps, cfg, rcfg, "cpu",
                          device="cpu", timeout=600)
    rows, _ = CS.serve_tp_checks(one, rone, ranks)
    return cfg, rcfg, ranks, rows


@pytest.mark.parametrize("i", range(len(CS.SERVE_TP_RUNS) + 1),
                         ids=["-".join(r) for r in CS.SERVE_TP_RUNS]
                         + ["repl"])
def test_phase10_on_the_cpu(phase10, i):
    cfg, rcfg, ranks, rows = phase10
    row = rows[i]
    bad = [k for k, v in row["checks"].items()
           if not v and not k.startswith(LAUNCH_CHECKS)]
    assert not bad
    c = cfg if i < len(CS.SERVE_TP_RUNS) else rcfg
    run = CS.SERVE_TP_RUNS[i] if i < len(CS.SERVE_TP_RUNS) else ()
    predicted = set(CS.serve_matmul_shapes(
        c, TRAFFIC, ring=CS.MESHES["2x2"]["tp_in"] if run[3:] == ("2x2",)
        else None))
    for rk in ranks:
        p = rk[0][i] if i < len(CS.SERVE_TP_RUNS) else rk[1]
        assert sum(s[-1] for s in p["matmul_shapes"]) == p["matmul_derived"]
        assert sum(s[-1] for s in p["flash_shapes"]) == p["flash_derived"]
        assert {tuple(s[:3]) for s in p["matmul_shapes"]} <= predicted
        assert p["gemm_ar"] == p["gemm_ar_derived"] > 0
    if row["tokens"] is not None:
        assert row["steps"] == row["engine_steps"] + len(
            CS.scripted_steps(cfg, TRAFFIC, CS.SCRIPTED_CHUNKS))


@pytest.fixture(scope="module")
def phase11():
    """Phase 11 (b)'s two legs in one spawn, as on the card: batch 1 of 64
    (a rank's 16 tokens one routing group), then the ragged leg, batch 8
    of 6 (S % 4 = 2: the replicated layout, 48 tokens in groups of 16,
    capacity 10). Returns (cfg, the first leg's ranks and rows, the ragged
    leg's (ranks, rows))."""
    cfg = get_arch(CS.MOE_ARCH).smoke()
    legs = [(CS.train_batch(cfg, 64, 1), CS.MOE_RUNS),
            (CS.train_batch(cfg, 6, 8), CS.MOE_RAGGED_RUNS)]
    with tempfile.TemporaryDirectory() as root:
        refs = []
        for i, (batch, _) in enumerate(legs):
            (Path(root) / f"leg{i}").mkdir()
            refs.append(CS.train_reference(batch, f"{root}/leg{i}", cfg,
                                           "cpu", quantities=("grad",)))
        with CS.plan_cache_at(Path(root) / "plans"):
            got = run_ranks(CS.train_legs, 4, [
                (batch, runs, store,
                 {k: v for k, v in ref.items() if k != "routing"})
                for (batch, runs), (ref, store) in zip(legs, refs)],
                cfg, "cpu", device="cpu", timeout=600)
    out = []
    for i, ((batch, runs), (ref, _)) in enumerate(zip(legs, refs)):
        ranks = [g[i]["runs"] for g in got]
        B, S = batch["tokens"].shape
        out.append((ranks, CS.train_checks(cfg, ref, ranks, runs,
                                           B * S // 4)[0]))
    return (cfg,) + out[0] + (out[1],)


@pytest.mark.parametrize("i", range(len(CS.MOE_RUNS)),
                         ids=["-".join(map(str, r)) for r in CS.MOE_RUNS])
def test_phase11_training_on_the_cpu(phase11, i):
    cfg, ranks, rows, _ = phase11
    row, run = rows[i], CS.MOE_RUNS[i]
    bad = [k for k, v in row["checks"].items() if not v and not k.startswith(
        LAUNCH_CHECKS + ("transposed layouts", "a2a_ffn"))]
    assert not bad
    assert row["mb"] == 1
    if run[2] == "float32":
        assert row["elementwise_held"]
        assert all(d["choice"] == d["slots"] == 0
                   for d in row["routing_differences"])
    predicted = set(CS.moe_matmul_shapes(cfg, run[2], world=4, batch=1,
                                         seq=64, runs=[run]))
    for rk in ranks:
        p = rk[i]
        assert sum(c[-1] for c in p["call_shapes"]) == p["matmul_derived"]
        assert p["flash_derived"] == 3 * cfg.num_layers
        assert {(M, K, N, lay) for M, K, N, _, lay, _ in p["call_shapes"]} \
            <= predicted
        assert [a[0] for a in p["a2a"]] == [a[0] for a in p["a2a_derived"]] \
            == [2 * cfg.num_layers, cfg.num_layers]


@pytest.mark.parametrize("i", range(len(CS.MOE_RAGGED_RUNS)),
                         ids=["-".join(map(str, r))
                              for r in CS.MOE_RAGGED_RUNS])
def test_phase11_ragged_training_on_the_cpu(phase11, i):
    """Phase 11 (b)'s ragged leg: the replicated layout, every rank's
    routing one device's whole batch, element-wise held, an ``expert_ar``
    node a layer in the forward and its recompute and no all-to-all, the
    calls against the graphs and every matmul among those
    ``ragged_matmul_shapes`` predicts for phase 3."""
    cfg, _, _, (ranks, rows) = phase11
    row = rows[i]
    bad = [k for k, v in row["checks"].items() if not v and not k.startswith(
        LAUNCH_CHECKS + ("transposed layouts",))]
    assert not bad
    assert (row["layout"], row["mb"]) == ("replicated", 1)
    assert row["elementwise_held"]
    assert all(d["choice"] == d["slots"] == 0
               for d in row["routing_differences"])
    predicted = set(CS.ragged_matmul_shapes(cfg, world=4, batch=8, seq=6))
    for rk in ranks:
        p = rk[i]
        assert sum(c[-1] for c in p["call_shapes"]) == p["matmul_derived"]
        assert p["flash_derived"] == 3 * cfg.num_layers
        assert {(M, K, N, lay) for M, K, N, _, lay, _ in p["call_shapes"]} \
            <= predicted
        assert p["expert_ar"] == 2 * cfg.num_layers
        assert p["a2a"] == [[0, 0], [0, 0]]


def test_phase11_scripted_serving_on_the_cpu():
    from repro_torch.models import LM
    from repro_torch.runtime import Runtime

    cfg = get_arch(CS.MOE_ARCH).smoke()
    steps = CS.moe_scripted_steps(cfg, TRAFFIC)
    assert len(steps) == 1 + CS.MOE_DECODE_STEPS
    lm = LM(cfg, Runtime(compute_dtype="float32"), device="cpu", seed=0)
    routes, restore = CS.routing_probe()
    try:
        a, _ = CS.run_scripted(lm, steps, TRAFFIC["block"])
        first = list(routes)
        routes.clear()
        b, _ = CS.run_scripted(lm, steps, TRAFFIC["block"])
    finally:
        restore()
    assert len(first) == len(routes) == len(steps) * cfg.num_layers
    diff = CS.routing_differences(routes, first)
    assert diff == dict(choice=0, slots=0, worst_gap=None, first=None)
    assert CS.routing_rule(diff)
    for x, y in zip(a, b):
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x, y)


def _phase12(cfg, batch, runs, mesh, quantities=CS.RefStore.QUANTITIES,
             compress=False):
    """A phase 12 training cell at smoke size: (rows as ``train_checks``
    makes them, what every rank returned)."""
    with tempfile.TemporaryDirectory() as root:
        ref, store = CS.train_reference(batch, root, cfg, "cpu",
                                        quantities=quantities)
        with CS.plan_cache_at(Path(root) / "plans"):
            got = run_ranks(CS.train_legs, 4, [
                (batch, runs, store,
                 {k: v for k, v in ref.items() if k != "routing"})],
                cfg, "cpu", mesh, compress, device="cpu", timeout=600)
    got = [g[0] for g in got]
    B, S = batch["tokens"].shape
    rows, _ = CS.train_checks(cfg, ref, [g["runs"] for g in got], runs,
                              B * S // 4)
    return rows, got


@pytest.fixture(scope="module")
def phase12a():
    cfg = get_arch("internlm2-1.8b").smoke()
    batch = CS.train_batch(cfg, 32, CS.DP_BATCH)
    return cfg, _phase12(cfg, batch, CS.DP_RUNS, "dp2", compress=True)


@pytest.mark.parametrize("i", range(len(CS.DP_RUNS)),
                         ids=["-".join(map(str, r)) for r in CS.DP_RUNS])
def test_phase12_dp_on_the_cpu(phase12a, i):
    cfg, (rows, got) = phase12a
    row, run = rows[i], CS.DP_RUNS[i]
    bad = [k for k, v in row["checks"].items()
           if not v and not k.startswith(LAUNCH_CHECKS + ("transposed",))]
    assert not bad
    assert row["elementwise_held"] and row["dp"] == 2
    assert row["topology"] == [2, 1]
    predicted = {tuple(s) for s in CS.train_matmul_shapes(
        cfg, world=2, batch=CS.DP_BATCH // 2, seq=32, runs=[run])}
    predicted |= {(*s, "nn") for s in CS.tp_matmul_shapes(
        cfg, 4, world=2, batch=CS.DP_BATCH // 2, seq=32)}
    for g in got:
        p = g["runs"][i]
        assert sum(c[-1] for c in p["call_shapes"]) == p["matmul_derived"]
        assert {(M, K, N, lay) for M, K, N, _, lay, _ in p["call_shapes"]} \
            <= predicted
    comp = [g["compress"] for g in got]
    assert all(0 < c["worst_rel"] <= CS.COMPRESS_RTOL for c in comp)
    assert comp[0]["f32_bytes"] == 4 * comp[0]["int8_bytes"] > 0


@pytest.fixture(scope="module")
def phase12b():
    cfg = get_arch(CS.MOE_ARCH).smoke()
    batch = CS.train_batch(cfg, 64, 1)
    return cfg, _phase12(cfg, batch, CS.GEP_RUNS, "2x2", ("grad",))


def test_phase12_grouped_ep_on_the_cpu(phase12b):
    cfg, (rows, got) = phase12b
    row, run = rows[0], CS.GEP_RUNS[0]
    bad = [k for k, v in row["checks"].items() if not v and not k.startswith(
        LAUNCH_CHECKS + ("transposed layouts", "a2a_ffn / bwd_a2a_ffn "
                         "through"))]
    assert not bad
    assert "every concrete a2a_ffn / bwd_a2a_ffn on tp_out" in row["checks"]
    assert row["elementwise_held"] and row["topology"] == [2, 2]
    assert all(d["choice"] == d["slots"] == 0
               for d in row["routing_differences"])
    predicted = set(CS.moe_matmul_shapes(cfg, "float32", world=4, batch=1,
                                         seq=64, runs=[run],
                                         ring=CS.MESHES["2x2"]["tp_in"]))
    for g in got:
        p = g["runs"][0]
        assert sum(c[-1] for c in p["call_shapes"]) == p["matmul_derived"]
        assert {(M, K, N, lay) for M, K, N, _, lay, _ in p["call_shapes"]} \
            <= predicted
        assert [a[0] for a in p["a2a"]] == [a[0] for a in p["a2a_derived"]] \
            == [2 * cfg.num_layers, cfg.num_layers]


# ---------------------------------------------------------------------------
# phase 13: TP training past whole blocks
# ---------------------------------------------------------------------------


def _legs(cfg, legs):
    """Phase 13's ``phase_train`` at smoke size on the CPU, one spawn for
    all ``legs`` ((batch, runs) pairs): [(rows as ``train_checks`` makes
    them, every rank's runs)] a leg."""
    with tempfile.TemporaryDirectory() as root:
        refs = []
        for i, (b, _) in enumerate(legs):
            leg = Path(root) / f"leg{i}"
            leg.mkdir()
            refs.append(CS.train_reference(b, str(leg), cfg, "cpu"))
        with CS.plan_cache_at(Path(root) / "plans"):
            got = run_ranks(CS.train_legs, 4, [
                (b, runs, store, {k: v for k, v in ref.items()
                                  if k != "routing"})
                for (b, runs), (ref, store) in zip(legs, refs)],
                cfg, "cpu", device="cpu", timeout=600)
    out = []
    for i, ((b, runs), (ref, _)) in enumerate(zip(legs, refs)):
        ranks = [g[i]["runs"] for g in got]
        B, S = b["tokens"].shape
        rows, _ = CS.train_checks(cfg, ref, ranks, runs, B * S // 4)
        out.append((rows, ranks))
    return out


PHASE13_LAUNCHES = LAUNCH_CHECKS + ("matmul_rmsnorm launches", "transposed")


@pytest.fixture(scope="module")
def phase13():
    mcfg = get_arch(CS.MLA_ARCH).smoke()
    mbatch = CS.train_batch(mcfg, 32, CS.MLA_TRAIN_BATCH)
    rcfg = get_arch("internlm2-1.8b").smoke()
    norms = CS.mla_norm_grads(mcfg, mbatch, device="cpu")
    mla = _legs(mcfg, [(mbatch, CS.MLA_TRAIN_RUNS)])[0]
    ragged = _legs(rcfg, [(CS.train_batch(rcfg, 31, 2), CS.RAGGED_RUNS),
                          (CS.train_batch(rcfg, 32, 2), CS.SP_RUNS)])
    return (mcfg, rcfg), norms, mla, ragged


def _held(row):
    bad = [k for k, v in row["checks"].items()
           if not v and not k.startswith(PHASE13_LAUNCHES)]
    assert not bad, bad
    assert row["elementwise_held"]


def test_phase13_mla_on_the_cpu(phase13):
    """(a): the norm grads' check (on the CPU both sides are the plain
    version), then the ring runs held to one device; every matmul call
    among ``sp_ffn_matmul_shapes``, the calls of each kernel the graphs'
    count (matmul_rmsnorm twice and flash once a layer a forward)."""
    (mcfg, _), norms, (rows, ranks), _ = phase13
    assert all(r["got_max"] > 0 for r in norms["grads"].values())
    predicted = set(CS.sp_ffn_matmul_shapes(mcfg, batch=CS.MLA_TRAIN_BATCH,
                                            seq=32))
    for i, row in enumerate(rows):
        _held(row)
        assert row["layout"] == "sharded"
        for rk in ranks:
            p = rk[i]
            assert sum(c[-1] for c in p["call_shapes"]) == \
                p["matmul_derived"] > 0
            assert sum(c[-1] for c in p["norm_shapes"]) == \
                p["mln_derived"] == 2 * mcfg.num_layers
            assert sum(c[-1] for c in p["flash_shapes"]) == \
                p["flash_derived"] == mcfg.num_layers
            assert {(M, K, N, lay) for M, K, N, _, lay, _ in
                    p["call_shapes"]} <= predicted
            if p["mb"] > 1:
                assert p["cross_direction_pairs"]


def test_phase13_ragged_and_sp_off_on_the_cpu(phase13):
    """(b): the ragged step in the replicated layout (its gemm_ar
    dispatches the graphs', every matmul among ``ragged_matmul_shapes``),
    and sequence_parallel off and on, each held to one device, the off loss
    within SP_LOSS_RTOL of the on loss and of one device's."""
    (_, rcfg), _, _, ((rrows, rranks), (srows, _)) = phase13
    _held(rrows[0])
    assert rrows[0]["layout"] == "replicated"
    assert "gemm_ar dispatched through the backend as the graphs hold it" \
        in rrows[0]["checks"]
    predicted = set(CS.ragged_matmul_shapes(rcfg, batch=2, seq=31))
    for rk in rranks:
        p = rk[0]
        assert sum(c[-1] for c in p["call_shapes"]) == p["matmul_derived"]
        assert {(M, K, N, lay) for M, K, N, _, lay, _ in p["call_shapes"]} \
            <= predicted
    off, on = srows
    for row in srows:
        _held(row)
    assert (off["layout"], on["layout"]) == ("gathered", "sharded")
    for x in (on["loss"], off["one_device"]):
        assert abs(off["loss"] - x) <= CS.SP_LOSS_RTOL * abs(x)
