"""``chip_smoke.py``'s phases 9 and 10 on the CPU at smoke size.

Phase 9: the one-device
reference step and its host store, and the rank body on a gloo ring of 4,
with the plain versions in place of the kernels (so the kernels' launch
counters, which only the card moves, are not read here). Everything else
the phase asserts on the card is held: the ranks' losses, grad norms,
gradients, m, v and parameters against the reference within the phase's
own bounds, the matmul and flash calls against the graph-derived counts,
overlap_asym as the graphs say with a cross-direction pair at 2
microbatches, and every transposed matmul call among the shapes phase 3
checks.

Phase 10: the one-device serving references and the rank body on a gloo
ring of 4 (internlm2-1.8b, and gemma3-1b's replicated kv head and window),
with a small traffic: every check the phase makes on the card except the
launch counters and variants, and every matmul call shape among those
``serve_matmul_shapes`` predicts for phase 3."""
import sys
import tempfile
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


@pytest.fixture(scope="module")
def phase9():
    cfg = get_arch("internlm2-1.8b").smoke()
    batch = make_batch(cfg, ShapeConfig("t", 32, 2, "train"), 0,
                       DataConfig(CS.SEED))
    with tempfile.TemporaryDirectory() as root:
        ref, store = CS.train_reference(batch, root, cfg, "cpu")
        ranks = run_ranks(CS.train_rank, 4, batch, CS.TRAIN_RUNS, store, ref,
                          cfg, "cpu", device="cpu", timeout=600)
    return cfg, ref, ranks


@pytest.mark.parametrize("i", range(len(CS.TRAIN_RUNS)),
                         ids=["-".join(map(str, r)) for r in CS.TRAIN_RUNS])
def test_phase9_on_the_cpu(phase9, i):
    cfg, ref, ranks = phase9
    mode, mb, dtype = CS.TRAIN_RUNS[i]
    per = [rk[i] for rk in ranks]
    f32 = dtype == "float32"
    assert len({p["loss"] for p in per}) == 1
    want = ref["loss"] if f32 else ref["loss_bf16"]
    rtol = CS.F32_LOSS_RTOL if f32 else CS.BF16_LOSS_RTOL
    assert abs(per[0]["loss"] - want) <= rtol * abs(want)
    predicted = {tuple(s) for s in CS.train_matmul_shapes(
        cfg, world=4, batch=2, seq=32, runs=[CS.TRAIN_RUNS[i]])}
    for p in per:
        assert sum(c[-1] for c in p["call_shapes"]) == p["matmul_derived"]
        assert p["flash_derived"] == 3 * mb * cfg.num_layers
        assert p["overlap_asym"] == p["overlap_asym_nodes"]
        assert bool(p["cross_direction_pairs"]) == (mb > 1)
        got = {(M, K, N, lay) for M, K, N, _, lay, _ in p["call_shapes"]
               if lay != "nn"}
        assert got and got <= predicted
        if f32:
            assert abs(p["grad_norm"] - ref["grad_norm"]) <= \
                CS.TRAIN_RTOL * ref["grad_norm"]
            for e in p["errs"].values():
                for q in ("grad", "m", "v"):
                    assert e[q][0] <= e[q][1]
                assert e["param"][1] <= 1.0


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
    ranks = run_ranks(CS.serve_tp_rank, 4, TRAFFIC, CS.SERVE_TP_RUNS,
                      prompts, steps, rsteps, cfg, rcfg, "cpu", device="cpu",
                      timeout=600)
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
    predicted = set(CS.serve_matmul_shapes(c, TRAFFIC))
    for rk in ranks:
        p = rk[0][i] if i < len(CS.SERVE_TP_RUNS) else rk[1]
        assert sum(s[-1] for s in p["matmul_shapes"]) == p["matmul_derived"]
        assert sum(s[-1] for s in p["flash_shapes"]) == p["flash_derived"]
        assert {tuple(s[:3]) for s in p["matmul_shapes"]} <= predicted
        assert p["gemm_ar"] == p["gemm_ar_derived"] > 0
    if row["tokens"] is not None:
        assert row["steps"] == row["engine_steps"] + len(
            CS.scripted_steps(cfg, TRAFFIC, CS.SCRIPTED_CHUNKS))
