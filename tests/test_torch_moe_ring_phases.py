"""``chip_smoke.py``'s phase 17 on the CPU at smoke size, with the plain
versions in place of the kernels (so the checks that read the launch
counters, which only the card moves, are not read here): mixtral-8x7b's
and arctic-480b's smoke configs served by ``moe_ring_rank`` on a gloo ring
of 4 against the one-device port's scripted schedule and Engine, through
``moe_ring_checks``."""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.runtime import runtime_for  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:     # the ranks import the rank body by name
    sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

TRAFFIC = dict(requests=4, prompt_min=9, prompt_max=14, max_new=4, chunk=8,
               block=4)
# the bound phase 17 takes from phase 10 on the card; at smoke size the
# ring's bf16 logits lie about 1 % from one device's
REL_BOUND = 0.05


def one_device(arch, dtype):
    """(phase 17's case, its one-device reference) for ``arch``'s smoke
    config: the scripted schedule in ``dtype`` and the bf16 Engine."""
    cfg = get_arch(arch).smoke()
    rt = runtime_for(get_arch(arch))
    lm = LM(cfg, dataclasses.replace(rt, compute_dtype=dtype), device="cpu",
            seed=CS.SEED)
    steps = CS.moe_scripted_steps(cfg, TRAFFIC)
    routes, restore = CS.routing_probe()
    try:
        logits, _ = CS.run_scripted(lm, steps, TRAFFIC["block"])
    finally:
        restore()
    lm.rt = dataclasses.replace(rt, compute_dtype="bfloat16")
    prompts = CS.serve_prompts(cfg, TRAFFIC)
    tokens, _ = CS.engine_tokens(lm, cfg, prompts, TRAFFIC)
    ref = dict(logits=logits, routes=list(routes), tokens=tokens,
               report=dict(ttft_p50_ms=0.0, per_token_p50_ms=0.0))
    return (arch.split("-")[0], cfg, rt, steps, prompts, dtype), ref


def test_phase17_on_the_cpu():
    cases, refs = [], {}
    for arch, dtype in (("mixtral-8x7b", "float32"),
                        ("arctic-480b", "bfloat16")):
        case, refs[case[0]] = one_device(arch, dtype)
        cases.append(case)
    ranks = run_ranks(CS.moe_ring_rank, 4, TRAFFIC, cases, "cpu")
    rows, _ = CS.moe_ring_checks(ranks, cases, refs, REL_BOUND)
    for row in rows:
        for run in ("scripted", "engine"):
            checks = {k: v for k, v in row[run]["checks"].items()
                      if "launches" not in k}
            assert checks and all(checks.values()), (row["model"], run,
                                                      checks)
    mixtral, arctic = (r["scripted"] for r in rows)
    assert mixtral["logits_held_steps"] == len(cases[0][3])
    assert all(n == TRAFFIC["requests"] for n in arctic["rows_held"])
    # a rank's experts: 3 GEMMs each a layer a step (smoke: 4 experts, 1 a
    # rank), and one all-reduce node an MoE layer a step
    for row, (_, cfg, _, steps, _, _) in zip(rows, cases):
        r = row["scripted"]
        assert r["expert_calls"] == 3 * cfg.num_layers * len(steps)
        assert r["derived"]["allreduce"] == cfg.num_layers * len(steps)
