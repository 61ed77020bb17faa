"""``chip_smoke.py``'s phase 14 (c) on the CPU at smoke size: one training
step of each recurrent family on a gloo ring of 4 against the one-device
reference, through phase 9's machinery (``train_reference``,
``train_legs``, ``train_checks``), with the plain versions in place of the
kernels (so the launch counters, which only the card moves, are not read
here). The configs mirror the card's: recurrentgemma-2b with 2 query heads
(they do not split over 4 ranks, as its 10 do not on the card: the
attention runs replicated beside the RG-LRU mixers, the FFN through
``sp_ffn``) at batch 1, where cais's 2 microbatches clamp to 1; mamba2-130m
with no FFN (every sub-layer replicated: no period graph runs) at batch 2.
Every check the phase makes on the card holds but the launch counters; the
ranks' matmul calls are the count the graphs derive and lie among
``rec_matmul_shapes``'s prediction (``sp_ffn_matmul_shapes`` at the
clamped split)."""
import sys
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:     # the ranks import the rank body by name
    sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

LAUNCHES = ("matmul launches", "flash launches", "flash variants",
            "matmul variants", "matmul_rmsnorm launches", "transposed")
CFGS = {CS.HYB_ARCH: dict(num_heads=2, num_kv_heads=1),
        CS.SSM_ARCH: dict(d_ff=0)}
SHAPES = {CS.HYB_ARCH: (1, 32), CS.SSM_ARCH: (2, 32)}


@pytest.fixture(scope="module", params=sorted(CFGS))
def phase14(request):
    arch = request.param
    cfg = get_arch(arch).smoke().scaled(**CFGS[arch])
    B, S = SHAPES[arch]
    batch = CS.train_batch(cfg, S, B)
    runs = CS.REC_TRAIN_RUNS[arch]
    with tempfile.TemporaryDirectory() as root:
        ref, store = CS.train_reference(batch, root, cfg, "cpu",
                                        quantities=("grad",))
        with CS.plan_cache_at(Path(root) / "plans"):
            got = run_ranks(CS.train_legs, 4, [
                (batch, runs, store, {k: v for k, v in ref.items()
                                      if k != "routing"})], cfg, "cpu",
                device="cpu", timeout=600)
    ranks = [g[0]["runs"] for g in got]
    rows, _ = CS.train_checks(cfg, ref, ranks, runs, B * S // 4)
    return arch, cfg, runs, rows, ranks


def test_phase14_training_on_the_cpu(phase14):
    arch, cfg, runs, rows, ranks = phase14
    B, S = SHAPES[arch]
    predicted = set(CS.sp_ffn_matmul_shapes(cfg, batch=B, seq=S, runs=runs))
    for i, row in enumerate(rows):
        bad = [k for k, v in row["checks"].items()
               if not v and not k.startswith(LAUNCHES)]
        assert not bad, bad
        assert row["elementwise_held"] and row["layout"] == "sharded"
        # the split a graph takes; no graph runs where every sub-layer is
        # replicated
        assert row["mb"] == (CS.batch_split(B, runs[i][1])
                             if arch == CS.HYB_ARCH else 1)
        for rk in ranks:
            p = rk[i]
            assert sum(c[-1] for c in p["call_shapes"]) == \
                p["matmul_derived"]
            assert {(M, K, N, lay) for M, K, N, _, lay, _ in
                    p["call_shapes"]} <= predicted
            # one flash call a forward per attention layer (replicated),
            # none for the SSM and RG-LRU mixers
            assert sum(c[-1] for c in p["flash_shapes"]) == \
                p["flash_derived"] == CS.swa_layers(cfg)
            if arch == CS.SSM_ARCH:
                assert p["matmul_derived"] == 0 == p["flash_derived"]
            else:
                assert p["matmul_derived"] > 0


def test_phase14_predicted_shapes():
    """The card's phase 3 rows for phase 14: the sp_ffn ring steps of
    recurrentgemma-2b (d 2560, d_ff 7680 / 4 = 1920) at batch 1 (cais's 2
    microbatches clamped to 1), forward and backward; the flash cases at
    the serving, check and ring shapes (10 q heads over 1 kv head, dh 256;
    decode over the 2048-slot window)."""
    mm = CS.rec_matmul_shapes()
    assert {(K, N) for _, K, N, lay in mm if lay == "nn"} == {
        (2560, 1920), (1920, 2560)}
    assert {lay for *_, lay in mm} == {"nn", "nt", "tn"}
    assert CS.batch_split(1, 2) == 1 and CS.batch_split(4, 3) == 2
    cases = CS.rec_flash_cases()
    assert [(B, Sq, Skv) for _, B, Sq, Skv, _ in cases] == [
        (4, 2560, 2560), (4, 1, 2048), (2, 2560, 2560), (2, 1, 2048),
        (1, 4096, 4096)]
