"""``chip_smoke.py``'s phase 15 on the CPU at smoke size, with the plain
versions in place of the kernels (so the launch counters, which only the
card moves, are not read here):

- (e) one paligemma-3b (smoke) training step on a gloo ring of 4 against
  the one-device reference, through phase 9's machinery (``train_reference``,
  ``train_legs``, ``train_checks``) with the phase's runs, 1 x (4 prefix +
  20 text) rows, so rank 0's 6 straddle the prefix boundary: every check
  the phase makes on the card but the launch counters holds, every flash
  call carries the prefix, and the ranks' matmul calls are the count the
  graphs derive and lie among ``vlm_matmul_shapes``'s prediction;
- (a)/(c) ``phase_pf_check`` with both models on the CPU;
- (b)/(d) the dense engine's flash calls through ``launch.serve`` against
  ``pf_serve_launches``'s count, by prefill and decode call;
- the flash cases phase 3 adds for the phase, and the matmul shapes of the
  card's (e)."""
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
B, S = 1, 20                      # 24 rows over 4 ranks: 6 a rank


@pytest.fixture(scope="module")
def phase15e():
    cfg = get_arch(CS.VLM_ARCH).smoke().scaled(num_layers=1)
    batch = CS.train_batch(cfg, S, B)
    runs = CS.VLM_TRAIN_RUNS
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
    return cfg, runs, rows, ranks


def test_phase15e_training_on_the_cpu(phase15e):
    cfg, runs, rows, ranks = phase15e
    P = cfg.num_prefix_tokens
    assert (P + S) // 4 > P        # rank 0's shard straddles the prefix
    predicted = set(CS.vlm_matmul_shapes(cfg, batch=B, seq=S, runs=runs))
    for i, row in enumerate(rows):
        bad = [k for k, v in row["checks"].items()
               if not v and not k.startswith(LAUNCHES)]
        assert not bad, bad
        assert row["checks"]["every flash call causal with the model's "
                              "prefix"]
        assert row["elementwise_held"] and row["layout"] == "sharded"
        assert row["batch"] == [B, P + S]
        for rk in ranks:
            p = rk[i]
            assert sum(c[-1] for c in p["call_shapes"]) == \
                p["matmul_derived"] > 0
            assert {(M, K, N, lay) for M, K, N, _, lay, _ in
                    p["call_shapes"]} <= predicted
            # every core call, the forward's and the training graph's
            assert {tuple(c[8:10]) for c in p["flash_shapes"]} == {(True, P)}
            assert sum(c[-1] for c in p["flash_shapes"]) == \
                p["flash_derived"] >= cfg.num_layers


@pytest.mark.parametrize("arch,grads", [(CS.ENC_ARCH, True),
                                        (CS.VLM_ARCH, False)])
def test_phase15_card_against_cpu_checks_run(arch, grads):
    """(a)/(c)'s check at smoke size, both models on the CPU: the same
    numbers, every check met, the masked calls recorded (whisper's
    non-causal encoder and cross-attention, the VLM's prefix-LM loss)."""
    cfg = get_arch(arch).smoke()
    out = CS.phase_pf_check(cfg, 2, 6, grads, device="cpu")
    assert out["logits_err"] == 0.0 and out["loss_rel"] == 0.0
    masks = {(c[8], c[9]) for c in out["calls"]}
    if cfg.is_enc_dec:
        assert masks == {(False, 0), (True, 0)}
    else:
        assert masks == {(True, cfg.num_prefix_tokens), (True, 0)}


@pytest.mark.parametrize("arch", [CS.ENC_ARCH, CS.VLM_ARCH])
def test_phase15_serving_flash_calls(arch):
    """The dense engine's flash calls of (b)/(d) at smoke size, through
    ``launch.serve``: the count ``pf_serve_launches`` gives, the prefill's
    and the decode calls' masks as the card's (whisper: the encoder and
    cross-attention non-causal; paligemma: causal, no prefix in serving,
    as JAX's ``VLM.prefill``)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    cfg, new = get_arch(arch).smoke(), 3
    calls = {}
    core = CS.record_calls(ops, calls, masked=True)
    try:
        eng, reqs = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                                "--requests", "2", "--max-new", str(new)])
    finally:
        ops.flash_attention = core
    want = CS.pf_serve_launches(cfg, new)
    assert sum(calls.values()) == sum(want.values())
    assert eng.steps == new and not eng.paged
    prefix = [k for k in calls if k[1] > 1]
    decode = [k for k in calls if k[1] == 1]
    if cfg.is_enc_dec:
        assert sum(calls[k] for k in prefix) == want["ffma"]
        assert {k[8] for k in prefix} == {False, True}
        assert {k[8] for k in decode} == {False, True}
    else:
        assert sum(calls[k] for k in prefix) == want["wgmma"]
        assert {(k[8], k[9]) for k in calls} == {(True, 0)}
    assert sum(calls[k] for k in decode) == want["splitkv"]


def test_phase15_flash_cases_and_matmul_shapes():
    cases = CS.pf_flash_cases()
    vlm = get_arch(CS.VLM_ARCH)
    P = vlm.num_prefix_tokens
    by_name = {}
    for c in cases:
        by_name.setdefault(c[0], []).append(c)
    # the prefix rows: f32 ffma at (c)'s and (e)'s shapes, (e)'s in bf16
    # (wgmma), a split-KV decode with queries inside the prefix
    assert [c[2:5] + (c[6], c[8]) for c in by_name["vlm_prefix_ring"]] == [
        (1, P + 1024, P + 1024, torch.float32, P),
        (1, P + 1024, P + 1024, torch.bfloat16, P)]
    assert all(q < P for q in by_name["vlm_prefix_decode"][0][9])
    # whisper's non-causal rows over 1500 frames, both types
    assert {(c[2], c[3], c[4], c[6]) for c in cases
            if c[1] == CS.ENC_ARCH and not c[7]} == {
        (2, 1500, 1500, torch.float32), (2, 64, 1500, torch.float32),
        (2, 1, 1500, torch.float32), (4, 1500, 1500, torch.bfloat16),
        (4, 64, 1500, torch.bfloat16), (4, 1, 1500, torch.bfloat16)}
    mm = CS.vlm_matmul_shapes()
    d, ff = vlm.d_model, vlm.d_ff // CS.TP_WORLD
    assert {(K, N) for _, K, N, lay in mm if lay == "nn"} == {
        (d, 512), (d, 256), (d, ff), (512, d), (ff, d)}
    assert {lay for *_, lay in mm} == {"nn", "nt", "tn"}
    assert CS.pf_serve_launches(get_arch(CS.ENC_ARCH), 16) == dict(
        ffma=12, splitkv=120, wgmma=0)
    assert CS.pf_serve_launches(vlm, 16) == dict(wgmma=18, splitkv=270,
                                                 ffma=0)
