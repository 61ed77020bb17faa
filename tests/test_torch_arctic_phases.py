"""``chip_smoke.py``'s phase 16 on the CPU at smoke size, with the plain
versions in place of the kernels (so the checks on the launch counters,
which only the card moves, are not read here):

- (b1) ``adafactor_leaf_check`` on a small expert leaf: the port's
  adafactor against its formula in f64, every check;
- (b2) ``arctic_train_step`` on arctic-480b's smoke config: the loss
  falls on the batch at the phase's lr, every parameter changes;
- (c) ``phase_ckpt`` on a gloo ring of 2 at internlm2-1.8b's smoke size:
  the checkpoint gathered and written by rank 0, restored on one device and
  on the ring, each step held to the ring's (bitwise on the ring), the
  graphs' launch counts derived."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:     # the ranks import the rank body by name
    sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

LAUNCHES = ("launches", "flash once")


def held(checks):
    """The checks that do not read a launch counter, all held."""
    return {k: v for k, v in checks.items()
            if not any(w in k for w in LAUNCHES)}


def test_phase16_b1_adafactor_leaf_on_the_cpu():
    out = CS.adafactor_leaf_check(shape=(6, 64, 48), device="cpu")
    assert all(out["checks"].values()), out["checks"]
    assert out["err_over_ulp"] <= 1.0 and 0 < out["changed_share"] < 1


def test_phase16_b2_arctic_step_on_the_cpu():
    cfg = get_arch(CS.ARCTIC_ARCH).smoke()
    lm = build_model(cfg, Runtime(compute_dtype="float32"), device="cpu",
                     seed=0)
    out = CS.arctic_train_step(lm, cfg, shape=(1, 64), device="cpu")
    checks = held(out["checks"])
    assert len(checks) == 3 and all(checks.values()), out["checks"]
    assert out["loss_after"] < out["loss"]


def test_phase16_c_checkpoint_across_layouts_on_the_cpu():
    cfg = get_arch(CS.TP_ARCH).smoke()
    out = CS.phase_ckpt(cfg, device="cpu", world=2,
                        batches=CS.ckpt_batches(cfg, 2, 32))
    checks = held(out["checks"])
    assert len(checks) == 8 and all(checks.values()), out["checks"]
    assert out["bitwise"]
    # the one-device core at the whole batch, the ring's at a microbatch
    # of a rank's heads (the shapes phase 3 adds and already holds)
    assert (2, 32, 4, 16, 32, 2, 16, "float32") in out["flash_shapes"]
    assert (1, 32, 2, 16, 32, 1, 16, "float32") in out["flash_shapes"]
