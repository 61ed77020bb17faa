"""The port's checkpoint/restart (``repro_torch.checkpoint``, the Trainer's
and the launcher's ``ckpt_dir``) on the CPU: the counterparts of
``tests/test_substrate.py``'s checkpoint tests, port against port (a run
that checkpoints; a kill at step 4 and a restart to 8, bitwise, AdamW and
adafactor; crc corruption; a straggler's and a preemption's save; bf16
leaves; the async saver's snapshot), restores across ring layouts (one
gloo world of 4 factored into a ring of 4, a ring of 2 under a data axis
and a 2 x 2 mesh, and one device: each writes a checkpoint and restores
the others'; the next step held to one device's), a JAX train state
written by ``repro.checkpoint.store.save`` continued in the port through
the bridge, and ``launch.train --ckpt-dir`` resuming under ``--mesh
debug`` from a one-device checkpoint. The ranks run in their own
processes (``tests/torch_rank_cells.py``, no JAX), one spawn of 4."""
import functools
import json
import os
import shutil
import signal
import tempfile

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data.pipeline import make_batch as jax_make_batch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import constant_schedule as jconst  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402

import torch_rank_cells as cells  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import constant_schedule, make_optimizer  # noqa: E402
from repro_torch.runtime import SMOKE  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.step import init_state, make_train_step  # noqa: E402

TINY = ShapeConfig("tiny", 16, 4, "train")
OPTS = ("adamw", "adafactor")


def tiny_trainer(opt_name="adamw", arch="internlm2-1.8b", **kw):
    cfg = get_arch(arch).smoke()
    model = build_model(cfg, SMOKE, device="cpu", seed=0)
    opt = make_optimizer(opt_name, constant_schedule(1e-3))
    return Trainer(model, opt, cfg, TINY, SMOKE,
                   TrainerConfig(log_every=0, **kw))


# ---------------------------------------------------------------------------
# test_substrate.py's checkpoint tests, port against port
# ---------------------------------------------------------------------------


def test_trainer_runs_and_checkpoints(tmp_path):
    tr = tiny_trainer(total_steps=6, ckpt_dir=str(tmp_path), ckpt_every=3)
    tr.run()
    assert store.latest_step(str(tmp_path)) == 6
    assert len(tr.history) == 6
    # repro's layout: step_%08d/{manifest.json, arrays.npz}, LATEST
    d = tmp_path / "step_00000006"
    assert (tmp_path / "LATEST").read_text() == "step_00000006"
    assert sorted(os.listdir(d)) == ["arrays.npz", "manifest.json"]
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000003",
                                            "step_00000006"]
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["step"] == 6
    assert {"params::embed", "opt::m::embed", "opt::v::embed",
            "step"} <= set(manifest["keys"])
    assert len(manifest["keys"]) == len(manifest["shapes"]) == \
        len(manifest["dtypes"]) == len(manifest["crc32"])
    # a second save of a step (a straggler's, then the periodic one)
    # replaces the first
    state = tr.fresh_state()
    store.save(str(tmp_path), state, 6, extra={"again": True})
    assert json.loads((d / "manifest.json").read_text())["extra"] == \
        {"again": True}
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000003",
                                            "step_00000006"]


@pytest.mark.parametrize("opt_name", OPTS)
def test_checkpoint_restart_determinism(opt_name, tmp_path):
    """Kill at step 4, restart, finish: bitwise the uninterrupted run's
    parameters and optimizer state."""
    full = tiny_trainer(opt_name, total_steps=8).run()
    d = str(tmp_path)
    tiny_trainer(opt_name, total_steps=4, ckpt_dir=d, ckpt_every=4).run()
    b = tiny_trainer(opt_name, total_steps=8, ckpt_dir=d, ckpt_every=100)
    resumed = b.run()
    assert "restored step 4" in b.events
    assert [h["step"] for h in b.history] == [4, 5, 6, 7]
    assert resumed["step"] == full["step"] == 8
    want, got = store.flatten(full), store.flatten(resumed)
    assert set(want) == set(got)
    for k in want:
        if k != "step":
            assert torch.equal(want[k], got[k]), k


def test_checkpoint_crc_detects_corruption(tmp_path):
    tr = tiny_trainer()
    state = tr.fresh_state()
    path = store.save(str(tmp_path), state, step=1)
    arrays = os.path.join(path, "arrays.npz")
    data = bytearray(open(arrays, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(arrays, "wb").write(bytes(data))
    with pytest.raises(Exception):
        store.restore(str(tmp_path), tiny_trainer().fresh_state())


def test_restore_raises_on_a_missing_key_or_a_shard_shape(tmp_path):
    tr = tiny_trainer()
    state = tr.fresh_state()
    store.save(str(tmp_path), {"params": state["params"], "step": 0}, 1)
    with pytest.raises(KeyError, match="opt::m::embed"):
        store.restore(str(tmp_path), tiny_trainer().fresh_state())
    # a tensor whose whole shape is not the checkpoint's (a shard's shape
    # where the placement says nothing)
    half = {"embed": torch.zeros(state["params"]["embed"].shape[0] // 2,
                                 state["params"]["embed"].shape[1])}
    with pytest.raises(ValueError, match="not the whole shape"):
        store.restore(str(tmp_path), {"params": half, "step": 0})


def test_straggler_watchdog_detects_and_checkpoints(tmp_path):
    """Slow steps injected through the trainer's clock: the watchdog flags
    them and a checkpoint is dropped for an orchestrated restart."""
    times = iter([0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 1.0, 2.0, 3.0, 4.0, 5.0,
                  6.0, 7.0, 7.1, 7.2, 7.3])
    tr = tiny_trainer(total_steps=7, ckpt_dir=str(tmp_path),
                      ckpt_every=1000, straggler_threshold=2.0)
    tr._clock = lambda: next(times)
    tr.run()
    flagged = [e for e in tr.events if e.startswith("straggler@")]
    assert flagged, tr.events
    assert store.latest_step(str(tmp_path)) == \
        int(flagged[0].split("@")[1]) + 1


def test_preemption_saves_and_stops(tmp_path):
    """SIGTERM during step 2: the trainer saves step 3 and stops."""
    calls = iter(range(100))

    def clock():
        if next(calls) == 4:             # step 2's first reading
            os.kill(os.getpid(), signal.SIGTERM)
        return 0.0
    tr = tiny_trainer(total_steps=8, ckpt_dir=str(tmp_path),
                      ckpt_every=1000)
    tr._clock = clock
    tr.run()
    assert "preempted@2" in tr.events
    assert store.latest_step(str(tmp_path)) == 3
    assert len(tr.history) == 3


def test_bf16_leaves_round_trip_bitwise(tmp_path):
    """bf16 tensors go to disk as their raw 16 bits ("bfloat16" in the
    manifest, int16 in the npz, the crc over those bytes) and come back
    bitwise."""
    g = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn(5, 7, generator=g).to(
        torch.bfloat16), "b": torch.randn(3, generator=g)},
        "opt": {"w": {"vr": torch.rand(5, generator=g)}}, "step": 3}
    path = store.save(str(tmp_path), state, 3)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    dt = dict(zip(manifest["keys"], manifest["dtypes"]))
    assert dt == {"params::w": "bfloat16", "params::b": "float32",
                  "opt::w::vr": "float32", "step": "int32"}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert z[str(manifest["keys"].index("params::w"))].dtype == np.int16
    fresh = {"params": {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                        "b": torch.zeros(3)},
             "opt": {"w": {"vr": torch.zeros(5)}}, "step": 0}
    store.restore(str(tmp_path), fresh)
    assert fresh["step"] == 3
    for k, t in store.flatten(state).items():
        if k != "step":
            assert torch.equal(store.flatten(fresh)[k], t), k
            assert store.flatten(fresh)[k].dtype == t.dtype


def test_async_saver_snapshot_is_unchanged_by_the_next_step(tmp_path,
                                                            monkeypatch):
    """``AsyncSaver.save`` copies the state before it returns (on the CPU,
    ``.cpu()`` of a CPU tensor is the tensor itself): a step taken while
    the file is still being written changes nothing in it."""
    inner = store._write
    started = []

    def slow_write(*a, **kw):
        started.append(True)
        import time
        time.sleep(0.3)                  # the next step runs meanwhile
        return inner(*a, **kw)
    monkeypatch.setattr(store, "_write", slow_write)
    tr = tiny_trainer("adafactor")
    state = tr.fresh_state()
    batch = make_batch(tr.arch, TINY, 0, tr.data)
    state, _ = tr.train_step(state, batch)
    want = {k: t.clone() for k, t in store.flatten(state).items()
            if k != "step"}
    saver = store.AsyncSaver(str(tmp_path))
    saver.save(state, 1)
    state, _ = tr.train_step(state, batch)      # updates in place
    saver.wait()
    assert started
    assert not all(torch.equal(state["params"][k], want[f"params::{k}"])
                   for k in state["params"])
    fresh = tiny_trainer("adafactor").fresh_state()
    store.restore(str(tmp_path), fresh)
    for k, t in store.flatten(fresh).items():
        if k != "step":
            assert torch.equal(t, want[k]), k


# ---------------------------------------------------------------------------
# restores across ring layouts: one gloo world of 4
# ---------------------------------------------------------------------------


LAYOUT_LR = 1e-2
# (optimizer, layout, the layout whose step-1 checkpoint it restores; None:
# it runs step 0 and writes its own). One device writes "1" before the
# spawn and restores the ring's after it
SPAWN_RUNS = [("adafactor", "4", None), ("adafactor", "4", "1"),
              ("adafactor", "4", "4"), ("adafactor", "2", None),
              ("adafactor", "2", "4"), ("adafactor", "2", "1"),
              ("adafactor", "2x2", None), ("adafactor", "2x2", "4"),
              ("adafactor", "2x2", "2"), ("adafactor", "2x2", "1"),
              ("adamw", "4", None)]
ONE_RUNS = [("adafactor", "1", "4"), ("adafactor", "1", "2"),
            ("adafactor", "1", "2x2"), ("adamw", "1", "4")]
LAYOUT_CASES = [(o, lay if src is None else f"{lay}<-{src}")
                for o, lay, src in SPAWN_RUNS + ONE_RUNS]


def layout_batches(cfg):
    shape = ShapeConfig("layout", 32, 2, "train")
    return [make_batch(cfg, shape, k) for k in (0, 1)]


@functools.lru_cache(maxsize=None)
def layout_runs():
    """({(optimizer, "layout" or "layout<-source"): (step 1's loss, grad
    norm)}, the
    directory holding every run's checkpoints): one device's own runs
    first, the spawn of 4, then one device's restores of the ring's."""
    cfg = get_arch("internlm2-1.8b").smoke()
    root = tempfile.mkdtemp(prefix="ckpt_layouts_")
    batches = layout_batches(cfg)
    res = {}
    for opt_name in OPTS:
        res[(opt_name, "1")] = cells.ckpt_step_run(
            None, cfg, root, batches, opt_name, LAYOUT_LR, "1")
    ranks = run_ranks(cells.ckpt_layout_cells, 4, cfg, root, batches,
                      SPAWN_RUNS, LAYOUT_LR)
    assert not any(r.pop("_jax_imported") for r in ranks)
    for r in ranks[1:]:
        assert r == ranks[0]             # every rank's loss and grad norm
    res.update(ranks[0])
    for opt_name, lay, src in ONE_RUNS:
        res[(opt_name, f"{lay}<-{src}")] = cells.ckpt_step_run(
            None, cfg, root, batches, opt_name, LAYOUT_LR, lay, src)
    return res, root


def _out(root, opt_name, run):
    return store.read(os.path.join(root, opt_name, "out", run), 2)[0]


@pytest.mark.parametrize("opt_name,run", LAYOUT_CASES)
def test_restore_reshards_across_layouts(opt_name, run):
    """Step 1 from another layout's checkpoint ("layout<-source") against
    the writing layout's own step 1 from the same state; a layout's own
    run against one device's. Loss and grad norm within 1e-5, and every
    whole tensor of the state saved after the step within 1e-5 of the
    tensor's scale (a restore on the layout that wrote it: bitwise).
    AdamW's parameters within lr times its update's bound from a gradient
    error of 1e-5 of the tensor's largest (the sign-like first step makes
    two layouts' runs differ where a gradient is near zero, so its own
    runs hold loss and grad norm only)."""
    res, root = layout_runs()
    lay, _, src = run.partition("<-")
    ref = src or "1"
    loss, gnorm = res[(opt_name, run)]
    want_loss, want_gnorm = res[(opt_name, ref)]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert abs(gnorm - want_gnorm) <= 1e-5 * abs(want_gnorm)
    got, want = _out(root, opt_name, run), _out(root, opt_name, ref)
    assert set(got) == set(want)
    if opt_name == "adamw" and not src:
        return
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        if lay == src:
            np.testing.assert_array_equal(got[k], want[k])
        limit = 1e-5 * max(1.0, float(np.abs(w).max()))
        if opt_name == "adamw" and k.startswith("params::"):
            # u = m̂ / (sqrt(v̂) + eps) moves by at most 2δ / (sqrt(v̂) +
            # eps) (and 2) for a gradient error δ: lr times that
            v_hat = np.asarray(want["opt::v::" + k[len("params::"):]],
                               np.float64) / (1 - 0.95 ** 2)
            delta = 1e-5 * np.sqrt(v_hat.max())
            limit = limit + LAYOUT_LR * np.minimum(
                2.0, 2 * delta / (np.sqrt(v_hat) + 1e-8))
        assert (np.abs(np.asarray(got[k], np.float64) - w) <= limit).all(), k
    # adafactor keeps JAX's leaves, whole on disk: a stacked norm's vc
    # (every layer's), a column-split weight's vr whole
    if opt_name == "adafactor":
        assert got["opt::stack.periods.b0.norm1.scale::vr"].shape == (2,)
        assert got["opt::stack.periods.b0.mixer.wq::vc"].shape == (2, 64)


# ---------------------------------------------------------------------------
# a JAX checkpoint continued in the port
# ---------------------------------------------------------------------------


JAX_STEPS = 2


@pytest.mark.parametrize("opt_name", OPTS)
def test_jax_checkpoint_continues_in_the_port(opt_name, tmp_path):
    """``repro``'s smoke train state after JAX_STEPS steps, written by
    ``repro.checkpoint.store.save``, loaded through the bridge
    (``load_jax_checkpoint`` → ``load_state``): the port's next step within
    1e-5 of JAX's (loss, grad norm, every parameter)."""
    arch = "arctic-480b" if opt_name == "adafactor" else "internlm2-1.8b"
    jc, tc = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    shape = JShapeConfig("t", 16, 4, "train")
    jm = jax_build_model(jc, JAX_SMOKE)
    jo = jax_make_optimizer(opt_name, jconst(1e-3))
    st = jax_init_state(jm, jo, jax.random.key(0))
    step = jax.jit(jax_make_train_step(jm, jo, JAX_SMOKE))
    for k in range(JAX_STEPS):
        st, _ = step(st, jax_make_batch(jc, shape, k))
    jstore.save(str(tmp_path), st, JAX_STEPS)
    st, jm_ = step(st, jax_make_batch(jc, shape, JAX_STEPS))

    whole = bridge.load_jax_checkpoint(str(tmp_path), tc)
    assert whole["step"] == JAX_STEPS
    model = build_model(tc, SMOKE, device="cpu", seed=1)
    opt = make_optimizer(opt_name, constant_schedule(1e-3))
    state = init_state(model, opt)
    store.load_state(state, store.flatten(whole))
    assert state["step"] == JAX_STEPS
    state, m = make_train_step(model, opt, SMOKE)(
        state, make_batch(tc, ShapeConfig("t", 16, 4, "train"), JAX_STEPS))
    assert abs(float(m["loss"]) - float(jm_["loss"])) <= \
        1e-5 * abs(float(jm_["loss"]))
    assert abs(float(m["grad_norm"]) - float(jm_["grad_norm"])) <= \
        1e-5 * abs(float(jm_["grad_norm"]))
    want = bridge.state_dict_from_jax(jax.tree.map(np.asarray,
                                                   st["params"]), tc)
    for k, p in state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-5)


def test_train_state_from_jax_keeps_adafactor_groups():
    """The bridge's train state: AdamW's m/v unstacked like the params,
    adafactor's state in JAX's stacked groups under :func:`jax_leaf`'s
    names, equal to the port's own init's shapes."""
    jc, tc = jax_get_arch("gemma3-1b").smoke().scaled(num_layers=7), \
        get_arch("gemma3-1b").smoke().scaled(num_layers=7)
    jm = jax_build_model(jc, JAX_SMOKE)
    model = build_model(tc, SMOKE, device="cpu", seed=0)
    for opt_name in OPTS:
        jo = jax_make_optimizer(opt_name, jconst(1e-3))
        st = jax.tree.map(np.asarray, jax_init_state(
            jm, jo, jax.random.key(0)))
        got = bridge.train_state_from_jax(st, tc)
        own = init_state(model, make_optimizer(opt_name,
                                               constant_schedule(1e-3)))
        a, b = store.flatten(got), store.flatten(own)
        assert set(a) == set(b)
        for k in a:
            if k != "step":
                assert tuple(a[k].shape) == tuple(b[k].shape), k
    assert "stack.rem.0.mixer.wq" in got["opt"]


# ---------------------------------------------------------------------------
# the launcher under --mesh debug
# ---------------------------------------------------------------------------


def test_launcher_resumes_under_the_debug_mesh(tmp_path):
    """A one-device checkpoint at step 2 (``launch.train --ckpt-dir``),
    resumed by ``--mesh debug`` (8 ranks: each restores its shards; rank 0
    writes) and, in a copy, by one device: the same step 2 loss (the two
    layouts agree within 1e-5), and the mesh's step-3 checkpoint restores
    on one device."""
    d_one, d_mesh = str(tmp_path / "one"), str(tmp_path / "mesh")
    base = ["--arch", "deepseek-7b", "--smoke", "--device", "cpu",
            "--tp-mode", "cais", "--ckpt-every", "2"]
    train_launch.main(base + ["--steps", "2", "--ckpt-dir", d_one])
    shutil.copytree(d_one, d_mesh)
    one = train_launch.main(base + ["--steps", "3", "--ckpt-dir", d_one])
    run = train_launch.main(base + ["--steps", "3", "--ckpt-dir", d_mesh,
                                    "--mesh", "debug"])
    assert "restored step 2" in one.events
    assert len(run.ranks) == 8
    for h in run.ranks:
        assert [x["step"] for x in h] == [2]
        assert abs(h[0]["loss"] - one.history[0]["loss"]) <= \
            1e-5 * abs(one.history[0]["loss"])
    assert store.latest_step(d_mesh) == 2
    more = train_launch.main(base + ["--steps", "4", "--ckpt-dir", d_mesh,
                                     "--ckpt-every", "4"])
    assert "restored step 2" in more.events
    assert store.latest_step(d_mesh) == 4


def test_checkpoint_modules_import_no_jax():
    import subprocess
    import sys

    code = ("import sys; import repro_torch.checkpoint, repro_torch.bridge, "
            "repro_torch.train.trainer, repro_torch.optim; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH="src"))
    assert out.stdout.strip() == "False"
