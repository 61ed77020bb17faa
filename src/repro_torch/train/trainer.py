"""Trainer: the production step loop of ``repro/train/trainer.py`` —
checkpoint/restart, straggler watchdog, heartbeat, preemption handling,
deterministic resume.

Restart semantics: the data pipeline is keyed on (seed, step), so
restore(step) and the loop from that step replay the exact stream; on a
mesh with a data axis each replica draws its rows of the global batch. A
run with ``ckpt_dir`` saves through :class:`repro_torch.checkpoint.
AsyncSaver` every ``ckpt_every`` steps, when the watchdog flags a
straggler and on preemption, and a later run restores the latest step on
whatever ring layout it has (each rank its own shards) and goes on from
there: bitwise what the uninterrupted run computes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint import store
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, make_batch, replica_slice
from repro_torch.ft.watchdog import Heartbeat, PreemptionGuard, StepWatchdog
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime import Runtime
from repro_torch.train.step import (init_state, make_train_step,
                                    state_placement)


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10             # 0: no step lines
    microbatches: int = 1
    straggler_threshold: float = 2.5
    heartbeat_path: Optional[str] = None


@dataclass
class Trainer:
    model: Any
    opt: Optimizer
    arch: ArchConfig
    shape: ShapeConfig
    rt: Runtime = Runtime()
    cfg: TrainerConfig = field(default_factory=TrainerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    # injectable for tests: step-time override to simulate stragglers
    _clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self.train_step = make_train_step(self.model, self.opt, self.rt,
                                          self.cfg.microbatches)
        dp = getattr(self.model, "dp", 1)
        self.rows = (replica_slice(self.shape.global_batch,
                                   self.model.data.rank, dp)
                     if dp > 1 else None)
        self.watchdog = StepWatchdog(threshold=self.cfg.straggler_threshold)
        self.history: List[Dict[str, float]] = []
        self.events: List[str] = []

    # ----- state -----
    def fresh_state(self):
        """The train state of the model as built (its weights are drawn
        from its own seed)."""
        return init_state(self.model, self.opt)

    def placement(self):
        """The sharded tensors of this rank's train state
        (:func:`repro_torch.train.step.state_placement`)."""
        return state_placement(self.model, self.opt)

    def restore_or_init(self):
        """The latest checkpoint under ``ckpt_dir`` restored into a fresh
        state (this rank's shards of it), or the fresh state."""
        state = self.fresh_state()
        if self.cfg.ckpt_dir and \
                store.latest_step(self.cfg.ckpt_dir) is not None:
            _, manifest = store.restore(self.cfg.ckpt_dir, state,
                                        placement=self.placement())
            self.events.append(f"restored step {manifest['step']}")
        return state

    # ----- loop -----
    def run(self, state=None):
        state = state if state is not None else self.restore_or_init()
        hb = None
        if self.cfg.heartbeat_path:
            hb = Heartbeat(self.cfg.heartbeat_path)
            hb.start()
        saver = store.AsyncSaver(self.cfg.ckpt_dir, self.model.mesh,
                                 self.placement()) \
            if self.cfg.ckpt_dir else None
        try:
            with PreemptionGuard() as guard:
                for step in range(int(state["step"]), self.cfg.total_steps):
                    t0 = self._clock()
                    batch = make_batch(self.arch, self.shape, step, self.data,
                                       host_slice=self.rows)
                    state, metrics = self.train_step(state, batch)
                    loss = float(metrics["loss"])
                    dt = self._clock() - t0

                    if self.watchdog.observe(step, dt):
                        self.events.append(f"straggler@{step}")
                        # policy: checkpoint now so an orchestrator can
                        # restart on healthy hosts without losing work
                        if saver:
                            saver.save(state, step + 1)
                        self.watchdog.reset()

                    self.history.append(
                        {"step": step, "loss": loss, "dt": dt})
                    if self.cfg.log_every and \
                            step % self.cfg.log_every == 0:
                        print(f"step {step:6d} loss {loss:8.4f} "
                              f"dt {dt*1e3:7.1f}ms", flush=True)
                    if saver and (step + 1) % self.cfg.ckpt_every == 0:
                        saver.save(state, step + 1)
                    if guard.requested:
                        self.events.append(f"preempted@{step}")
                        if saver:
                            saver.save(state, step + 1)
                        break
        finally:
            if saver:
                saver.wait()
            if hb:
                hb.stop()
        return state
