"""Trainer: the step loop with the straggler watchdog, heartbeat,
preemption handling and logging of ``repro/train/trainer.py``.

The data pipeline is keyed on (seed, step), so any step's batch is replayed
exactly; on a mesh with a data axis each replica draws its rows of the
global batch. Checkpoint/restart (``ckpt_dir``) waits for the port of
``checkpoint/store.py`` (ROADMAP A15) and raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, make_batch, replica_slice
from repro_torch.ft.watchdog import Heartbeat, PreemptionGuard, StepWatchdog
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime import Runtime
from repro_torch.train.step import init_state, make_train_step


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
        if self.cfg.ckpt_dir:
            raise NotImplementedError("checkpointing is not ported yet "
                                      "(checkpoint/store.py, ROADMAP A15)")
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

    # ----- loop -----
    def run(self, state=None):
        state = state if state is not None else self.fresh_state()
        hb = None
        if self.cfg.heartbeat_path:
            hb = Heartbeat(self.cfg.heartbeat_path)
            hb.start()
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
                        self.watchdog.reset()

                    self.history.append(
                        {"step": step, "loss": loss, "dt": dt})
                    if self.cfg.log_every and \
                            step % self.cfg.log_every == 0:
                        print(f"step {step:6d} loss {loss:8.4f} "
                              f"dt {dt*1e3:7.1f}ms", flush=True)
                    if guard.requested:
                        self.events.append(f"preempted@{step}")
                        break
        finally:
            if hb:
                hb.stop()
        return state
