"""Fault-tolerance hooks: straggler watchdog, heartbeats, preemption. A copy
of ``repro/ft/watchdog.py`` (pure Python).

TPU SPMD has no per-step partial recovery — the production policy is
detect → checkpoint → restart (possibly on a smaller/different mesh, see
checkpoint.restore's resharding). This module supplies the detection and
policy layer the Trainer drives:

  * StepWatchdog   — EWMA of step times; flags persistent stragglers
                     (paper-adjacent: the same temporal-skew problem CAIS's
                     TB coordination solves at µs scale appears at cluster
                     scale as slow hosts).
  * Heartbeat      — liveness file another process/orchestrator can watch;
                     missing beats ⇒ the job is hung ⇒ external restart.
  * PreemptionGuard— converts SIGTERM into a "save-and-exit-clean" request.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class StepWatchdog:
    """Flags a straggler when step time exceeds `threshold` × EWMA for
    `patience` consecutive steps."""

    threshold: float = 2.0
    patience: int = 3
    alpha: float = 0.1
    ewma: Optional[float] = None
    strikes: int = 0
    flagged_steps: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True when a persistent straggler is detected."""
        if self.ewma is None:
            self.ewma = dt
            return False
        is_slow = dt > self.threshold * self.ewma
        if is_slow:
            self.strikes += 1
            self.flagged_steps.append(step)
        else:
            self.strikes = 0
            # only fold healthy steps into the EWMA (stragglers would mask
            # themselves by inflating the baseline)
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return self.strikes >= self.patience

    def reset(self):
        self.strikes = 0


class Heartbeat:
    """Writes a monotonic beat to a file every `interval` seconds from a
    daemon thread; orchestrators restart the job when the file goes stale."""

    def __init__(self, path: str, interval: float = 10.0):
        self.path = path
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self):
        n = 0
        while not self._stop.wait(self.interval):
            n += 1
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{n} {time.time()}")
            os.replace(tmp, self.path)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)


class PreemptionGuard:
    """SIGTERM/SIGINT → set a flag the trainer polls each step; the trainer
    checkpoints and exits cleanly instead of dying mid-step."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._signals = signals
        self._prev = {}

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False
