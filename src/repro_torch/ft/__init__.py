from repro_torch.ft.watchdog import Heartbeat, PreemptionGuard, StepWatchdog

__all__ = ["StepWatchdog", "Heartbeat", "PreemptionGuard"]
