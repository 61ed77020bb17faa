from repro_torch.serve.engine import (Engine, Request, ServeConfig,
                                      paged_supported)
from repro_torch.serve.kv import BlockAllocator, KVView, blocks_needed
from repro_torch.serve.loadgen import (LoadSpec, format_report, generate,
                                       latency_report)
from repro_torch.serve.scheduler import Row, Scheduler

__all__ = ["BlockAllocator", "Engine", "KVView", "LoadSpec", "Request", "Row",
           "Scheduler", "ServeConfig", "blocks_needed", "format_report",
           "generate", "latency_report", "paged_supported"]
