"""Load generator + latency metrics for the serving benchmarks. A copy of
``repro/serve/loadgen.py`` (numpy only).

Arrival processes are seeded and fully deterministic (numpy ``default_rng``
— no wall clock enters generation), so a load-gen run is replayable
token-for-token together with the engine's per-token sampling seeds
(docs/serving.md). Two processes:

- ``poisson``: exponential inter-arrival gaps at ``rate`` requests/sec.
- ``burst``: ``num_requests // burst_size`` bursts, ``gap_s`` apart; every
  request in a burst arrives at the same instant. This is the adversarial
  case for a static-batch engine (it must serialize same-length groups)
  and the showcase for continuous batching.

Metrics are computed from per-request timestamps the engine records
(``t_first_token``, ``token_times`` — seconds relative to run start):
TTFT = first-token time − arrival time (includes queueing), per-token
latency = inter-token gaps after the first token, throughput =
total generated tokens / makespan / device count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

__all__ = ["LoadSpec", "generate", "latency_report", "format_report"]


@dataclass(frozen=True)
class LoadSpec:
    kind: str = "poisson"           # "poisson" | "burst"
    num_requests: int = 16
    rate: float = 8.0               # poisson: requests/sec
    burst_size: int = 4             # burst: requests per burst
    gap_s: float = 0.25             # burst: seconds between bursts
    prompt_len_min: int = 4
    prompt_len_max: int = 12
    max_new_tokens: int = 8
    temperature: float = 0.0
    seed: int = 0


def generate(spec: LoadSpec, vocab_size: int) -> List[object]:
    """Deterministic request list (arrival times set, prompts drawn from
    [1, vocab) so pad token 0 never appears in a prompt)."""
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(spec.seed)
    if spec.kind == "poisson":
        gaps = rng.exponential(1.0 / spec.rate, spec.num_requests)
        arrivals = np.cumsum(gaps) - gaps[0]          # first at t=0
    elif spec.kind == "burst":
        arrivals = np.array([(i // spec.burst_size) * spec.gap_s
                             for i in range(spec.num_requests)])
    else:
        raise ValueError(f"unknown arrival process: {spec.kind!r}")
    out = []
    for i in range(spec.num_requests):
        plen = int(rng.integers(spec.prompt_len_min, spec.prompt_len_max + 1))
        prompt = rng.integers(1, vocab_size, plen).astype(np.int32)
        out.append(Request(rid=i, prompt=prompt,
                           max_new_tokens=spec.max_new_tokens,
                           temperature=spec.temperature,
                           arrival_time=float(arrivals[i])))
    return out


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def latency_report(requests: List[object], makespan_s: float,
                   n_devices: int = 1,
                   kv_utilization: Optional[float] = None,
                   seed: Optional[int] = None) -> Dict[str, float]:
    """p50/p99 TTFT, p50/p99 per-token latency, tokens/sec/device,
    KV-block utilization — the committed bench-cell schema."""
    ttft = [r.t_first_token - r.arrival_time for r in requests
            if r.t_first_token is not None]
    per_tok: List[float] = []
    for r in requests:
        ts = r.token_times
        per_tok += [b - a for a, b in zip(ts, ts[1:])]
    total_tokens = sum(len(r.out_tokens) for r in requests)
    rep = {
        "num_requests": float(len(requests)),
        "total_tokens": float(total_tokens),
        "makespan_s": makespan_s,
        "ttft_p50_ms": _pct(ttft, 50) * 1e3,
        "ttft_p99_ms": _pct(ttft, 99) * 1e3,
        "per_token_p50_ms": _pct(per_tok, 50) * 1e3,
        "per_token_p99_ms": _pct(per_tok, 99) * 1e3,
        "tokens_per_sec_per_device":
            total_tokens / makespan_s / max(n_devices, 1)
            if makespan_s > 0 else 0.0,
    }
    if kv_utilization is not None:
        rep["kv_block_utilization"] = kv_utilization
    if seed is not None:
        rep["seed"] = float(seed)
    return rep


def format_report(rep: Dict[str, float]) -> str:
    keys = ("ttft_p50_ms", "ttft_p99_ms", "per_token_p50_ms",
            "per_token_p99_ms", "tokens_per_sec_per_device", "makespan_s")
    return " ".join(f"{k}={rep[k]:.2f}" for k in keys if k in rep)
