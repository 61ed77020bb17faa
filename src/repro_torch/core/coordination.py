"""Chunk scheduling — the paper's merging-aware TB coordination (§III-B).

Copy of ``repro/core/coordination.py`` (pure Python). One difference: every
planner defaults to the :data:`repro_torch.hw.H100` spec instead of the
TPU's; pass ``hw=V5E`` to plan exactly as ``repro`` does. The notes below
are the JAX package's, written for a TPU ring.

On SPMD TPU the paper's *temporal alignment* problem is solved structurally:
every chip runs the same program, so chunk k's permute is issued at the same
program point everywhere (the 35 µs request skew of independently-scheduled
TBs does not exist). What remains is the *resource* side of the same
trade-off: the per-step staging buffer (our merge-table analogue) holds
``payload / num_chunks`` bytes in flight, and the hop latency α plays the
role of the merge-window — chunks too small make latency dominate (the
analogue of early-arriving requests being evicted before their peers show
up), chunks too big serialize compute behind communication.

:func:`plan` picks ``num_chunks`` from the α-β model under a staging-bytes
budget; :func:`schedule_metrics` evaluates any chunking (the Fig. 13/14
sensitivity sweeps call it directly); :func:`plan_microbatches` applies the
same latency-floor reasoning one level up, to how many independent
microbatch chains a period graph should split into (``tp.sp_period``'s
``num_microbatches="auto"``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from repro_torch.hw import H100, HWSpec


@dataclass(frozen=True)
class SchedulePlan:
    num_chunks: int
    staging_bytes: int          # per-step in-flight bytes (merge-table size)
    step_time: float            # per ring-step wall time (s)
    total_comm: float           # full ring traversal (s)
    latency_fraction: float     # α / per-chunk time — merge-window pressure
    overlap_efficiency: float   # fraction of wire time hideable behind compute
    # the staging-bytes budget forced num_chunks past the latency cap
    # (max_chunks): the budget wins, but callers can see it happened instead
    # of silently getting c > max_chunks
    over_cap: bool = False


def schedule_metrics(payload_bytes: float, ring: int, num_chunks: int,
                     compute_time: float = 0.0,
                     bidirectional: bool = True,
                     hw: HWSpec = H100) -> SchedulePlan:
    """Evaluate one chunking choice.

    payload_bytes: full (global) tensor bytes moved by the collective.
    ring: TP axis size. compute_time: the GEMM time available to hide wire
    time behind (0 = bare collective)."""
    c = max(1, num_chunks)
    dirs = 2 if bidirectional else 1
    shard = payload_bytes / ring                  # bytes per device
    chunk = shard / c                             # bytes per micro-chunk
    wire_per_dir = chunk / dirs / hw.ici_bw
    step_time = hw.hop_latency + wire_per_dir
    steps = (ring - 1) * c
    total = steps * step_time
    per_chunk = hw.hop_latency + wire_per_dir
    lat_frac = hw.hop_latency / per_chunk
    if compute_time > 0:
        hidden = min(total, compute_time)
        eff = hidden / total if total > 0 else 1.0
    else:
        eff = 0.0
    return SchedulePlan(
        num_chunks=c,
        staging_bytes=int(chunk),
        step_time=step_time,
        total_comm=total,
        latency_fraction=lat_frac,
        overlap_efficiency=eff,
    )


def plan(payload_bytes: float, ring: int, *, compute_time: float = 0.0,
         staging_budget: int = 4 * 1024**2, max_latency_fraction: float = 0.25,
         bidirectional: bool = True, max_chunks: int = 64,
         hw: HWSpec = H100) -> SchedulePlan:
    """Pick num_chunks: the largest chunking (finest overlap) whose per-chunk
    latency fraction stays below ``max_latency_fraction``, subject to the
    staging buffer fitting ``staging_budget``. Mirrors the paper's finding
    that coordination lets a small merge table (40 KB/port) suffice.

    The latency cap ``max_chunks`` bounds the chunk count from above; the
    staging budget bounds it from below (``c >= shard / budget``). When the
    two conflict the budget wins (staging bytes are a hard resource), and the
    returned plan flags ``over_cap=True`` instead of silently exceeding the
    cap. With ``compute_time > 0`` the planner additionally prefers the
    finest chunking whose full wire time still fits UNDER the available
    compute time — ``total_comm(c) = (ring-1)·(c·α + shard/(dirs·bw))`` grows
    with c, so past the point where wire time stops hiding behind compute,
    extra chunks only add exposed hop latency."""
    shard = payload_bytes / ring
    # latency bound: chunk >= α·β·(1/maxfrac - 1)
    dirs = 2 if bidirectional else 1
    min_chunk = hw.hop_latency * hw.ici_bw * dirs * \
        (1.0 / max_latency_fraction - 1.0)
    c_latency = max(1, int(shard / max(min_chunk, 1.0)))
    # staging bound: chunk <= budget  =>  c >= shard / budget
    c_staging = max(1, math.ceil(shard / staging_budget))
    c_hi = max(c_staging, min(c_latency, max_chunks))
    c = c_hi
    if compute_time > 0 and ring > 1 and hw.hop_latency > 0:
        # finest c whose total wire time fits under compute_time:
        # (ring-1)·(c·α + shard/(dirs·bw)) <= compute_time
        slack = compute_time / (ring - 1) - shard / (dirs * hw.ici_bw)
        c_fit = int(slack / hw.hop_latency) if slack > 0 else 0
        c = min(c_hi, max(c_staging, c_fit))
    p = schedule_metrics(payload_bytes, ring, c, compute_time,
                         bidirectional, hw)
    return dataclasses.replace(p, over_cap=c_staging > max_chunks)


def plan_microbatches(batch: int, payload_bytes: float, ring: int, *,
                      max_microbatches: int = 4,
                      max_latency_fraction: float = 0.25,
                      bidirectional: bool = True,
                      hw: HWSpec = H100) -> int:
    """How many independent microbatch chains should a period graph split
    into (``tp.sp_period``'s ``num_microbatches="auto"``)?

    Splitting multiplies the independent gemm_rs/ag_gemm pairs pass 3 can
    co-schedule (``overlap_asym``) but divides every collective's payload by
    the same factor, pushing chunks toward the hop-latency floor — the same
    merge-window trade-off :func:`plan` resolves one level down. Accept the
    largest power-of-two split (≤ ``max_microbatches``) that divides
    ``batch`` and whose per-microbatch α-β plan still carries ≥2 chunks
    above the latency bound (room left to pipeline within each chain).

    ``payload_bytes`` is the full-batch payload of the period's largest
    collective (the gathered activation); ``batch`` is the per-device batch
    the split has to divide."""
    if ring <= 1 or batch <= 1:
        return 1
    mb = 1
    cand = 2
    while cand <= min(max_microbatches, batch):
        if batch % cand:
            break
        p = plan(payload_bytes / cand, ring,
                 max_latency_fraction=max_latency_fraction,
                 bidirectional=bidirectional, hw=hw)
        if p.num_chunks < 2:
            break
        mb = cand
        cand *= 2
    return mb
