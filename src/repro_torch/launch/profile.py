"""Where a serving call spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch minicpm3-4b
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch internlm2-1.8b --tp 4 --dtype bfloat16

Builds the arch at full width and depth with random weights from a seed,
in the serving runtime's types (as ``repro_torch.launch.serve`` does), or
in ``--dtype``. With ``--tp 1`` (the default) it runs ``LM.prefill`` of a
batch of prompts and then ``LM.decode_step`` calls, and traces a prefill
and ``--steps`` decode steps with ``torch.profiler`` after one warm prefill
and two warm decode steps. With ``--tp N`` it spawns N ranks of a gloo ring
that share the card, each with its shards and its paged KV pools, runs
``LM.serve_step`` with the ``cais`` backend over ``--prompt-len`` tokens in
prefill chunks of 128 and then decode steps on every rank, and traces rank 0's last
prefill chunk and ``--steps`` decode steps after two warm decode steps.
It prints the card's ``nvidia-smi`` name and power limit, then one JSON
line per phase: the host-clock time of a call (ending in a synchronize),
the device's busy time per call (the union of the CUDA kernels' intervals
in the trace), the idle share of the call's time, and the kernels that
took the most device time; on a ring also the host time a call spends
inside the ring's collectives, split into the wait for the card to finish
the work queued before each one (``drain``) and the rest (the host
staging copies and gloo's wire). Needs an NVIDIA GPU; fails if the trace
holds no device time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.runtime import runtime_for

# a ring run's prefill chunk and KV pool block: the paged engine's traffic
# in chip_smoke.py phases 5 and 10
RING_CHUNK, RING_BLOCK = 128, 16


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="minicpm3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=8,
                    help="decode steps traced")
    ap.add_argument("--top", type=int, default=12,
                    help="kernels listed per phase")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the prompt tokens")
    ap.add_argument("--tp", type=int, default=1,
                    help="ranks of a gloo ring sharing the card (paged "
                         "serve_step on the ring, rank 0 traced)")
    ap.add_argument("--dtype", default=None,
                    help="compute type (default: the serving runtime's)")
    return ap


def trace(fn: Callable[[], None], calls: int, top: int) -> Dict:
    """Run ``fn`` ``calls`` times under the profiler; the host time of a
    call and the device kernels' busy time per call, by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the trace holds no device time")
    busy, end = 0.0, float("-inf")
    by_name: Dict[str, List[float]] = {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name.setdefault(name, []).append(e - s)
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]
    return dict(calls=calls, wall_ms_per_call=wall_us / calls / 1e3,
                device_busy_ms_per_call=busy / calls / 1e3,
                idle_share=1.0 - busy / wall_us,
                kernels_per_call=len(spans) / calls,
                top=[dict(name=n[:120], ms_per_call=sum(d) / calls / 1e3,
                          launches_per_call=len(d) / calls)
                     for n, d in ranked])


class _CollectiveClock:
    """Host time spent inside a :class:`repro_torch.sharding.TPGroup`'s
    collectives, wrapped on the instance: ``drain`` is the wait for the
    card to finish the work queued before each collective (its staging copy
    would wait for it anyway), ``wire`` the rest."""

    NAMES = ("all_gather", "reduce_scatter", "all_reduce", "ppermute_many")

    def __init__(self, group):
        self.calls, self.drain, self.wire = 0, 0.0, 0.0
        for name in self.NAMES:
            setattr(group, name, self._wrap(getattr(group, name)))

    def _wrap(self, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*a, **k)
            self.calls += 1
            self.drain += t1 - t0
            self.wire += time.perf_counter() - t1
            return out
        return timed

    def reset(self):
        self.calls, self.drain, self.wire = 0, 0.0, 0.0

    def per_call(self, calls: int) -> Dict:
        return dict(collectives_per_call=self.calls / calls,
                    collective_drain_ms_per_call=self.drain / calls * 1e3,
                    collective_wire_ms_per_call=self.wire / calls * 1e3)


def ring_rank(group, args: argparse.Namespace, device: str = "cuda"
              ) -> Optional[Dict]:
    """One rank of the ``--tp`` run: the paged serving steps on every rank,
    traced on rank 0 (which returns the phases; the others return None)."""
    from repro_torch.models import LM
    from repro_torch.models.attention import KVView
    from repro_torch.runtime import Runtime, TPConfig

    cfg = get_arch(args.arch)
    rt = Runtime(compute_dtype=args.dtype or runtime_for(cfg).compute_dtype,
                 tp=TPConfig(mode="cais"))
    lm = LM(cfg, rt, device=device, seed=0, group=group)
    if device == "cuda":
        torch.cuda.empty_cache()        # the whole model drawn for the shards
    B, C, bs = args.batch, RING_CHUNK, RING_BLOCK
    chunks = -(-args.prompt_len // C)
    nb = -(-(chunks * C + 2 + args.steps) // bs)
    tables = (1 + torch.arange(B * nb, dtype=torch.int32,
                               device=device)).view(B, nb)
    pools = lm.init_pools(1 + B * nb, bs)
    rng = np.random.default_rng(args.seed)
    state = {"pos": 0}

    def step(S: int):
        p = state["pos"]
        toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S))
                                .astype(np.int32)).to(device)
        pos = (p + torch.arange(S, dtype=torch.int32, device=device)
               ).expand(B, S).contiguous()
        view = KVView(tables, pos,
                      torch.full((B,), p + S, dtype=torch.int32,
                                 device=device),
                      torch.full((B,), S - 1, dtype=torch.int32,
                                 device=device))
        lm.serve_step(toks, pools, view)
        state["pos"] = p + S

    clock = _CollectiveClock(group) if group.rank == 0 else None
    out = {}
    for c in range(chunks):
        if c < chunks - 1 or clock is None:
            step(C)
        else:
            clock.reset()
            out["prefill_chunk"] = {**trace(lambda: step(C), 1, args.top),
                                    **clock.per_call(1)}
    step(1)                                 # warm decode steps
    step(1)
    if clock is None:
        for _ in range(args.steps):
            step(1)
        if device == "cuda":
            torch.cuda.synchronize()
        return None
    clock.reset()
    out["decode"] = {**trace(lambda: step(1), args.steps, args.top),
                     **clock.per_call(args.steps)}
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    cfg = get_arch(args.arch)
    rt = runtime_for(cfg)
    if args.dtype:
        rt = dataclasses.replace(rt, compute_dtype=args.dtype)
    extra = {}
    if args.tp > 1:
        from repro_torch.kernels import flash_attention, matmul, nvcc
        from repro_torch.launch.ranks import run_ranks

        nvcc.build_all([flash_attention.SOURCE, matmul.SOURCE])
        out = run_ranks(ring_rank, args.tp, args, backend="gloo",
                        device="cuda", timeout=900)[0]
        extra = dict(tp=args.tp, mode="cais", chunk=RING_CHUNK,
                     wire="gloo, staged through the host")
    else:
        out = dense_phases(cfg, rt, args)
    for phase, rec in out.items():
        print(json.dumps(dict(phase=phase, arch=args.arch, batch=args.batch,
                              prompt_len=args.prompt_len,
                              dtype=rt.compute_dtype, **extra,
                              device=torch.cuda.get_device_name(0), **rec)),
              flush=True)
    return out


def dense_phases(cfg, rt, args: argparse.Namespace) -> Dict:
    """The one-device run: a traced prefill and ``--steps`` traced decode
    steps over dense caches."""
    lm = build_model(cfg, rt, device="cuda", seed=0)
    B, S = args.batch, args.prompt_len
    s_max = S + 3 + args.steps
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    state = {}

    def prefill():
        state["caches"] = lm.prefill(tokens, s_max=s_max)[1]
        state["pos"] = S

    def decode():
        tok = torch.full((B, 1), 7, dtype=torch.int32, device="cuda")
        idx = torch.full((B,), state["pos"], dtype=torch.int32,
                         device="cuda")
        lm.decode_step(tok, state["caches"], idx)
        state["pos"] += 1

    prefill()                           # warm: kernels built, pools grown
    decode()
    decode()
    out = {"prefill": trace(prefill, 1, args.top)}
    out["decode"] = trace(decode, args.steps, args.top)
    return out


if __name__ == "__main__":
    main()
