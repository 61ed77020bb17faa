"""Where a dense-engine model call spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch minicpm3-4b

Builds the arch at full width and depth with random weights from a seed,
in the serving runtime's types (as ``repro_torch.launch.serve`` does),
runs ``LM.prefill`` of a batch of prompts and then ``LM.decode_step``
calls, and traces a prefill and ``--steps`` decode steps with
``torch.profiler`` after one warm prefill and two warm decode steps. It
prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per phase: the host-clock time of a call (ending in a synchronize), the
device's busy time per call (the union of the CUDA kernels' intervals in
the trace), the idle share of the call's time, and the kernels that took
the most device time. Needs an NVIDIA GPU; fails if the trace holds no
device time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.runtime import runtime_for


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
    for phase, rec in out.items():
        print(json.dumps(dict(phase=phase, arch=args.arch, batch=B,
                              prompt_len=S, dtype=rt.compute_dtype,
                              device=torch.cuda.get_device_name(0), **rec)),
              flush=True)
    return out


if __name__ == "__main__":
    main()
