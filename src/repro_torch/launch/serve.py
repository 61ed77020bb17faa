"""Serving launcher: requests through the paged continuous-batching Engine
(which falls back to the dense engine for archs outside the paged path,
such as minicpm3-4b's MLA) or, with ``--engine dense``, the static-batch
DenseEngine, on one device. Counterpart of ``repro/launch/serve.py``.

    python -m repro_torch.launch.serve --arch gemma3-1b
    python -m repro_torch.launch.serve --arch minicpm3-4b
    python -m repro_torch.launch.serve --smoke --device cpu
    python -m repro_torch.launch.serve --arch minicpm3-4b --smoke --device cpu
    python -m repro_torch.launch.serve --load poisson --rate 16 \
        --report reports/serve_latency.json

The flags are ``repro``'s, plus ``--device`` (default ``cuda``: the launcher
fails where there is no card unless told ``--device cpu``) and the serving
shape: ``--prompt-len-min`` (prompt lengths drawn from
[min, ``--prompt-len``]), ``--prefill-chunk`` and ``--block-size``. Only
``--mesh none`` is ported: JAX's meshes have a data-parallel axis (``debug``
is 2 x 4), ROADMAP A14. Serving over a TP ring runs the ``Engine`` on a
model built with ``group=`` on every rank
(:func:`repro_torch.launch.ranks.run_ranks`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional, Tuple, Union

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.runtime import runtime_for
from repro_torch.serve import (DenseEngine, Engine, LoadSpec, Request,
                               ServeConfig, format_report, generate)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "debug", "single", "multi"])
    ap.add_argument("--engine", default="paged", choices=["paged", "dense"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--prompt-len-min", type=int, default=0,
                    help="0: --prompt-len with --load none, half of it "
                         "under a load generator")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int,
                    default=ServeConfig.prefill_chunk)
    ap.add_argument("--block-size", type=int, default=ServeConfig.block_size)
    ap.add_argument("--load", default="none",
                    choices=["none", "poisson", "burst"])
    ap.add_argument("--rate", type=float, default=16.0)
    ap.add_argument("--burst-size", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default="")
    ap.add_argument("--smoke", action="store_true")
    return ap


def main(argv: Optional[List[str]] = None
         ) -> Tuple[Union[Engine, DenseEngine], List[Request]]:
    args = parser().parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: meshes with a data-parallel axis are not "
            "ported yet (ROADMAP A14)")
    cfg = get_arch(args.arch)
    rt = runtime_for(cfg)
    if args.smoke:
        cfg = cfg.smoke()
        rt = dataclasses.replace(rt, compute_dtype="float32")
        args.requests = min(args.requests, 4)
        args.prompt_len = min(args.prompt_len, 8)
        args.prompt_len_min = min(args.prompt_len_min, args.prompt_len)
        args.max_new = min(args.max_new, 4)

    model = build_model(cfg, rt, device=args.device, seed=0)
    sc = ServeConfig(max_batch=args.requests,
                     s_max=args.prompt_len + args.max_new,
                     block_size=args.block_size,
                     prefill_chunk=args.prefill_chunk)
    cls = Engine if args.engine == "paged" else DenseEngine
    eng = cls(model, cfg, rt, sc, device=args.device)

    if args.load == "none":
        rng = np.random.default_rng(1)
        lo = args.prompt_len_min or args.prompt_len
        reqs = [Request(rid=i,
                        prompt=rng.integers(1, cfg.vocab_size,
                                            int(rng.integers(
                                                lo, args.prompt_len + 1))
                                            ).astype(np.int32),
                        max_new_tokens=args.max_new)
                for i in range(args.requests)]
    else:
        spec = LoadSpec(kind=args.load, num_requests=args.requests,
                        rate=args.rate, burst_size=args.burst_size,
                        prompt_len_min=args.prompt_len_min
                        or max(args.prompt_len // 2, 1),
                        prompt_len_max=args.prompt_len,
                        max_new_tokens=args.max_new, seed=args.seed)
        reqs = generate(spec, cfg.vocab_size)

    eng.run(reqs, seed=args.seed)
    for r in reqs:
        print(f"request {r.rid}: {r.out_tokens}")
    kind = "paged" if getattr(eng, "paged", False) else "dense"
    print(f"[{kind} {eng.device}] {format_report(eng.last_report)}")
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as fh:
            json.dump(eng.last_report, fh, indent=1, sort_keys=True)
        print(f"latency report -> {args.report}")
    if not all(r.done and len(r.out_tokens) == r.max_new_tokens
               for r in reqs):
        raise RuntimeError("serve: a request did not finish")
    if args.smoke:
        print(f"serve smoke OK (arch={args.arch} device={eng.device})")
    return eng, reqs


if __name__ == "__main__":
    main()
