"""Serving latency of two checkouts of the repo, alternated on one card.

    python -m repro_torch.launch.ab_serve --trees PARENT CHANGE --rounds 2 \
        --out reports/ab_serve.json -- --arch minicpm3-4b --requests 4 \
        --prompt-len 1024 --prompt-len-min 1024 --max-new 16

Runs ``repro_torch.launch.serve``'s ``main(<args>)`` from each tree's root
(``PYTHONPATH=<tree>/src``), every run a fresh process, in the order A B B A
once per round, so that drift of the card or the host over the session
falls on both trees alike. A run serves twice and keeps the second latency
report: the first builds the tree's kernels and pays the process's first
calls (CUDA context, cuBLAS, allocator), as the model served before it
does for ``chip_smoke.py``'s phase 8. Prints, and writes to ``--out``, per tree
the TTFT and per-token p50/p99 of every run, their medians and their spread
(max - min), beside the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

METRICS = ("ttft_p50_ms", "ttft_p99_ms", "per_token_p50_ms",
           "per_token_p99_ms", "tokens_per_sec_per_device")


# serve twice in one process; the second run writes the report
WARM = ("import sys; from repro_torch.launch import serve; "
        "serve.main(sys.argv[2:]); "
        "serve.main(sys.argv[2:] + ['--report', sys.argv[1]])")


def _run(tree: Path, report: Path, serve_args: List[str]) -> None:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    subprocess.run([sys.executable, "-c", WARM, str(report), *serve_args],
                   cwd=tree, env=env, check=True, stdout=subprocess.DEVNULL)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, required=True, type=Path,
                    metavar=("A", "B"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default="")
    ap.add_argument("serve_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    serve_args = [a for a in args.serve_args if a != "--"]
    trees = [t.resolve() for t in args.trees]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
    except FileNotFoundError:
        card = "no nvidia-smi (no NVIDIA card)"
    runs: Dict[str, List[Dict]] = {str(t): [] for t in trees}
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate([0, 1, 1, 0] * args.rounds):
            report = Path(tmp) / f"{i}.json"
            _run(trees[tree], report, serve_args)
            rep = json.loads(report.read_text())
            runs[str(trees[tree])].append({m: rep[m] for m in METRICS})
            print(json.dumps(dict(run=i, tree=str(trees[tree]),
                                  **runs[str(trees[tree])][-1])), flush=True)
    summary = dict(card=card, serve_args=serve_args, order="ABBA",
                   rounds=args.rounds, trees={})
    for tree, rs in runs.items():
        summary["trees"][tree] = {m: dict(
            median=statistics.median(r[m] for r in rs),
            spread=max(r[m] for r in rs) - min(r[m] for r in rs),
            runs=[r[m] for r in rs]) for m in METRICS}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
