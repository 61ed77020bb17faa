"""The flash-attention kernel of two checkouts of the repo, alternated on one
card.

    python -m repro_torch.launch.ab_flash --trees PARENT CHANGE --rounds 1 \
        --out reports/ab_flash.json

Runs each tree's own ``chip_smoke.py`` phase 3 flash rows
(``phase_kernels``: every call shape the main paths give the kernel, each
against its plain version, timed launched from Python and as a CUDA graph)
from the tree's root, its kernel built from its own source, every run a
fresh process, in the order A B B A once per round, so that drift of the
card or the host falls on both trees alike. Prints, and writes to
``--out``, per row both trees share (case, type, shape) each run's graph
time, the medians and the ratio B / A, beside the card's ``nvidia-smi``
name and power limit; a run whose row disagrees with its plain version
fails the command.
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

ROWS = ("import json, sys, torch; sys.path.insert(0, 'src'); "
        "import chip_smoke as cs; "
        "from repro_torch.configs import get_arch; "
        "from repro_torch.kernels import flash_attention as fa, ref; "
        "torch.backends.cuda.matmul.allow_tf32 = False; "
        "rows = cs.phase_kernels(get_arch(cs.ARCH), fa, ref); "
        "open(sys.argv[1], 'w').write(json.dumps(rows))")


def _key(row: Dict) -> str:
    sh = row["shape"]
    return (f"{row['case']} {row['dtype']} B{sh['B']} Sq{sh['Sq']} "
            f"Skv{sh['Skv']} H{sh['H']}/{sh['Hkv']} dh{sh['dh']}")


def _run(tree: Path, out: Path) -> List[Dict]:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    subprocess.run([sys.executable, "-c", ROWS, str(out)], cwd=tree, env=env,
                   check=True, stdout=subprocess.DEVNULL)
    rows = json.loads(out.read_text())
    bad = [_key(r) for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{tree}: rows disagree with the plain "
                             f"version: {bad}")
    return rows


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, required=True, type=Path,
                    metavar=("A", "B"))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    trees = [t.resolve() for t in args.trees]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    graph: List[Dict[str, List[float]]] = [{}, {}]
    with tempfile.TemporaryDirectory() as tmp:
        for i, t in enumerate([0, 1, 1, 0] * args.rounds):
            for row in _run(trees[t], Path(tmp) / f"{i}.json"):
                graph[t].setdefault(_key(row), []).append(row["graph_ms"])
            print(f"run {i}: {trees[t]}", flush=True)
    rows = {}
    for key in graph[0].keys() & graph[1].keys():
        a, b = (statistics.median(g[key]) for g in graph)
        rows[key] = dict(a=graph[0][key], b=graph[1][key], ratio=b / a)
    ratios = [r["ratio"] for r in rows.values()]
    summary = dict(card=card, order="ABBA", rounds=args.rounds,
                   trees=[str(t) for t in trees], graph_ms=rows,
                   ratio_median=statistics.median(ratios),
                   ratio_min=min(ratios), ratio_max=max(ratios))
    for key in sorted(rows):
        print(f"{key}: {rows[key]['ratio']:.3f} ({rows[key]['a']} -> "
              f"{rows[key]['b']})")
    print(json.dumps({k: v for k, v in summary.items() if k != "graph_ms"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
