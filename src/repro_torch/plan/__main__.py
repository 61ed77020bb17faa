"""Planner smoke: ``python -m repro_torch.plan --selfcheck``.

Device-free tier-1 CI gate: lowers the canonical sublayer graphs, runs the
pairing search (planner makespan must be ≤ greedy's), and round-trips a plan
through the cache (second call must be a hit returning the identical plan).
``--calibrate PATH`` additionally fits the fabric from a bench JSON and
reports the per-cell simulated/measured ratios.
"""
from __future__ import annotations

import argparse
import sys
import tempfile


def selfcheck() -> int:
    from repro_torch.core import dataflow as df
    from repro_torch.core.perfsim import Fabric
    from repro_torch.plan import (PerfsimPlanner, PlanCache, search_period,
                            simulate, policy_for_backend)

    fabric = Fabric(n=8)

    # 1. lower: the optimized sublayer graph costs out under both backends
    g = df.optimize(df.sublayer_graph())
    for backend in ("barrier", "cais"):
        m = simulate(g, fabric, policy_for_backend(backend))
        assert m > 0, f"sublayer lowering produced empty makespan ({backend})"
        print(f"selfcheck: lower sublayer [{backend}] makespan={m:.3e}s")

    # 2. search: on the dual-sublayer graph the planner's simulated makespan
    # must not exceed the greedy pass-3 schedule's
    g2 = df.fuse_sublayer_chain(df.fuse_shared_gather(
        df.fuse_compute_aware(df.dual_sublayer_graph())))
    planner = PerfsimPlanner(fabric=fabric, backend="cais")
    planner.pair(g2)
    p = planner.plan
    assert p is not None and p.makespan <= p.greedy_makespan + 1e-12, \
        f"planner ({p.makespan}) worse than greedy ({p.greedy_makespan})"
    print(f"selfcheck: search dual-sublayer planner={p.makespan:.3e}s "
          f"greedy={p.greedy_makespan:.3e}s pairing={list(p.pairing)}")

    # 3. period search: a 2-chain microbatch split of the sublayer period
    plan = search_period(df.sublayer_graph(), fabric=fabric, backend="cais",
                         x_shape=(8, 512, 1024),
                         weight_shapes={"w1": (1024, 1024),
                                        "w2": (1024, 1024),
                                        "scale": (1024,)},
                         mb_candidates=(1, 2))
    assert plan.makespan <= plan.greedy_makespan + 1e-12
    print(f"selfcheck: period search mb={plan.num_microbatches} "
          f"chunks={plan.num_chunks} makespan={plan.makespan:.3e}s")

    # 4. cache round-trip: miss → put → hit with the identical plan
    with tempfile.TemporaryDirectory() as td:
        cache = PlanCache(root=td)
        pl1 = PerfsimPlanner(fabric=fabric, backend="cais", cache=cache)
        ga = pl1.pair(g2)
        pl2 = PerfsimPlanner(fabric=fabric, backend="cais", cache=cache)
        gb = pl2.pair(g2)
        assert cache.stats == {"hits": 1, "misses": 1}, cache.stats
        assert pl1.plan == pl2.plan, "cache hit returned a different plan"
        assert [n.name for n in ga.nodes] == [n.name for n in gb.nodes]
        print(f"selfcheck: cache round-trip stats={cache.stats}")

    print("selfcheck: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.plan")
    ap.add_argument("--selfcheck", action="store_true",
                    help="lower → search → cache round-trip, no devices")
    ap.add_argument("--calibrate", metavar="BENCH_JSON",
                    help="fit fabric parameters from a bench JSON")
    args = ap.parse_args(argv)
    rc = 0
    if args.selfcheck:
        rc = selfcheck()
    if args.calibrate:
        from repro_torch.plan import RATIO_TOLERANCE, calibrate
        res = calibrate(args.calibrate)
        for cell, r in sorted(res.ratios.items()):
            print(f"calibrate: {cell} simulated/measured={r:.3f}")
        print(f"calibrate: fitted bw={res.fabric.bw:.3e} "
              f"alpha={res.fabric.alpha:.3e} "
              f"mxu_eff={res.fabric.mxu_eff:.3e}"
              f" max|ln ratio|={res.max_abs_log_ratio:.3f} "
              f"(tolerance {RATIO_TOLERANCE})")
        rc = rc or (0 if res.within_tolerance else 1)
    if not args.selfcheck and not args.calibrate:
        ap.print_help()
        return 2
    return rc


if __name__ == "__main__":
    sys.exit(main())
