"""Calibration: fit the planner's fabric parameters from measured bench rows.

Counterpart of ``repro/plan/calibrate.py``: each *barrier* cell of a bench
JSON (``benchmarks/sublayer.py``'s rows, as committed in
``BENCH_pr10.json``) is rebuilt as the dataflow graph the bench timed
(1-block, 2-block period, and the microbatch-split period at the bench's
tiny shapes) with the port's :func:`repro_torch.core.tp.dense_period_graph`,
lowered through :mod:`repro_torch.plan.lower`, and the fabric's effective
(``mxu_eff``, ``bw``, ``alpha``) are fitted by log-space coordinate descent
so simulated and measured times agree; a second pass fits the inter-node
tier (``bw2``, ``alpha2``) against the 2D-mesh cell when the rows have it.
The same rows give ``repro``'s fit.

The committed rows were measured on CPU-emulated virtual devices of the
JAX package, not on a card: no fit from them describes the H100, and none
becomes the port's fabric. An H100 fit needs rows measured over NCCL on at
least two cards (ROADMAP A13). Only ``barrier`` cells feed the fit (the
emulated ``cais`` wall-clocks serialize their permute chains); every
cell's simulated/measured ratio must stay within ``exp(±RATIO_TOLERANCE)``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core import dataflow as df
from repro_torch.core.perfsim import Fabric
from repro_torch.plan import lower as lower_mod

# max |ln(simulated / measured)| per fitted cell — the documented band
# (BENCH_pr10.json fits at ≈0.23; the slack absorbs runner timing noise when
# the baseline is regenerated, without letting the fit silently diverge).
RATIO_TOLERANCE = 0.6

# REPRO_BENCH_TINY shapes of benchmarks/sublayer.py's measured cells
_TINY = dict(B=2, S=256, d=128, d_ff=256, n=8, dtype_bytes=4)

# bench row name → (number of blocks, microbatch split)
BARRIER_CELLS: Dict[str, Tuple[int, int]] = {
    "block.fused_vs_split.barrier": (1, 1),
    "period.graph_vs_perblock.barrier": (2, 1),
    "period.split_vs_unsplit.barrier": (2, 2),
}

# 2D-mesh bench row → (blocks, microbatch split, n_outer). Measured on the
# hierarchical tp_in × tp_out mesh; feeds the (bw2, alpha2) inter-tier fit.
TOPO_CELLS: Dict[str, Tuple[int, int, int]] = {
    "topo.flat_vs_2d.barrier": (1, 1, 4),
}


@dataclass(frozen=True)
class CalibrationResult:
    fabric: Fabric                      # the fitted cost-model fabric
    ratios: Dict[str, float]            # cell → simulated / measured
    max_abs_log_ratio: float            # worst-cell |ln ratio| after the fit
    fabric2: Optional[Fabric] = None    # two-tier fabric (bw2/alpha2 fitted)

    @property
    def within_tolerance(self) -> bool:
        return self.max_abs_log_ratio <= RATIO_TOLERANCE


def _tiny_weight_shapes(blocks: int) -> Dict[str, tuple]:
    d, d_ff = _TINY["d"], _TINY["d_ff"]
    out: Dict[str, tuple] = {}
    for i in range(blocks):
        p = f"b{i}."
        out.update({p + "scale1": (d,), p + "scale2": (d,),
                    p + "wq": (d, d), p + "wk": (d, d), p + "wv": (d, d),
                    p + "wo": (d, d), p + "w_up": (d, d_ff),
                    p + "w_gate": (d, d_ff), p + "w_down": (d_ff, d)})
    return out


def _cell_graph(blocks: int, mb: int) -> df.Graph:
    """The optimized graph the bench cell executed (dummy attention core —
    the lowering never looks inside local math)."""
    from repro_torch.core import tp as tp_mod

    core = lambda q, k, v: q                               # noqa: E731
    base = tp_mod.dense_period_graph([core] * blocks, has_gate=True,
                                     act="silu")
    merged = base if mb <= 1 else df.merge_graphs([base] * mb,
                                                  share_weights=True)
    return df.optimize(merged)


def _cell_shapes(blocks: int, mb: int):
    B, S, d = _TINY["B"], _TINY["S"], _TINY["d"]
    if mb <= 1:
        values = {"x": (B, S, d)}
    else:
        values = {f"mb{i}.x": (max(B // mb, 1), S, d) for i in range(mb)}
    return values, _tiny_weight_shapes(blocks)


def load_rows(path: str) -> Dict[str, float]:
    """``{row name: us_per_call}`` from a bench JSON artifact."""
    with open(path) as fh:
        rows = json.load(fh)
    return {r["name"]: float(r["us_per_call"]) for r in rows}


def _predictor(cells: Dict[str, Tuple[int, int]]):
    """Precompile the per-cell (graph, shapes) so the fit loop only re-lowers
    with new fabric parameters."""
    compiled = []
    policy = lower_mod.policy_for_backend("barrier")
    for name, (blocks, mb) in cells.items():
        g = _cell_graph(blocks, mb)
        values, weights = _cell_shapes(blocks, mb)
        compiled.append((name, g, values, weights))

    def predict(fabric: Fabric) -> Dict[str, float]:
        return {name: lower_mod.simulate(
            g, fabric, policy, value_shapes=values, weight_shapes=weights,
            dtype_bytes=_TINY["dtype_bytes"])
            for name, g, values, weights in compiled}

    return predict


def calibrate(rows, cells: Optional[Dict[str, Tuple[int, int]]] = None,
              base: Optional[Fabric] = None) -> CalibrationResult:
    """Fit (``mxu_eff``, ``bw``, ``alpha``) so the lowered barrier cells'
    simulated makespans match the measured wall-clocks in ``rows`` (a path
    to a bench JSON, or a ``{name: us_per_call}`` dict). Log-space
    coordinate descent — each parameter scales its term monotonically, so a
    shrinking multiplicative grid converges; deterministic by construction.
    """
    if isinstance(rows, str):
        rows = load_rows(rows)
    cells = dict(cells or BARRIER_CELLS)
    missing = [c for c in cells if c not in rows]
    if missing:
        raise KeyError(f"bench rows missing calibration cells: {missing}")
    measured = {c: rows[c] * 1e-6 for c in cells}          # us → s
    predict = _predictor(cells)

    f = base or Fabric(n=_TINY["n"])

    def loss(fab: Fabric) -> float:
        pred = predict(fab)
        return sum((math.log(max(pred[c], 1e-12)) -
                    math.log(max(measured[c], 1e-12))) ** 2 for c in cells)

    f = _descent(f, ("mxu_eff", "bw", "alpha"), loss)

    pred = predict(f)
    ratios = {c: pred[c] / measured[c] for c in cells}

    # second pass: inter-node tier. Freeze the intra-node fit, seed the
    # outer tier from it, and fit (bw2, alpha2) against the 2D-mesh cells.
    fabric2 = None
    topo = {c: v for c, v in TOPO_CELLS.items() if c in rows}
    if topo:
        measured2 = {c: rows[c] * 1e-6 for c in topo}
        policy2 = lower_mod.policy_for_backend("barrier")
        compiled2 = []
        for name, (blocks, mb, n_outer) in topo.items():
            values, weights = _cell_shapes(blocks, mb)
            compiled2.append((name, _cell_graph(blocks, mb), values, weights,
                              n_outer))

        def predict2(fab: Fabric) -> Dict[str, float]:
            return {name: lower_mod.simulate(
                g, dataclasses.replace(fab, n_outer=n_o), policy2,
                value_shapes=values, weight_shapes=weights,
                dtype_bytes=_TINY["dtype_bytes"])
                for name, g, values, weights, n_o in compiled2}

        def loss2(fab: Fabric) -> float:
            pred2 = predict2(fab)
            return sum((math.log(max(pred2[c], 1e-12)) -
                        math.log(max(measured2[c], 1e-12))) ** 2
                       for c in topo)

        fabric2 = dataclasses.replace(f, bw2=f.bw, alpha2=f.alpha)
        fabric2 = _descent(fabric2, ("bw2", "alpha2"), loss2)
        pred2 = predict2(fabric2)
        ratios.update({c: pred2[c] / measured2[c] for c in topo})

    max_err = max(abs(math.log(r)) for r in ratios.values())
    return CalibrationResult(fabric=f, ratios=ratios,
                             max_abs_log_ratio=max_err, fabric2=fabric2)


def _descent(f: Fabric, params: Tuple[str, ...], loss) -> Fabric:
    """Log-space coordinate descent: each parameter scales its cost term
    monotonically, so a shrinking multiplicative grid converges;
    deterministic by construction."""
    for span in (256.0, 16.0, 4.0, 2.0, 1.25, 1.06):
        for p in params:
            cur = getattr(f, p)
            best_v, best_l = cur, loss(f)
            for k in range(-4, 5):
                v = cur * span ** (k / 4.0)
                if p == "mxu_eff":
                    v = min(v, 1.0)
                cand = dataclasses.replace(f, **{p: v})
                l = loss(cand)
                if l < best_l - 1e-15:
                    best_v, best_l = v, l
            f = dataclasses.replace(f, **{p: best_v})
    return f
