"""Schedule search: enumerate candidate decisions, score each by simulated
makespan over the lowering bridge, return the argmin as a :class:`Plan`.

Counterpart of ``repro/plan/search.py``: the same candidates in the same
order and the same strict-``<`` tie-break, so the same inputs give
``repro``'s plan. :func:`period_planner` plans against the port's
:data:`repro_torch.hw.H100` unless given another spec, and it and
:class:`PerfsimPlanner` take a ``memo_key`` (the in-process memo of
:class:`repro_torch.plan.cache.PlanCache`).

Three decision axes (the knobs the greedy pipeline fixes by heuristic):

* **pass-3 pairings** — not just nearest-independent-first: a bounded DFS
  over the pairing state space (each fusion changes which pairs remain
  legal, so this is a real search tree, branch-bounded and deduped on the
  final pair *set*, which determines the final graph);
* **num_chunks** per collective (the merge-table granularity);
* **num_microbatches** — how many independent chains a period graph splits
  into (:func:`search_period`), trading pass-3 pairing opportunities against
  per-chain payloads near the hop-latency floor.

The greedy choice is always in the candidate set (the DFS's first branch at
every level IS the greedy pick), so the argmin's simulated makespan is ≤ the
greedy schedule's by construction — the acceptance bar the planner tests pin.

All of this is generic over merged forward+backward training graphs: the
backward vocabulary (``bwd_ag_gemm``, ``bwd_a2a_ffn``, backward ``gemm_ar``
/ ``gemm_rs``) lowers through the same bridge, and
:func:`repro_torch.core.dataflow.asymmetric_candidates` ranks cross-direction
pairs first (one op downstream of a ``d.*`` cotangent seed, one not), so the
search naturally overlaps e.g. microbatch-1's backward grad-a2a/RS against
microbatch-0's forward gathers in an MoE training period.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from repro_torch.core import dataflow as df
from repro_torch.core.perfsim import Fabric
from repro_torch.plan import cache as cache_mod
from repro_torch.plan import lower as lower_mod

# chunk candidates the search sweeps for chunk-granularity backends
# (None = the policy's own default)
CHUNK_CANDIDATES: Tuple[Optional[int], ...] = (None, 2, 4, 16)

# extra (inner, outer) chunk pairs swept on two-tier fabrics — the per-axis
# chunking a hierarchical 2D mesh makes available (the slow inter-node tier
# usually wants fewer, larger chunks than the intra-node ring)
TIER_CHUNK_CANDIDATES: Tuple[Tuple[int, int], ...] = \
    ((2, 1), (4, 1), (4, 2), (16, 2), (16, 4), (2, 4))


@dataclass(frozen=True)
class Plan:
    """One schedule decision: the ordered pass-3 pairing, the collective
    chunking, the period split — plus the simulated evidence for it."""

    pairing: Tuple[Tuple[str, str], ...]
    num_chunks: object      # None | int | (inner, outer) on two-tier fabrics
    num_microbatches: int
    makespan: float
    greedy_makespan: float
    backend: str

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["pairing"] = [list(p) for p in self.pairing]
        return d

    @staticmethod
    def from_dict(d: dict) -> "Plan":
        nc = d["num_chunks"]
        return Plan(pairing=tuple((p[0], p[1]) for p in d["pairing"]),
                    num_chunks=tuple(nc) if isinstance(nc, list) else nc,
                    num_microbatches=d["num_microbatches"],
                    makespan=d["makespan"],
                    greedy_makespan=d["greedy_makespan"],
                    backend=d["backend"])


def enumerate_pairings(g: df.Graph, branch: int = 3, max_states: int = 64
                       ) -> List[Tuple[Tuple[Tuple[str, str], ...],
                                       df.Graph]]:
    """Bounded DFS over pass-3 pairing sequences of a post-pass-2 graph.

    At each state the top-``branch`` candidates (nearest-first ranking) are
    explored; terminal states (no legal pair left) are collected, deduped on
    the pair *set* (same set ⇒ same final graph regardless of order). The
    unpaired graph itself is always a candidate — overlap is usually but not
    axiomatically free under the cost model. First result is always the
    greedy sequence (branch 0 at every level)."""
    results: List[Tuple[Tuple[Tuple[str, str], ...], df.Graph]] = []
    seen = set()

    def rec(cur: df.Graph, acc: List[Tuple[str, str]]):
        if len(results) >= max_states:
            return
        cands = df.asymmetric_candidates(cur)
        if not cands:
            key = frozenset(acc)
            if key not in seen:
                seen.add(key)
                results.append((tuple(acc), cur))
            return
        for a, b in cands[:branch]:
            if len(results) >= max_states:
                return
            rec(df.apply_pair(cur, a, b), acc + [(a.name, b.name)])

    rec(g, [])
    if frozenset() not in seen:
        results.append(((), g))
    return results


def search_pairing(g2: df.Graph, *,
                   fabric: Fabric,
                   backend: str = "cais",
                   value_shapes: Optional[Dict[str, tuple]] = None,
                   weight_shapes: Optional[Dict[str, tuple]] = None,
                   dtype_bytes: int = 4,
                   num_microbatches: int = 1,
                   chunk_candidates: Sequence[Optional[int]] =
                   CHUNK_CANDIDATES,
                   branch: int = 3, max_states: int = 64,
                   comp_hints: Optional[Dict[str, float]] = None) -> Plan:
    """Argmin over (pairing × num_chunks) for one post-pass-2 graph.

    Deterministic: candidate order is deterministic, and ties break toward
    the earlier candidate (strict ``<``), so the same inputs always return
    the identical Plan — the property the plan cache relies on.
    ``comp_hints`` (node name → global FLOPs for fn-carrying local math,
    e.g. attention cores) flows into every candidate's lowering so
    compute-bound pairings are weighted correctly."""
    if value_shapes is None or weight_shapes is None:
        vs, ws = lower_mod.synthesize_shapes(g2)
        value_shapes = {**vs, **(value_shapes or {})}
        weight_shapes = {**ws, **(weight_shapes or {})}

    policy = lower_mod.policy_for_backend(backend)
    if policy.granularity == "barrier":
        chunk_candidates = (None,)
    elif getattr(fabric, "two_tier", False):
        # per-axis chunking: on a two-tier fabric also sweep (inner, outer)
        # pairs so the slow tier can chunk differently from the fast one
        chunk_candidates = tuple(chunk_candidates) + tuple(
            c for c in TIER_CHUNK_CANDIDATES if c not in chunk_candidates)

    def score(graph: df.Graph, chunks) -> float:
        return lower_mod.simulate(
            graph, fabric, policy,
            value_shapes=value_shapes, weight_shapes=weight_shapes,
            dtype_bytes=dtype_bytes, num_chunks=chunks,
            comp_hints=comp_hints)

    candidates = enumerate_pairings(g2, branch=branch, max_states=max_states)
    greedy_graph = df.pair_asymmetric(g2)
    greedy_makespan = score(greedy_graph, None)

    best: Optional[Plan] = None
    for pairing, graph in candidates:
        for chunks in chunk_candidates:
            m = score(graph, chunks)
            if best is None or m < best.makespan:
                best = Plan(pairing=pairing, num_chunks=chunks,
                            num_microbatches=num_microbatches,
                            makespan=m, greedy_makespan=greedy_makespan,
                            backend=backend)
    assert best is not None
    return best


def microbatch_value_shapes(x_shape: tuple, mb: int) -> Dict[str, tuple]:
    """Input shapes of a ``merge_graphs``-split period graph: each chain's
    ``mb{i}.x`` carries 1/mb of the batch (the unsplit graph keeps ``x``)."""
    if mb <= 1:
        return {"x": tuple(x_shape)}
    per = (max(x_shape[0] // mb, 1),) + tuple(x_shape[1:])
    return {f"mb{i}.x": per for i in range(mb)}


def microbatch_comp_hints(hints: Optional[Dict[str, float]], mb: int
                          ) -> Optional[Dict[str, float]]:
    """Re-key single-chain ``comp_hints`` onto a ``merge_graphs``-split
    period graph: each chain's ``mb{i}.``-prefixed node does 1/mb of the
    base node's FLOPs (the unsplit graph keeps the base keys)."""
    if not hints:
        return None
    if mb <= 1:
        return dict(hints)
    return {f"mb{i}.{k}": v / mb
            for i in range(mb) for k, v in hints.items()}


def search_period(base: df.Graph, *,
                  fabric: Fabric,
                  backend: str = "cais",
                  x_shape: tuple,
                  weight_shapes: Dict[str, tuple],
                  dtype_bytes: int = 4,
                  mb_candidates: Sequence[int] = (1, 2, 4),
                  chunk_candidates: Sequence[Optional[int]] =
                  CHUNK_CANDIDATES,
                  branch: int = 3, max_states: int = 48,
                  comp_hints: Optional[Dict[str, float]] = None) -> Plan:
    """Joint argmin over (num_microbatches × pairing × num_chunks) for a
    single-chain period graph ``base`` (pre-optimization, input ``x`` of
    global shape ``x_shape``). Every mb candidate re-runs passes 1–2 on the
    merged graph, then the pairing search; makespans are comparable because
    every candidate schedules the same total work. ``comp_hints`` is keyed
    on BASE node names and re-prefixed per chain."""
    best: Optional[Plan] = None
    batch = int(x_shape[0])
    for mb in mb_candidates:
        if mb < 1 or (mb > 1 and (mb > batch or batch % mb)):
            continue
        merged = base if mb <= 1 else df.merge_graphs(
            [base] * mb, share_weights=True)
        g2 = df.fuse_sublayer_chain(
            df.fuse_shared_gather(df.fuse_compute_aware(merged)))
        p = search_pairing(
            g2, fabric=fabric, backend=backend,
            value_shapes=microbatch_value_shapes(x_shape, mb),
            weight_shapes=weight_shapes, dtype_bytes=dtype_bytes,
            num_microbatches=mb, chunk_candidates=chunk_candidates,
            branch=branch, max_states=max_states,
            comp_hints=microbatch_comp_hints(comp_hints, mb))
        if best is None or p.makespan < best.makespan:
            best = p
    assert best is not None
    return best


class FixedPairing:
    """A pass-3 planner that replays a decided pairing (a cache hit or a
    :func:`search_period` winner); falls back to ``base`` (a live planner)
    if the pairing no longer applies to the graph it is handed."""

    def __init__(self, plan: Plan, base: "PerfsimPlanner"):
        self.plan = plan
        self.base = base

    def pair(self, g2: df.Graph) -> df.Graph:
        try:
            return df.pair_asymmetric(g2, pairing=self.plan.pairing)
        except df.GraphError:
            out = self.base.pair(g2)
            self.plan = self.base.plan
            return out


def period_planner(base: df.Graph, *,
                   x_shape: tuple,
                   weight_shapes: Dict[str, tuple],
                   dtype_bytes: int,
                   tp: int,
                   backend: str,
                   mb_candidates: Sequence[int],
                   hw=None,
                   n_outer: int = 1,
                   cache: Optional[cache_mod.PlanCache] = None,
                   comp_hints: Optional[Dict[str, float]] = None,
                   memo_key: Optional[Hashable] = None
                   ) -> Tuple[Plan, FixedPairing]:
    """The ``tp.sp_period`` entry point: decide (num_microbatches, pairing,
    num_chunks) for one single-chain period graph, through the plan cache.

    ``x_shape`` is the per-DP-replica activation (b_loc, S, d) — the payload
    the TP collectives actually move. ``n_outer > 1`` (a hierarchical 2D
    mesh's ``tp_out`` size) builds a two-tier fabric, so the same period
    graph caches and plans DIFFERENTLY per topology — the fabric is part of
    the cache key. ``comp_hints`` (base-graph node name → FLOPs, part of
    the cache key) prices the fn-carrying local math. Returns the winning
    :class:`Plan` and a :class:`FixedPairing` to hand to
    ``dataflow.optimize(planner=...)`` for the mb-merged graph. ``hw``
    defaults to :data:`repro_torch.hw.H100` (``repro``: its TPU ``V5E``).
    With a ``cache`` and a ``memo_key`` (a hashable description of
    everything above, built by the caller), a decision kept in the process
    is reused before the cache key is computed."""
    from repro_torch.hw import H100

    hw = hw or H100
    fabric = lower_mod.fabric_from_hw(hw, max(tp, 2), n_outer=n_outer)
    mb_candidates = tuple(sorted(set(int(m) for m in mb_candidates))) or (1,)
    key = None
    plan: Optional[Plan] = None
    if cache is not None and memo_key is not None:
        plan = cache.memo_get(memo_key)
    if plan is None and cache is not None:
        key = cache_mod.plan_key(
            base, {"x": tuple(x_shape)}, weight_shapes, dtype_bytes, fabric,
            backend, extra={"kind": "period", "mb": list(mb_candidates),
                            "hints": sorted(
                                (k, float(v))
                                for k, v in (comp_hints or {}).items())})
        hit = cache.get(key)
        if hit is not None:
            plan = Plan.from_dict(hit)
    if plan is None:
        plan = search_period(base, fabric=fabric, backend=backend,
                             x_shape=tuple(x_shape),
                             weight_shapes=weight_shapes,
                             dtype_bytes=dtype_bytes,
                             mb_candidates=mb_candidates,
                             comp_hints=comp_hints)
        if cache is not None and key is not None:
            cache.put(key, plan.to_dict())
    if cache is not None and memo_key is not None:
        cache.memo_put(memo_key, plan)
    fallback = PerfsimPlanner(
        value_shapes=microbatch_value_shapes(x_shape,
                                            plan.num_microbatches),
        weight_shapes=weight_shapes, dtype_bytes=dtype_bytes,
        fabric=fabric, backend=backend,
        num_microbatches=plan.num_microbatches,
        comp_hints=microbatch_comp_hints(comp_hints,
                                         plan.num_microbatches))
    return plan, FixedPairing(plan, fallback)


class PerfsimPlanner:
    """A pass-3 planner object for :func:`repro_torch.core.dataflow.optimize`.

    ``pair(g2)`` looks the (graph, shapes, topology, backend) key up in the
    plan cache, otherwise runs :func:`search_pairing`, persists the result,
    and applies the winning pairing via ``pair_asymmetric(g2, pairing=...)``.
    The last decision is kept on ``self.plan`` for observability. Shapes
    default to :func:`repro_torch.plan.lower.synthesize_shapes` when the caller
    has none (the bare ``optimize(g, planner="perfsim")`` form). With a
    ``cache`` and a ``memo_key`` (a hashable description of the graph and
    every input of the key, built by the caller), a decision kept in the
    process is applied before the cache key is computed."""

    def __init__(self, value_shapes: Optional[Dict[str, tuple]] = None,
                 weight_shapes: Optional[Dict[str, tuple]] = None,
                 dtype_bytes: int = 4,
                 fabric: Optional[Fabric] = None,
                 backend: str = "cais",
                 num_microbatches: int = 1,
                 chunk_candidates: Sequence[Optional[int]] =
                 CHUNK_CANDIDATES,
                 branch: int = 3, max_states: int = 64,
                 cache: Optional[cache_mod.PlanCache] = None,
                 comp_hints: Optional[Dict[str, float]] = None,
                 memo_key: Optional[Hashable] = None):
        self.value_shapes = value_shapes
        self.weight_shapes = weight_shapes
        self.dtype_bytes = dtype_bytes
        self.fabric = fabric or Fabric()
        self.backend = backend
        self.num_microbatches = num_microbatches
        self.chunk_candidates = tuple(chunk_candidates)
        self.branch = branch
        self.max_states = max_states
        self.cache = cache
        self.comp_hints = dict(comp_hints) if comp_hints else None
        self.memo_key = memo_key
        self.plan: Optional[Plan] = None

    def _shapes(self, g2: df.Graph):
        vs, ws = lower_mod.synthesize_shapes(g2)
        return ({**vs, **(self.value_shapes or {})},
                {**ws, **(self.weight_shapes or {})})

    def pair(self, g2: df.Graph) -> df.Graph:
        memo = self.cache is not None and self.memo_key is not None
        if memo:
            plan = self.cache.memo_get(self.memo_key)
            if plan is not None:
                self.plan = plan
                return df.pair_asymmetric(g2, pairing=plan.pairing)
        value_shapes, weight_shapes = self._shapes(g2)
        key = None
        if self.cache is not None:
            key = cache_mod.plan_key(
                g2, value_shapes, weight_shapes, self.dtype_bytes,
                self.fabric, self.backend,
                extra={"chunks": [c for c in self.chunk_candidates if c],
                       "branch": self.branch,
                       "max_states": self.max_states,
                       "hints": sorted(
                           (k, float(v))
                           for k, v in (self.comp_hints or {}).items())})
            hit = self.cache.get(key)
            if hit is not None:
                plan = Plan.from_dict(hit)
                try:
                    out = df.pair_asymmetric(g2, pairing=plan.pairing)
                except df.GraphError:
                    pass        # stale plan (graph changed) → re-search
                else:
                    self.plan = plan
                    if memo:
                        self.cache.memo_put(self.memo_key, plan)
                    return out
        plan = search_pairing(
            g2, fabric=self.fabric, backend=self.backend,
            value_shapes=value_shapes, weight_shapes=weight_shapes,
            dtype_bytes=self.dtype_bytes,
            num_microbatches=self.num_microbatches,
            chunk_candidates=self.chunk_candidates,
            branch=self.branch, max_states=self.max_states,
            comp_hints=self.comp_hints)
        if self.cache is not None and key is not None:
            self.cache.put(key, plan.to_dict())
        if memo:
            self.cache.memo_put(self.memo_key, plan)
        self.plan = plan
        return df.pair_asymmetric(g2, pairing=plan.pairing)
