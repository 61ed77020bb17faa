"""Per-(graph signature, shapes, dtype, topology, backend) plan cache.

Counterpart of ``repro/plan/cache.py``: :func:`graph_signature` and
:func:`plan_key` serialize exactly as ``repro``'s do, so the same graph,
shapes, fabric and backend give the same key in both packages.

The search in :mod:`repro_torch.plan.search` costs many simulated lowerings
per graph, and the model path asks for the same (shape, topology) cell in
every period of every step, so plans persist as JSON, one file per key,
under ``$REPRO_TORCH_PLAN_CACHE`` (default ``reports/plans_torch``). Keys
are sha-256 over a canonical serialization: node structure
(names/ops/edges/weights), value/weight shapes, dtype bytes, fabric
parameters, backend and the candidate space, so any input that could change
the argmin changes the key. Hit/miss counts are on :attr:`PlanCache.stats`.

Two departures from ``repro``, both for the ranks of a ring, which plan in
their own processes (``repro`` plans once, under ``jit``):

- several processes share the directory, so an entry is written to a
  temporary file of its own and renamed over the key (``os.replace``): a
  reader sees a whole entry or none, never another rank's half-written JSON;
- :meth:`PlanCache.memo_get` / :meth:`PlanCache.memo_put` keep decisions in
  the process under a hashable static description of the period (its block
  kinds, shapes, dtype, backend and fabric) that the caller builds without
  walking the graph, so a period that is planned again in every step pays
  a dict lookup, not a JSON serialization and sha-256 of its graph.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Dict, Hashable, Optional

from repro_torch.core import dataflow as df

ENV_ROOT = "REPRO_TORCH_PLAN_CACHE"
DEFAULT_ROOT = "reports/plans_torch"


def graph_signature(g: df.Graph) -> str:
    """Canonical structural serialization of a graph (topo order; ``fn``
    closures excluded — the cost model never looks inside local math)."""
    nodes = df._topo(list(g.nodes), g.outputs)
    return json.dumps(
        [[n.name, n.op, list(n.inputs), list(n.weights), list(n.outputs)]
         for n in nodes] + [list(g.outputs)],
        separators=(",", ":"))


def plan_key(g: df.Graph, value_shapes: Dict[str, tuple],
             weight_shapes: Dict[str, tuple], dtype_bytes: int,
             fabric, backend: str, extra: Optional[dict] = None) -> str:
    """The cache key: sha-256 hex digest over everything the argmin depends
    on. ``extra`` carries search-space knobs (microbatch/chunk candidates)."""
    payload = {
        "graph": graph_signature(g),
        "values": sorted((k, list(v)) for k, v in value_shapes.items()),
        "weights": sorted((k, list(v)) for k, v in weight_shapes.items()),
        "dtype_bytes": int(dtype_bytes),
        "fabric": dataclasses.asdict(fabric),
        "backend": str(backend),
        "extra": extra or {},
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


class PlanCache:
    """JSON-persisted plan store with observable hit/miss counters.

    ``get`` returns the stored plan dict (or None); ``put`` persists one.
    The in-memory layer makes repeated hits within a process cheap; the disk
    layer makes them survive across processes. ``root`` defaults to
    ``$REPRO_TORCH_PLAN_CACHE``, read when the cache is made, else
    ``reports/plans_torch`` under the working directory."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.environ.get(ENV_ROOT, DEFAULT_ROOT)
        self.hits = 0
        self.misses = 0
        self.memo_hits = 0
        self._mem: Dict[str, dict] = {}
        self._memo: Dict[Hashable, object] = {}

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    def get(self, key: str) -> Optional[dict]:
        if key in self._mem:
            self.hits += 1
            return self._mem[key]
        path = self._path(key)
        if os.path.exists(path):
            try:
                with open(path) as fh:
                    plan = json.load(fh)
            except (OSError, json.JSONDecodeError):
                self.misses += 1
                return None
            self._mem[key] = plan
            self.hits += 1
            return plan
        self.misses += 1
        return None

    def put(self, key: str, plan: dict) -> None:
        self._mem[key] = plan
        os.makedirs(self.root, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=f".{key}.", suffix=".tmp",
                                   dir=self.root)
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(plan, fh, indent=1, sort_keys=True)
            os.replace(tmp, self._path(key))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def memo_get(self, static: Hashable):
        """The decision kept under ``static`` in this process, or None."""
        plan = self._memo.get(static)
        if plan is not None:
            self.memo_hits += 1
        return plan

    def memo_put(self, static: Hashable, plan) -> None:
        self._memo[static] = plan

    @property
    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses}


_DEFAULT: Optional[PlanCache] = None


def default_cache() -> PlanCache:
    """The process-wide cache the model path's planners use."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = PlanCache()
    return _DEFAULT
