"""``repro_torch.plan`` — the perfsim-in-the-loop schedule planner (paper
§III-C's "compute-aware" leg), counterpart of ``repro.plan``: lowering
bridge (:mod:`repro_torch.plan.lower`), schedule search
(:mod:`repro_torch.plan.search`), measurement calibration
(:mod:`repro_torch.plan.calibrate`) and the per-(shape, topology) plan cache
(:mod:`repro_torch.plan.cache`). ``python -m repro_torch.plan --selfcheck``
round-trips lower → search → cache on the canonical sublayer graphs with no
devices.
"""
from repro_torch.plan.cache import (PlanCache, default_cache,
                                    graph_signature, plan_key)
from repro_torch.plan.calibrate import (RATIO_TOLERANCE, CalibrationResult,
                                        calibrate)
from repro_torch.plan.lower import (Lowering, fabric_from_hw, lower_graph,
                                    policy_for_backend, simulate,
                                    synthesize_shapes)
from repro_torch.plan.search import (CHUNK_CANDIDATES, FixedPairing,
                                     PerfsimPlanner, Plan,
                                     enumerate_pairings,
                                     microbatch_comp_hints,
                                     microbatch_value_shapes, period_planner,
                                     search_pairing, search_period)

__all__ = [
    "CHUNK_CANDIDATES", "CalibrationResult", "FixedPairing", "Lowering",
    "PerfsimPlanner", "Plan", "PlanCache", "RATIO_TOLERANCE", "calibrate",
    "default_cache", "enumerate_pairings", "fabric_from_hw",
    "graph_signature", "lower_graph", "microbatch_comp_hints",
    "microbatch_value_shapes", "period_planner", "plan_key",
    "policy_for_backend", "search_pairing", "search_period", "simulate",
    "synthesize_shapes",
]
