"""Per-rank bodies of ``tests/test_torch_moe_serve_tp.py``: MoE serving on a
gloo ring (``LM.serve_step`` and the paged ``Engine``), run on every rank by
``repro_torch.launch.ranks.run_ranks``. This module imports torch,
``repro_torch`` and ``chip_smoke`` (for its routing probe) only, so the rank
processes never import JAX; the test compares what the ranks return against
JAX on one device."""
from __future__ import annotations

import sys

import chip_smoke as CS
import torch_rank_cells as cells
from repro_torch.core import tp as tp_mod
from repro_torch.kernels import ops


def _count_all_reduce():
    """Count every TP group's all-reduces (the MoE's ``allreduce`` nodes and
    ``gemm_ar``'s monolithic fallback); returns the counter."""
    from repro_torch.sharding import TPGroup

    count = [0]
    inner = TPGroup.all_reduce

    def counted(self, x):
        count[0] += 1
        return inner(self, x)

    TPGroup.all_reduce = counted
    return count


def _model(group, cfg, params, mode, planner="greedy", mesh=None):
    from repro_torch import bridge
    from repro_torch.models import LM
    from repro_torch.runtime import Runtime, TPConfig
    from repro_torch.sharding import init_mesh

    rt = Runtime(compute_dtype="float32",
                 tp=TPConfig(mode=mode, chunks=2, planner=planner))
    on = group if mesh is None else init_mesh(group, **mesh)
    lm = LM(cfg, rt, device="cpu", seed=None, group=on)
    bridge.load_jax_params(lm, params)
    return lm


def serve_cells(group, cases, schedule, engine, plan_root):
    """Every MoE serving case on this rank.

    ``cases``: {name: (arch, overrides (a ``moe`` entry: MoEConfig fields),
    numpy params, runs)}, each run (mode, planner, mesh kwargs or None):
    ``LM.serve_step`` over ``schedule`` (a list of (tokens, (bt, pos, ctx,
    last))): per run (logits per step, final pools, routing records,
    counts per step: (gemm_ar dispatches, this group's all-reduces, matmul
    calls made, flash calls made, :func:`repro_torch.core.tp.serve_launches`
    of the step), plan-cache (hits, misses, memo hits), the experts the rank
    computes by :func:`repro_torch.core.tp.serve_experts`). A perfsim run
    plans through a cache under ``plan_root``.
    ``engine``: (case name, prompts, max_new, serve config kwargs): the
    ring ``Engine``'s greedy tokens and every step's logits (cais, flat)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.serve import Engine, Request, ServeConfig

    ar = cells._count_gemm_ar()
    mm = cells._count_matmuls()
    flash = [0]
    inner_fa = ops.flash_attention

    def fa_counted(*a, **kw):
        flash[0] += 1
        return inner_fa(*a, **kw)

    ops.flash_attention = fa_counted
    red = _count_all_reduce()
    routes, _ = CS.routing_probe()
    cache = cells._plan_cache(plan_root)

    def config(arch, over):
        over = dict(over)
        cfg = get_arch(arch).smoke()
        if "moe" in over:
            over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
        return cfg.scaled(**over)

    out = {}
    for name, (arch, over, params, runs) in cases.items():
        cfg = config(arch, over)
        for mode, planner, mesh in runs:
            lm = _model(group, cfg, params, mode, planner, mesh)
            pools = lm.init_pools(8, 4)
            logits, counts = [], []
            routes.clear()
            stats = (cache.hits, cache.misses, cache.memo_hits)
            for toks, view in schedule:
                ar[0] = mm[0] = flash[0] = red[0] = 0
                with tp_mod.recording() as rec:
                    lg, pools = lm.serve_step(cells._t(toks), pools,
                                              cells._view(view))
                logits.append(lg.numpy())
                counts.append((ar[0], red[0], mm[0], flash[0],
                               tp_mod.serve_launches(rec)))
            looked = (cache.hits - stats[0], cache.misses - stats[1],
                      cache.memo_hits - stats[2])
            tpc = tp_mod.TPContext.from_config(lm.rt.tp, lm.group)
            out[(name, mode, planner, bool(mesh))] = (
                logits, [{k: v.numpy() for k, v in p.items()}
                         for p in pools], list(routes), counts, looked,
                tp_mod.serve_experts(cfg, tpc))

    name, prompts, max_new, sc_kw = engine
    arch, over, params, _ = cases[name]
    cfg = config(arch, over)
    lm = _model(group, cfg, params, "cais")
    seen = []
    step = lm.serve_step

    def recorded(*a):
        lg, pools = step(*a)
        seen.append(lg.numpy())
        return lg, pools

    lm.serve_step = recorded
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    Engine(lm, cfg, lm.rt, ServeConfig(**sc_kw), device="cpu").run(
        reqs, seed=0)
    out["engine"] = ([r.out_tokens for r in reqs], seen)
    out["_jax_imported"] = "jax" in sys.modules
    return out
