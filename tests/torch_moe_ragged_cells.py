"""Per-rank bodies of ``tests/test_torch_moe_ragged.py``: MoE training at a
sequence that does not split over the ring (the replicated activation
layout) on a gloo ring, run on every rank by
``repro_torch.launch.ranks.run_ranks``. This module imports torch,
``repro_torch`` and ``chip_smoke`` (for its routing probe) only, so the rank
processes never import JAX; the test compares what the ranks return against
JAX on one device."""
from __future__ import annotations

import sys

import chip_smoke as CS
import torch_rank_cells as cells
import torch_sublayer_cells as sub_cells
from repro_torch.core import tp as tp_mod


def _placed(lm, name):
    """(dim, shard index, shards) of parameter ``name`` on this rank, or
    None where the rank holds it whole."""
    place = tp_mod.param_placement(name, lm.cfg, lm.group)
    return None if place is None else (place[0], place[1].rank,
                                        place[1].size)


def ragged_cells(group, cases, runs, plan_root):
    """Every run on this rank: {run: dict}, ``run`` (case, mode, planner,
    the mesh's ``init_mesh`` keywords as (name, value) pairs or None) over
    ``cases`` {case: (port cfg, numpy params, tokens)}. Per run, from the bridged JAX parameters: the aux loss of
    ``LM.forward`` and its router grads alone (after ``sync_grads``); then
    ``LM.loss``, its backward and ``sync_grads``: the loss, every grad
    with this rank's placement of it, the routing of the loss's forward
    (:func:`chip_smoke.routing_probe`, one record a layer), the matmul and
    flash calls made against ``tp.step_launches`` of what the forward
    recorded, the activation layout, and the plan-cache lookups (hits,
    misses, memo hits) the run made. A replica of a data axis takes its rows
    of the batch. A run whose forward refuses its shape
    (``NotImplementedError``) gives {"raised": its message}."""
    import torch

    from repro_torch import bridge
    from repro_torch.data.pipeline import replica_rows
    from repro_torch.models import LM
    from repro_torch.models.transformer import activation_layout
    from repro_torch.runtime import SMOKE, Runtime, TPConfig
    from repro_torch.sharding import init_mesh

    count = sub_cells._counters()
    routes, _ = CS.routing_probe()
    cache = cells._plan_cache(plan_root)
    meshes = {}
    out = {}
    for run in runs:
        case, mode, planner, mesh = run
        cfg, params, tokens = cases[case]
        key = mesh or ()
        if key not in meshes:       # every rank makes them in one order
            meshes[key] = group if not key else init_mesh(group,
                                                          **dict(mesh))
        rt = Runtime(compute_dtype="float32", loss_chunk=SMOKE.loss_chunk,
                     remat=False,
                     tp=TPConfig(mode=mode, chunks=2, planner=planner))
        lm = LM(cfg, rt, device="cpu", seed=None, group=meshes[key])
        bridge.load_jax_params(lm, params)
        lm.requires_grad_(True)
        tok = cells._t(tokens)
        batch = {"tokens": tok, "labels": tok}
        if lm.dp > 1:
            batch = replica_rows(batch, lm.data.rank, lm.dp)
        B, S = batch["tokens"].shape
        looked = (cache.hits, cache.misses, cache.memo_hits)

        try:
            _, aux = lm.forward(batch["tokens"])
        except NotImplementedError as e:    # a refused shape, by name
            out[run] = dict(raised=str(e))
            continue
        if lm.dp > 1:
            aux = tp_mod.ring_mean(aux, lm.data)
        aux.backward()
        lm.sync_grads(S)
        aux_router = {k: p.grad.numpy().copy()
                      for k, p in lm.named_parameters()
                      if k.endswith("ffn.router")}
        for p in lm.parameters():
            p.grad = None

        for k in count:
            count[k] = 0
        routes.clear()
        with tp_mod.recording() as rec:
            loss = lm.loss(batch)
        routing = list(routes[:cfg.num_layers])
        loss.backward()
        lm.sync_grads(S)
        made = dict(count)
        derived = tp_mod.step_launches(rec, B, S, cfg.d_model, 4)
        out[run] = dict(
            loss=float(loss.detach()), aux=float(aux.detach()),
            aux_router=aux_router,
            grads={k: (p.grad.numpy(), _placed(lm, k))
                   for k, p in lm.named_parameters()},
            routing=routing, made=made,
            derived={k: derived[k] for k in ("matmul", "flash")},
            layout=activation_layout(rt, S, lm.tp),
            looked=(cache.hits - looked[0], cache.misses - looked[1],
                    cache.memo_hits - looked[2]))
    out["_jax_imported"] = "jax" in sys.modules
    return out
