"""Per-rank bodies of ``tests/test_torch_auto.py``, run on every rank of a
gloo ring by ``repro_torch.launch.ranks.run_ranks``: the ``auto`` TP mode
(DTensor) on dense attention blocks. ``LM.loss`` and every grad after
``sync_grads`` on a flat ring, a 2D mesh and a data axis; ``block_forward``
in the replicated layout against ``cais``; the collectives DTensor issues;
one AdamW step against one device's; and the same step with DTensor's
collectives staged through the host (the path gloo takes on the card).
Imports torch, numpy and ``repro_torch`` only, so the rank processes never
import JAX; the test compares what they return against JAX on one
device."""
from __future__ import annotations

import sys

import numpy as np
import torch

LR = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().numpy().copy()


def _rt(mode, sp=True, remat=False):
    from repro_torch.runtime import SMOKE, Runtime, TPConfig

    return Runtime(compute_dtype="float32", loss_chunk=SMOKE.loss_chunk,
                   remat=remat, tp=TPConfig(mode=mode, sequence_parallel=sp))


def _model(cfg, params, rt, group):
    from repro_torch import bridge
    from repro_torch.models import LM

    lm = LM(cfg, rt, device="cpu", seed=None, group=group)
    bridge.load_jax_params(lm, params)
    lm.requires_grad_(True)
    return lm


def _comm(mode) -> dict:
    """CommDebugMode's counts by the collective's name."""
    return {str(k).split(".")[-1]: v
            for k, v in mode.get_comm_counts().items()}


def _loss_and_grads(lm, tokens):
    """(loss, {param: this rank's grad after sync_grads}, the collectives
    of the forward, those of the backward) of ``lm`` on ``tokens`` (this
    replica's rows)."""
    from torch.distributed.tensor.debug import CommDebugMode

    tok = _t(tokens)
    with CommDebugMode() as fwd:
        loss = lm.loss({"tokens": tok, "labels": tok})
    with CommDebugMode() as bwd:
        loss.backward()
    lm.sync_grads(tok.shape[1])
    return (float(loss.detach()),
            {k: _np(p.grad) for k, p in lm.named_parameters()},
            _comm(fwd), _comm(bwd))


def lm_cells(meshes, cases):
    """{(case, mode, sequence_parallel, remat, mesh): (loss, grads, forward
    collectives, backward collectives)} per case's runs; on a mesh with a
    data axis each replica takes its rows of the batch."""
    from repro_torch.data.pipeline import replica_rows

    out = {}
    for label, (cfg, params, tokens, runs) in cases.items():
        for mode, sp, remat, mesh in runs:
            m = meshes[mesh]
            lm = _model(cfg, params, _rt(mode, sp, remat), m)
            rows = tokens if lm.dp == 1 else replica_rows(
                {"t": tokens}, lm.data.rank, lm.dp)["t"]
            out[(label, mode, sp, remat, mesh)] = _loss_and_grads(lm, rows)
    return out


def block_cells(group, cfg, params, xs):
    """``block_forward`` of block 0 at each (B, S, d) x of ``xs`` (whole on
    every rank: the replicated layout, S = 1 and a ragged S) under
    ``auto`` and ``cais``: {(S, mode): out (B, S, d), whole}."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.core import tp as tp_mod
    from repro_torch.models.transformer import AutoTP, block_forward

    out = {}
    kind = cfg.layer_kinds()[0]
    blk = _model(cfg, params, _rt("auto"), group).blocks[0]
    for x in xs:
        S = x.shape[1]
        for mode in ("auto", "cais"):
            with torch.no_grad():
                if mode == "auto":
                    xd = DTensor.from_local(
                        _t(x), group.device_mesh("cpu"), [Replicate()],
                        run_check=False)
                    y = block_forward(kind, blk, xd, cfg, AutoTP(group),
                                      seq_sharded=False)[0].to_local()
                else:
                    y = block_forward(kind, blk, _t(x), cfg,
                                      tp_mod.TPContext(group, backend=mode),
                                      seq_sharded=False)[0]
            out[(S, mode)] = _np(y)
    return out


def adamw_cell(group, cfg, params, tokens):
    """One AdamW step (``make_train_step``, constant lr ``LR``) of the
    ``auto`` ring and of one device from the same parameters: [ring, one
    device], each (loss, grad norm, {param: (this rank's shard of the
    parameter after the step, of its gradient, of AdamW's m, of its v)})."""
    from repro_torch.core.tp import shard_param
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.train.step import init_state, make_train_step

    out = []
    for g in (group, None):
        rt = _rt("auto")
        lm = _model(cfg, params, rt, g)
        opt = adamw(constant_schedule(LR))
        state = init_state(lm, opt)
        state, metrics = make_train_step(lm, opt, rt)(state, {
            "tokens": tokens, "labels": tokens})
        mine = lambda t, k: _np(shard_param(t, k, cfg, group)  # noqa: E731
                                if g is None else t)
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]), {
            k: tuple(mine(t, k) for t in (p, p.grad, state["opt"]["m"][k],
                                          state["opt"]["v"][k]))
            for k, p in lm.named_parameters()}))
    return out


def auto_cells(group, data):
    """Every cell of one spawn: "lm" on the flat ring (and, at world 4, on
    tp_in 2 x tp_out 2 and on data 2 x model 2 of the same ranks),
    "blocks", "adamw", and last "staged": the flat ring's internlm2 step
    again with the functional collectives staged through the host
    (``repro_torch.sharding.stage_functional_collectives("CPU")``, which
    stays registered in this process)."""
    from repro_torch import sharding

    meshes = {"flat": group}
    if group.size == 4:
        meshes["2x2"] = sharding.init_mesh(group, tp_in=2, tp_out=2)
        meshes["dp2"] = sharding.init_mesh(group, dp=2)
    out = {"lm": lm_cells(meshes, data["lm"]),
           "blocks": block_cells(group, *data["blocks"]),
           "adamw": adamw_cell(group, *data["adamw"])}
    cfg, params, tokens, _ = data["lm"][data["staged"]]
    sharding.stage_functional_collectives("CPU")
    out["staged"] = _loss_and_grads(
        _model(cfg, params, _rt("auto"), group), tokens)
    out["_jax_imported"] = "jax" in sys.modules
    return out
