"""Train-step and serve-step factories: the units the launcher, the trainer
and ``chip_smoke.py`` share.

Counterpart of ``repro/train/step.py``. ``make_train_step(model, opt, rt)``
returns ``(state, batch) -> (state, metrics)`` with gradient accumulation
over ``microbatches`` (loss and grads averaged); every array of the batch
(a VLM's ``patch_embed``, an enc-dec's ``src_embed`` beside the tokens)
goes to the model's device and into the microbatches. The state is {"params",
"opt", "step"}; "params" are the model's own parameters, which the step
updates in place, as AdamW does the optimizer state it is given (no second
copy of the model and its state).

Gradients come from ``loss.backward()``; on a TP ring every period's
backward is graph-built (``repro_torch.core.tp.sp_period``), and
:meth:`repro_torch.models.transformer.LM.sync_grads` sums the replicated
embedding's, head's and final norm's grads over the ring once the
microbatches are done, and on a mesh with a data axis every grad over the
replicas (each replica's batch is its rows of the global batch:
:func:`repro_torch.data.pipeline.replica_rows`); then the global norm, the
clip and the optimizer (AdamW, or Adafactor over ``repro``'s leaves:
``model.opt_leaves()``), the same on every rank. After a step each
parameter's ``.grad`` holds the step's averaged (unclipped) gradient.
:func:`state_placement` says which tensors of the state a rank holds a
shard of, for the checkpoint (:mod:`repro_torch.checkpoint`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.optim.optimizers import Optimizer, global_norm
from repro_torch.runtime import Runtime

State = Dict[str, Any]


def init_state(model, opt: Optimizer) -> State:
    """The train state of ``model``: its parameters (made trainable), the
    optimizer's state for them, and step 0."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return {"params": params,
            "opt": opt.init(params, leaves=model.opt_leaves()), "step": 0}


def state_placement(model, opt: Optimizer) -> Dict[str, Tuple[int, Any]]:
    """{flat state key (``params::<name>``, ``opt::...``: the checkpoint's
    keys): (the dimension it splits, the group that splits it)} for every
    tensor of the train state this rank holds a shard of: the parameters
    by :func:`repro_torch.core.tp.param_placement`, the optimizer's state
    by ``opt.placement``."""
    from repro_torch.checkpoint.store import SEP

    params = dict(model.named_parameters())
    sharded = model.split_groups()
    leaves = model.opt_leaves()
    out = {f"params{SEP}{n}": (leaves[n].dim, g) for n, g in sharded.items()
           if leaves[n].dim is not None and g.size > 1}
    for path, place in opt.placement(params, leaves, sharded).items():
        out[SEP.join(("opt",) + path)] = place
    return out


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model, opt: Optimizer, rt: Runtime,
                    microbatches: int = 1):
    """Build the train step (gradient accumulation over ``microbatches``
    equal slices of the batch's leading axis)."""
    sharded = model.split_groups()
    leaves = model.opt_leaves()

    def train_step(state: State, batch) -> Tuple[State, Dict[str, Any]]:
        params = state["params"]
        for p in params.values():
            p.grad = None
        batch = _to_device(batch, model.device)
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} "
                             "microbatches")
        loss = torch.zeros((), dtype=torch.float32)
        for i in range(microbatches):
            micro = {k: torch.chunk(v, microbatches, dim=0)[i]
                     for k, v in batch.items()}
            lv = model.loss(micro)
            lv.backward()
            loss = loss + lv.detach().float().cpu()
        # the sequence the stack saw: a VLM's image prefix and its text
        model.sync_grads(batch["tokens"].shape[1]
                         + model.cfg.num_prefix_tokens)
        grads = {}
        for k, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[k] = g / microbatches if microbatches > 1 else g
        loss = loss / microbatches
        gnorm = global_norm(grads, sharded)
        _, new_opt = opt.apply(params, grads, state["opt"], state["step"],
                               sharded=sharded, leaves=leaves)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": state["step"]}
        for k, p in params.items():
            p.grad = grads[k]
        return {"params": params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return train_step


def make_prefill_step(model, rt: Runtime, s_max: Optional[int] = None):
    def prefill_step(batch):
        return model.prefill(batch, s_max=s_max)
    return prefill_step


def make_decode_step(model, rt: Runtime):
    def decode_step(token, caches, idx):
        return model.decode_step(token, caches, idx)
    return decode_step
