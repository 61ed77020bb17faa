"""Optimizers as plain functions over dicts of tensors: AdamW, the learning
rate schedules and global-norm gradient clipping.

Counterpart of ``repro/optim/optimizers.py``, with its interface:

    opt = make_optimizer(name, lr_schedule, **kw)
    state = opt.init(params)
    params, state = opt.apply(params, grads, state, step)

``params`` and ``grads`` are dicts name -> tensor (a flat pytree). The
update follows JAX's formula as written: the clip inside ``apply``, the
bias corrections from ``step + 1``, weight decay on every leaf, ``m`` and
``v`` in f32. ``torch.optim.AdamW`` rounds its update differently, so it is
not used. On a TP ring, ``apply`` and :func:`global_norm` take a map from
each leaf this rank holds a shard of to the group that splits it: each
logical element is counted once, so every rank clips by the same norm.
``apply`` updates the given
parameters and state in place and returns them (JAX returns new arrays;
in place, the card holds one copy of the model and its state, as JAX's
buffer donation would): the same values. Adafactor (only the largest MoE
arch uses it) is not ported yet (ROADMAP A15).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[Any], torch.Tensor]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1) -> Schedule:
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return fn


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Gradient clipping
# ---------------------------------------------------------------------------


def global_norm(tree: Params,
                sharded: Optional[Mapping] = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32, leaves in key order
    (JAX's pytree order). ``sharded`` maps each leaf that holds this rank's
    shard to the group that splits it (the TP group, or on a 2D mesh tp_out
    for grouped experts, which tp_in replicates): each group's leaves have
    their squares summed over that group, and every other leaf, which the
    ranks hold whole, counts once. Replicas over a data axis hold the same
    grads and are never summed."""
    sq = {k: torch.sum(torch.square(x.float())) for k, x in tree.items()}
    keys = sorted(sq)
    split = {k: g for k, g in (sharded or {}).items()
             if k in sq and g is not None and g.size > 1}
    if not split:
        return torch.sqrt(torch.sum(torch.stack([sq[k] for k in keys])))
    groups = []
    for k in keys:
        if k in split and all(split[k] is not g for g in groups):
            groups.append(split[k])
    rep = [sq[k] for k in keys if k not in split]
    total = None
    for g in groups:
        part = g.all_reduce(torch.sum(torch.stack(
            [sq[k] for k in keys if split.get(k) is g])))
        total = part if total is None else total + part
    if rep:
        total = total + torch.sum(torch.stack(rep))
    return torch.sqrt(total)


def clip_by_global_norm(grads: Params, max_norm: float,
                        sharded: Optional[Mapping] = None
                        ) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads, sharded)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, \
        norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

# elements of a leaf AdamW updates at a time (64 MB of f32 temporaries): a
# grouped-EP rank's expert leaf is 235 M elements
APPLY_CHUNK = 1 << 24


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    apply: Callable[..., Tuple[Params, Any]]
    name: str = "opt"


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0) -> Optimizer:
    def init(params: Params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": {k: zeros(p) for k, p in params.items()},
                "v": {k: zeros(p) for k, p in params.items()}}

    def apply(params: Params, grads: Params, state, step, *,
              sharded: Optional[Mapping] = None):
        """One update of ``params`` and ``state`` in place; returns them as
        (params, state). ``sharded`` (each leaf this rank holds a shard of,
        to the group that splits it) makes the clip's norm the ring's
        (:func:`global_norm`). The clip is applied leaf by leaf, as
        :func:`clip_by_global_norm` computes it."""
        norm = global_norm(grads, sharded)
        scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-9), max=1.0)
        t = _f32(step) + 1
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        lr_t = lr(step)
        new_p, new_m, new_v = {}, {}, {}
        with torch.no_grad():
            for k, p in params.items():
                m, v = state["m"][k], state["v"][k]
                flat = [t.view(-1) for t in (p, m, v)]
                gk = grads[k].reshape(-1)
                # elementwise, so a chunk at a time gives the same values;
                # the temporaries stay a chunk's, not a leaf's
                for lo in range(0, p.numel(), APPLY_CHUNK):
                    pc, mc, vc = (t[lo:lo + APPLY_CHUNK] for t in flat)
                    g = (gk[lo:lo + APPLY_CHUNK].float() * scale).to(
                        gk.dtype).float()
                    mc.mul_(b1).add_((1 - b1) * g)
                    vc.mul_(b2).add_((1 - b2) * g * g)
                    u = (mc / c1) / (torch.sqrt(vc / c2) + eps)
                    u = u + weight_decay * pc.float()
                    pc.copy_((pc.float() - lr_t * u).to(pc.dtype))
                new_p[k], new_m[k], new_v[k] = p, m, v
        return new_p, {"m": new_m, "v": new_v}

    return Optimizer(init, apply, "adamw")


def make_optimizer(name: str, lr: Schedule, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        raise NotImplementedError("adafactor is not ported yet (ROADMAP "
                                  "A15); the ported archs train with adamw")
    raise ValueError(name)
