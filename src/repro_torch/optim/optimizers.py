"""Optimizers as plain functions over dicts of tensors: AdamW, Adafactor,
the learning rate schedules and global-norm gradient clipping.

Counterpart of ``repro/optim/optimizers.py``, with its interface:

    opt = make_optimizer(name, lr_schedule, **kw)
    state = opt.init(params, leaves=None)
    params, state = opt.apply(params, grads, state, step)

``params`` and ``grads`` are dicts name -> tensor (a flat pytree). The
updates follow JAX's formulas as written: AdamW's clip inside ``apply``,
the bias corrections from ``step + 1``, weight decay on every leaf, ``m``
and ``v`` in f32; Adafactor's factored second moment, its RMS update clip
and ``beta = 1 - (step + 1) ** -decay``. ``torch.optim.AdamW`` rounds its
update differently, so it is not used. On a TP ring, ``apply`` and
:func:`global_norm` take a map from each leaf this rank holds a shard of to
the group that splits it: each logical element is counted once, so every
rank clips by the same norm. ``apply`` updates the given parameters and
state in place and returns them (JAX returns new arrays; in place, the
card holds one copy of the model and its state, as JAX's buffer donation
would): the same values.

Adafactor is defined per JAX leaf, and ``repro`` stacks a pattern period's
layers on one leaf (``bridge.unstack_layers``); the port keeps a tensor a
layer. ``leaves`` (:class:`Leaf`, from the model's ``opt_leaves()``) maps
each parameter to its JAX leaf and stack index, so the state of a group of
layers has JAX's stacked shapes and its statistics (a stacked vector's
``vc``, the RMS clip) run over the whole group. Without ``leaves`` every
parameter is a leaf of its own.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Tuple)

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


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """Σ x² in f32; past APPLY_CHUNK elements a chunk at a time (the f32
    square of an expert leaf would be a copy of it, twice its size)."""
    if x.numel() <= APPLY_CHUNK:
        return torch.sum(torch.square(x.float()))
    flat = x.reshape(-1)
    return torch.sum(torch.stack([
        torch.sum(torch.square(flat[lo:lo + APPLY_CHUNK].float()))
        for lo in range(0, flat.numel(), APPLY_CHUNK)]))


def global_norm(tree: Params,
                sharded: Optional[Mapping] = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32, leaves in key order
    (JAX's pytree order). ``sharded`` maps each leaf that holds this rank's
    shard to the group that splits it (the TP group, or on a 2D mesh tp_out
    for grouped experts, which tp_in replicates): each group's leaves have
    their squares summed over that group, and every other leaf, which the
    ranks hold whole, counts once. Replicas over a data axis hold the same
    grads and are never summed."""
    sq = {k: _sum_sq(x) for k, x in tree.items()}
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
    """``init(params, leaves=None)`` makes the state; ``apply(params, grads,
    state, step, *, sharded=None, leaves=None)`` updates both in place;
    ``placement(params, leaves, sharded)`` maps the path of each state
    tensor that this rank holds a shard of (a tuple of keys under the
    state) to (the dimension it splits, the group that splits it), as
    ``param_placement`` does a parameter's: what a checkpoint gathers and
    slices."""
    init: Callable[..., Any]
    apply: Callable[..., Tuple[Params, Any]]
    name: str = "opt"
    placement: Optional[Callable[..., Dict[tuple, tuple]]] = None


class Leaf(NamedTuple):
    """Where a parameter sits in ``repro``'s pytree: the JAX leaf ``name``
    it belongs to, its ``index`` on that leaf's stacked leading axis (None
    for a leaf of its own), and ``dim``, the dimension along which this
    rank holds a shard of it (None where it holds it whole)."""
    name: str
    index: Optional[int] = None
    dim: Optional[int] = None


def _leaf(leaves: Optional[Mapping], name: str) -> Leaf:
    return (leaves or {}).get(name) or Leaf(name)


def _split(leaves, sharded, name: str):
    """(this rank's shard dim, the group that splits it), or None."""
    dim, g = _leaf(leaves, name).dim, (sharded or {}).get(name)
    if dim is None or g is None or g.size <= 1:
        return None
    return dim, g


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0) -> Optimizer:
    def init(params: Params, leaves: Optional[Mapping] = None):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": {k: zeros(p) for k, p in params.items()},
                "v": {k: zeros(p) for k, p in params.items()}}

    def apply(params: Params, grads: Params, state, step, *,
              sharded: Optional[Mapping] = None,
              leaves: Optional[Mapping] = None):
        """One update of ``params`` and ``state`` in place; returns them as
        (params, state); elementwise, so ``leaves`` changes nothing.
        ``sharded`` (each leaf this rank holds a shard of,
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

    def placement(params, leaves, sharded):
        out = {}
        for name in sharded or {}:
            place = _split(leaves, sharded, name)
            if place is not None:
                out[("m", name)] = out[("v", name)] = place
        return out

    return Optimizer(init, apply, "adamw", placement)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum)
# ---------------------------------------------------------------------------


class _Group(NamedTuple):
    """One JAX leaf: its parameters in stack order, whether they are
    stacked, and (the shard's axis in the stacked leaf, the group that
    splits it) or None."""
    names: List[str]
    stacked: bool
    place: Optional[Tuple[int, Any]]


def _plan(params: Mapping, leaves: Optional[Mapping],
          sharded: Optional[Mapping]) -> Dict[str, _Group]:
    """{JAX leaf: its group} in key order (every rank walks the groups,
    and their collectives, in the same order)."""
    members: Dict[str, list] = {}
    for name in params:
        lf = _leaf(leaves, name)
        members.setdefault(lf.name, []).append((lf.index, name))
    out = {}
    for g in sorted(members):
        ms = members[g]
        stacked = ms[0][0] is not None
        if not stacked and len(ms) > 1 or \
                stacked and sorted(i for i, _ in ms) != list(range(len(ms))):
            raise ValueError(f"leaf {g!r}: stack indices "
                             f"{sorted(str(i) for i, _ in ms)}")
        names = [n for _, n in sorted(ms)] if stacked else [ms[0][1]]
        if len({tuple(params[n].shape) for n in names}) != 1:
            raise ValueError(f"leaf {g!r}: its layers differ in shape")
        place = _split(leaves, sharded, names[0])
        if place is not None:
            place = (place[0] + stacked, place[1])
        out[g] = _Group(names, stacked, place)
    return out


def _slabs(t: torch.Tensor, chunk: int):
    """Index slabs of ``t`` along its leading axis, about ``chunk``
    elements each (the whole of a scalar)."""
    if t.dim() == 0:
        yield ...
        return
    step = max(1, chunk // max(1, t[0].numel()))
    for lo in range(0, t.shape[0], step):
        yield slice(lo, lo + step)


def adafactor(lr: Schedule, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0,
              slab: int = APPLY_CHUNK) -> Optimizer:
    """JAX's Adafactor over JAX's leaves (:class:`Leaf`). A leaf whose
    stacked form has two or more axes keeps ``vr`` (the mean of g² + eps
    over its last axis) and ``vc`` (over the one before), others ``v``;
    u = g·rsqrt(vr / max(mean(vr, -1), eps))·rsqrt(vc) (or g·rsqrt(v)),
    divided by max(1, RMS(u) / clip_threshold) with the RMS over the whole
    leaf, then weight decay, then p - lr·u in f32, rounded to the
    parameter's dtype.

    Streaming: each parameter is read in slabs of about ``slab`` elements
    along its leading axis (an expert leaf an expert or a few at a time),
    so the f32 temporaries are a few slabs, not copies of the leaf. Where
    a slab holds whole rows of both statistics (three or more axes, none
    of the two last split over a ring) pass 1 updates the state and sums
    u² slab by slab, and pass 2 recomputes u and updates the parameter;
    otherwise the statistics take a pass of their own first. The values
    are the unstreamed formula's, up to the order of the sums.

    On a ring (``sharded``, and the shard dims in ``leaves``) each sum that
    crosses a parameter's split dimension is all-reduced over the group
    that splits it: the last axis's mean for a column-split weight, the
    one before (``vc``, and rfac's mean over ``vr``) for a row-split one,
    and Σu² for every split leaf, experts included. Every rank's shard then
    gets the update one device gives the whole leaf."""

    def init(params: Params, leaves: Optional[Mapping] = None):
        state = {}
        for g, grp in _plan(params, leaves, None).items():
            p = params[grp.names[0]]
            full = ((len(grp.names),) if grp.stacked else ()) + \
                tuple(p.shape)
            zeros = lambda s: torch.zeros(s, dtype=torch.float32,  # noqa
                                          device=p.device)
            state[g] = ({"vr": zeros(full[:-1]),
                         "vc": zeros(full[:-2] + full[-1:])}
                        if len(full) >= 2 else {"v": zeros(full)})
        return state

    def apply(params: Params, grads: Params, state, step, *,
              sharded: Optional[Mapping] = None,
              leaves: Optional[Mapping] = None):
        """One update of ``params`` and ``state`` in place; returns them as
        (params, state)."""
        t = _f32(step) + 1
        beta = 1.0 - t ** (-decay)
        lr_t = lr(step)
        with torch.no_grad():
            for g, grp in _plan(params, leaves, sharded).items():
                _update(grp, params, grads, state[g], beta, lr_t)
        return params, state

    def _update(grp: _Group, params, grads, st, beta, lr_t) -> None:
        names, stacked = grp.names, grp.stacked
        D, ring = grp.place if grp.place is not None else (None, None)
        p0 = params[names[0]]
        k = p0.dim()
        K = k + stacked
        local = ((len(names),) if stacked else ()) + tuple(p0.shape)
        n_ring = ring.size if ring is not None else 1

        def whole(axis):          # the stacked leaf's axis over the ring
            return local[axis] * (n_ring if axis == D else 1)

        def summed(x, axis):      # a sum over ``axis`` of the stacked leaf
            return ring.all_reduce(x) if axis == D else x

        at = (lambda x, i: x[i]) if stacked else (lambda x, i: x)
        g32 = lambda i, sl: grads[names[i]][sl].float()     # noqa: E731
        sq = lambda x: x * x + eps                          # noqa: E731

        if K < 2:                                  # v: elementwise
            merged, rmeans = True, None

            def stats(i, sl):
                v = at(st["v"], i)
                v[sl] = beta * v[sl] + (1 - beta) * sq(g32(i, sl))

            def u_of(i, sl):
                return g32(i, sl) * torch.rsqrt(at(st["v"], i)[sl])
        elif k == 1:                               # a stack of vectors
            merged = False
            vr, vc = st["vr"], st["vc"]
            rsum = torch.zeros_like(vr)
            csum = torch.zeros_like(vc)
            for i in range(len(names)):
                g2 = sq(g32(i, ...))
                rsum[i] = g2.sum()
                csum += g2
            vr.copy_(beta * vr + (1 - beta) * (summed(rsum, K - 1)
                                               / whole(K - 1)))
            vc.copy_(beta * vc + (1 - beta) * (csum / whole(K - 2)))
            rfac = torch.rsqrt(vr / torch.clamp(vr.sum() / whole(K - 2),
                                                min=eps))
            cfac = torch.rsqrt(vc)

            def u_of(i, sl):
                return g32(i, sl) * rfac[i] * cfac[sl]
        else:                                      # per-layer factors
            merged = k >= 3 and D not in (K - 1, K - 2)
            rmeans = []

            def stats(i, sl):
                vr, vc = at(st["vr"], i), at(st["vc"], i)
                g2 = sq(g32(i, sl))
                vr[sl] = beta * vr[sl] + (1 - beta) * (g2.sum(-1)
                                                       / whole(K - 1))
                vc[sl] = beta * vc[sl] + (1 - beta) * (g2.sum(-2)
                                                       / whole(K - 2))

            def u_of(i, sl):
                vr, vc = at(st["vr"], i)[sl], at(st["vc"], i)
                vc = vc[sl] if k >= 3 else vc
                rmean = (vr.sum(-1, keepdim=True) / whole(K - 2) if merged
                         else rmeans[i][sl] if k >= 3 else rmeans[i])
                rfac = torch.rsqrt(vr / torch.clamp(rmean, min=eps))
                return g32(i, sl) * rfac[..., None] * \
                    torch.rsqrt(vc)[..., None, :]

            if not merged:
                for i in range(len(names)):
                    vr, vc = at(st["vr"], i), at(st["vc"], i)
                    rsum = torch.empty_like(vr)
                    csum = torch.zeros_like(vc)
                    for sl in _slabs(p0, slab):
                        g2 = sq(g32(i, sl))
                        rsum[sl] = g2.sum(-1)
                        if k == 2:
                            csum += g2.sum(-2)
                        else:
                            csum[sl] = g2.sum(-2)
                    vr.copy_(beta * vr + (1 - beta) * (summed(rsum, K - 1)
                                                       / whole(K - 1)))
                    vc.copy_(beta * vc + (1 - beta) * (summed(csum, K - 2)
                                                       / whole(K - 2)))
                    rmeans.append(summed(vr.sum(-1, keepdim=True), K - 2)
                                  / whole(K - 2))

        # pass 1 (with the statistics where they are slab-local): Σu²
        ssq = torch.zeros((), dtype=torch.float32, device=p0.device)
        for i in range(len(names)):
            for sl in _slabs(p0, slab):
                if merged:
                    stats(i, sl)
                u = u_of(i, sl)
                ssq += torch.sum(u * u)
        if ring is not None:
            ssq = ring.all_reduce(ssq)
        count = len(names) * p0.numel() * n_ring
        rms = torch.sqrt(ssq / count + 1e-30)
        denom = torch.clamp(rms / clip_threshold, min=1.0)
        # pass 2: u again, clipped, decayed, applied
        for i, name in enumerate(names):
            p = params[name]
            for sl in _slabs(p, slab):
                u = u_of(i, sl) / denom
                if weight_decay:
                    u = u + weight_decay * p[sl].float()
                p[sl] = (p[sl].float() - lr_t * u).to(p.dtype)

    def placement(params, leaves, sharded):
        out = {}
        for g, grp in _plan(params, leaves, sharded).items():
            if grp.place is None:
                continue
            D, ring = grp.place
            K = params[grp.names[0]].dim() + grp.stacked
            if K < 2:
                out[(g, "v")] = (D, ring)
                continue
            if D < K - 1:
                out[(g, "vr")] = (D, ring)
            if D != K - 2:
                out[(g, "vc")] = (min(D, K - 2), ring)
        return out

    return Optimizer(init, apply, "adafactor", placement)


def make_optimizer(name: str, lr: Schedule, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(name)
