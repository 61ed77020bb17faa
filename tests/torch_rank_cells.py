"""Per-rank bodies of the port's multi-rank CPU tests (``tests/test_torch_core.py``,
``tests/test_torch_tp.py``, ``tests/test_torch_train.py``), run on every rank of a gloo ring by
``repro_torch.launch.ranks.run_ranks``. This module imports torch, numpy and
``repro_torch`` only, so the rank processes never import JAX; the tests
compare what the ranks return against JAX and against unsharded math."""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from repro_torch.core import backends, dataflow, primitives as prim
from repro_torch.core import tp as tp_mod
from repro_torch.kernels import ops

RING_CHUNKS = [(c, b) for c in (1, 2, 4) for b in (False, True)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(a, r, n, dim):
    """Rank r's contiguous slice of a numpy array along ``dim``."""
    s = a.shape[dim] // n
    return _t(np.take(a, range(r * s, (r + 1) * s), axis=dim))


def primitive_cells(group, data):
    """Every ring schedule on this rank's shards; returns {cell: local
    output}. ``data``: x (B,S,d), w (d,F), x2 (B,S,d), w2 (d,F), xo
    (B, 3n, d) for odd S_loc, scale (F,), wu (F,d)."""
    n, r = group.size, group.rank
    x, w, x2, w2, xo = (data[k] for k in ("x", "w", "x2", "w2", "xo"))
    seq = lambda a: _rows(a, r, n, 1)        # sequence shard (B, S/n, ...)
    col = lambda a: _rows(a, r, n, a.ndim - 1)
    row = lambda a: _rows(a, r, n, 0)
    out = {}
    for c, b in RING_CHUNKS:
        cais = prim.CAISConfig(num_chunks=c, bidirectional=b)
        out[f"ag_gemm.c{c}.b{int(b)}"] = prim.ag_gemm(seq(x), col(w), group,
                                                      cais)
        out[f"gemm_rs.c{c}.b{int(b)}"] = prim.gemm_rs(col(x), row(w), group,
                                                      cais)
    cais = prim.CAISConfig(num_chunks=2)
    out["ag_gemm_multi"] = torch.cat(prim.ag_gemm_multi(
        seq(x), (col(w), col(w2)), group, cais), dim=2)
    out["gemm_ar"] = prim.gemm_ar(col(x), row(w), group, cais)
    rs, ag = prim.overlap_asymmetric((col(x), row(w)), (seq(x2), col(w2)),
                                     group, cais)
    out["overlap_asym.rs"], out["overlap_asym.ag"] = rs, ag
    rs, ags = prim.overlap_asymmetric((col(x), row(w)),
                                      (seq(x2), (col(w2), col(w))), group,
                                      cais)
    out["overlap_asym.multi"] = torch.cat(ags, dim=2)
    out["ring_all_gather"] = prim.ring_all_gather(seq(x), group, cais)
    out["ring_reduce_scatter"] = prim.ring_reduce_scatter(_t(x), group, cais)
    out["barrier_ag_gemm"] = prim.barrier_ag_gemm(seq(x), col(w), group)
    out["barrier_gemm_rs"] = prim.barrier_gemm_rs(col(x), row(w), group)
    out["barrier_gemm_ar"] = prim.barrier_gemm_ar(col(x), row(w), group)
    # odd S_loc (3 rows a rank): the bidirectional ring falls back to one
    for b in (False, True):
        cais = prim.CAISConfig(num_chunks=2, bidirectional=b)
        out[f"odd.gemm_rs.b{int(b)}"] = prim.gemm_rs(col(xo), row(w), group,
                                                     cais)
        out[f"odd.ag_gemm.b{int(b)}"] = prim.ag_gemm(seq(xo), col(w), group,
                                                     cais)
        out[f"odd.ring_reduce_scatter.b{int(b)}"] = prim.ring_reduce_scatter(
            _t(xo), group, cais)
        out[f"odd.ring_all_gather.b{int(b)}"] = prim.ring_all_gather(
            seq(xo), group, cais)
    # the fused seam and the sub-layer graph through each backend
    for name in ("barrier", "cais"):
        be = backends.get_backend(name)
        cais = prim.CAISConfig(num_chunks=2)
        o, z = be.fused_rs_ln_ag(col(x), row(w), _t(data["scale"]),
                                 col(data["wu"]), group, cais)
        out[f"fused_rs_ln_ag.{name}"], out[f"fused_rs_ln_ag.{name}.z"] = o, z
        g = dataflow.optimize(dataflow.sublayer_graph())
        out[f"dataflow.sublayer.{name}"] = dataflow.execute(
            g, {"x": col(x)}, {"w1": row(w), "scale": _t(data["scale"]),
                               "w2": col(data["wu"])},
            group=group, cais=cais, backend=name)[0]
        g = dataflow.optimize(dataflow.dual_sublayer_graph())
        ra, gb = dataflow.execute(
            g, {"xa": col(x), "xb": seq(x2)}, {"wa": row(w), "wb": col(w2)},
            group=group, cais=cais, backend=name)
        out[f"dataflow.dual.{name}.rs"], out[f"dataflow.dual.{name}.ag"] = \
            ra, gb
    out = {k: v.numpy() for k, v in out.items()}
    out["_jax_imported"] = np.array("jax" in sys.modules)
    return out


def _count_matmuls():
    """Wrap ``ops.matmul`` (the call every ring GEMM makes) with a counter;
    returns the counter list."""
    count = [0]
    inner = ops.matmul

    def counted(a, b, **kw):
        count[0] += 1
        return inner(a, b, **kw)

    ops.matmul = counted
    return count


def _plan_cache(root):
    """Point the process-wide plan cache at ``root`` (the ranks of a spawn
    share it, as they share ``reports/plans_torch`` on the card)."""
    from repro_torch import plan

    plan.cache._DEFAULT = plan.PlanCache(root=root)
    return plan.cache._DEFAULT


def _plans_on_disk(root):
    """{cache key: plan} of every entry under ``root``."""
    out = {}
    for f in sorted(os.listdir(root)):
        if f.endswith(".json"):
            with open(os.path.join(root, f)) as fh:
                out[f[:-5]] = json.load(fh)
    return out


PLANNER_KINDS = ("attn", "attn")


def planner_cells(group, arch, trees, x, root):
    """multidev_checks' ``planner.perfsim_vs_greedy.{barrier,cais}``: the
    2-block period of ``trees`` (numpy block trees of ``repro``) on this
    rank's sequence shard of ``x``, 2 microbatches, under each planner and
    backend; returns {(mode, planner): (this rank's output shard, the
    optimized forward's overlap_asym nodes)}, and under "plans" every
    entry of the plan cache at ``root`` and this rank's cache counters."""
    from repro_torch.configs import get_arch

    cache = _plan_cache(root)
    cfg = get_arch(arch).smoke()
    blocks = [_block_shard(cfg, t, group) for t in trees]
    xs = _rows(x, group.rank, group.size, 1)
    out = {}
    for mode in ("barrier", "cais"):
        for planner in ("greedy", "perfsim"):
            tpc = tp_mod.TPContext(group, backend=mode,
                                   cais=prim.CAISConfig(num_chunks=2),
                                   planner=planner)
            y, _ = tp_mod.sp_period(tpc, xs, blocks, cfg, PLANNER_KINDS,
                                    num_microbatches=2)
            period, _ = tp_mod.build_period(tpc, xs, blocks, cfg,
                                            PLANNER_KINDS,
                                            num_microbatches=2)
            out[(mode, planner)] = (y.numpy(), sorted(
                nd.name for nd in period.graph.nodes
                if nd.op == "overlap_asym"))
    group.all_reduce(torch.zeros(1))     # every rank has written its plans
    out["plans"] = (_plans_on_disk(root), cache.stats, cache.memo_hits)
    return out


def loss_cells(group, cases, tokens, planner=None):
    """``LM.loss`` on this rank for every (arch, mode, microbatches) case,
    with the bridged JAX parameters of ``cases[arch]``; returns
    {(arch, mode, mb): (loss, matmul calls made, calls derived from the
    optimized period graphs, overlap_asym nodes)}, and with ``planner``
    (the arguments of :func:`planner_cells`) its cells under "planner"."""
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    from repro_torch.runtime import SMOKE, Runtime, TPConfig

    count = _count_matmuls()
    tok = _t(tokens)
    B, S = tokens.shape
    res = {}
    for arch, params in cases.items():
        cfg = get_arch(arch).smoke()
        for mode in ("barrier", "cais"):
            for mb in (1, 2):
                rt = Runtime(compute_dtype="float32",
                             loss_chunk=SMOKE.loss_chunk,
                             tp=TPConfig(mode=mode, chunks=2,
                                         microbatches=mb))
                lm = LM(cfg, rt, device="cpu", seed=None, group=group)
                bridge.load_jax_params(lm, params)
                count[0] = 0
                loss = float(lm.loss({"tokens": tok, "labels": tok}))
                made = count[0]
                tpc = tp_mod.TPContext.from_config(rt.tp, group)
                P = len(cfg.layer_pattern)
                derived = overlaps = 0
                for p in range(cfg.num_layers // P):
                    blocks = lm.blocks[p * P:(p + 1) * P]
                    base, _ = tp_mod._period_graph(tpc, blocks, cfg,
                                                   cfg.layer_pattern)
                    g = dataflow.optimize(
                        tp_mod.microbatch_period_graph(base, mb))
                    derived += tp_mod.matmul_calls(g, tpc, B // mb, S,
                                                   cfg.d_model, 4)
                    overlaps += sum(nd.op == "overlap_asym"
                                    for nd in g.nodes)
                res[(arch, mode, mb)] = (loss, made, derived, overlaps)
    if planner is not None:
        res["planner"] = planner_cells(group, *planner)
    return res


def grad_cells(group, cases, tokens, runs, norm_tree, plan_root=None,
               adafactor_case=None):
    """``LM.loss`` and its backward on this rank for every (arch, mode,
    microbatches[, planner]) run, with the bridged JAX parameters of
    ``cases[arch]``: returns {run: (loss, {param: this rank's grad}, matmul
    calls made, calls derived from the planned forward and training graphs
    (:func:`repro_torch.core.tp.build_period`), flash calls made, flash
    calls derived, overlap_asym executions, overlap_asym nodes of those
    graphs, cross-direction overlap_asym nodes, the (M, K, N, layout) of
    every matmul call with a transposed operand, the microbatches the
    period ran)}, and under "norm" the ring's ``global_norm`` of
    ``norm_tree`` (:func:`norm_cell`), and under "adafactor" the ring's
    Adafactor of ``adafactor_case`` (:func:`adafactor_cell`). A perfsim
    run plans through a cache at ``plan_root``."""
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.core.backends import get_backend
    from repro_torch.models import LM
    from repro_torch.runtime import SMOKE, Runtime, TPConfig

    from repro_torch.kernels import matmul as mmk

    count = _count_matmuls()
    transposed = set()
    inner_mm = ops.matmul

    def recorded(a, b, **kw):
        lay = mmk.layout(a, b)
        if lay != "nn":
            transposed.add((a.shape[0], a.shape[1], b.shape[1], lay))
        return inner_mm(a, b, **kw)

    ops.matmul = recorded
    flash = [0]
    inner_fa = ops.flash_attention

    def fa_counted(*a, **kw):
        flash[0] += 1
        return inner_fa(*a, **kw)

    ops.flash_attention = fa_counted
    asym = [0]
    for name in ("barrier", "cais"):
        be = get_backend(name)

        def counted(*a, _inner=be.overlap_asymmetric, **kw):
            asym[0] += 1
            return _inner(*a, **kw)

        be.overlap_asymmetric = counted
    if plan_root is not None:
        _plan_cache(plan_root)
    tok = _t(tokens)
    B, S = tokens.shape
    res = {}
    for run in runs:
        arch, mode, mb = run[:3]
        planner = run[3] if len(run) > 3 else "greedy"
        cfg = get_arch(arch).smoke()
        rt = Runtime(compute_dtype="float32", loss_chunk=SMOKE.loss_chunk,
                     remat=False,
                     tp=TPConfig(mode=mode, chunks=2, microbatches=mb,
                                 planner=planner))
        lm = LM(cfg, rt, device="cpu", seed=None, group=group)
        bridge.load_jax_params(lm, cases[arch])
        lm.requires_grad_(True)
        count[0] = flash[0] = asym[0] = 0
        transposed.clear()
        loss = lm.loss({"tokens": tok, "labels": tok})
        loss.backward()
        lm.sync_grads(tok.shape[1])
        made = (count[0], flash[0], asym[0])
        tpc = tp_mod.TPContext.from_config(rt.tp, group)
        P = len(cfg.layer_pattern)
        x = torch.empty(B, S // group.size, cfg.d_model, device="meta")
        derived = fderived = pairs = cross = 0
        for p in range(cfg.num_layers // P):
            period, _ = tp_mod.build_period(
                tpc, x, lm.blocks[p * P:(p + 1) * P], cfg, cfg.layer_pattern,
                norm_kind=cfg.norm)
            _, bwd, _ = period.training()
            for g in (period.graph, bwd):
                derived += tp_mod.matmul_calls(g, tpc, B // period.mb, S,
                                               cfg.d_model, 4)
                fderived += tp_mod.flash_calls(g)
                pairs += sum(nd.op == "overlap_asym" for nd in g.nodes)
            cross += len(tp_mod.cross_direction_pairs(period.merged, bwd))
        res[run] = (
            float(loss.detach()),
            {n: p.grad.numpy() for n, p in lm.named_parameters()},
            made[0], derived, made[1], fderived, made[2], pairs, cross,
            sorted(transposed), period.mb)
    res["norm"] = norm_cell(group, norm_tree)
    if adafactor_case is not None:
        res["adafactor"] = adafactor_cell(group, adafactor_case)
    return res


def adafactor_cell(group, case):
    """Adafactor over this rank's shards: ``case`` holds "params" {name:
    whole array}, "grads" (one such dict a step), "leaves" {name: (JAX
    leaf, stack index, shard dim)}, "lr" and "slabs"; each parameter with
    a shard dim is split over the ring along it. Returns {slab: {name:
    this rank's parameter after the steps}}."""
    from repro_torch.optim import optimizers as opt_mod

    n, r = group.size, group.rank
    leaves = {k: opt_mod.Leaf(*v) for k, v in case["leaves"].items()}

    def local(tree):
        return {k: _t(a).clone() if leaves[k].dim is None
                else _rows(a, r, n, leaves[k].dim) for k, a in tree.items()}
    sharded = {k: group for k, lf in leaves.items() if lf.dim is not None}
    out = {}
    for slab in case["slabs"]:
        params = local(case["params"])
        o = opt_mod.adafactor(opt_mod.constant_schedule(case["lr"]),
                              slab=slab)
        state = o.init(params, leaves=leaves)
        for step, g in enumerate(case["grads"]):
            o.apply(params, local(g), state, step, sharded=sharded,
                    leaves=leaves)
        out[slab] = {k: v.numpy() for k, v in params.items()}
    return out


def norm_cell(group, tree):
    """``global_norm`` of ``tree`` on this rank, with "a" sharded by rows and
    "c" by its last dimension over the ring and "b" replicated."""
    from repro_torch.optim.optimizers import global_norm

    n, r = group.size, group.rank
    local = {"a": _rows(tree["a"], r, n, 0), "b": _t(tree["b"]),
             "c": _rows(tree["c"], r, n, 2)}
    return float(global_norm(local, sharded={"a": group, "c": group}))


# ---------------------------------------------------------------------------
# serving over the ring (tests/test_torch_serve_tp.py)
# ---------------------------------------------------------------------------


def _count_gemm_ar():
    """Wrap every registered backend's ``gemm_ar`` with one counter (the
    dispatches of ``serve.backend_dispatch_gemm_ar``); returns it."""
    count = [0]
    for name in ("barrier", "cais"):
        be = backends.get_backend(name)

        def counted(*a, _inner=be.gemm_ar, **kw):
            count[0] += 1
            return _inner(*a, **kw)

        be.gemm_ar = counted
    return count


def _block_shard(cfg, tree, group):
    """A ``Block`` holding this rank's shards of a ``repro`` block's
    parameters (a numpy tree {"norm1": {...}, "mixer": {...}, ...})."""
    from repro_torch.models.transformer import Block

    blk = Block("attn", cfg, torch.float32, torch.device("cpu"), group.size)
    sd = {}
    for mod, leaves in tree.items():
        for leaf, a in leaves.items():
            t = _t(a)
            dim = tp_mod.param_shard_dim(f"blocks.0.{mod}.{leaf}", cfg,
                                         group.size)
            if dim is not None:
                t = _rows(a, group.rank, group.size, dim)
            sd[f"{mod}.{leaf}"] = t
    blk.load_state_dict(sd)
    return blk


def _view(v):
    from repro_torch.models.attention import KVView

    return KVView(*(_t(a) for a in v))


SERVE_RUNS = (("barrier", "greedy"), ("cais", "greedy"),
              ("cais", "perfsim"))


def serve_tp_cells(group, block, serve, engine, plan_root=None):
    """Every serving-over-the-ring case on this rank.

    ``block``: (arch, numpy block tree, {S: x}): ``sp_block`` in the
    replicated layout, forward and graph-built backward of mean(out²), per
    (S, mode): (out, dx, {weight: this rank's grad}, gemm_ar dispatches in
    the forward and in the backward, matmul calls made and derived from the
    forward and training graphs).
    ``serve``: {arch: (overrides, numpy params)} and the schedule, a list of
    (tokens, (bt, pos, ctx, last)): ``LM.serve_step`` per (arch, mode[,
    "perfsim"]) of :data:`SERVE_RUNS`: (logits per step, final pools,
    gemm_ar dispatches, matmul calls made and derived, flash calls made and
    derived); the perfsim run, made only with a ``plan_root``, plans
    through a cache there, whose counters it returns under ("plans",
    arch): (JSON-key hits, misses, memo hits).
    ``engine``: (arch, overrides, numpy params, prompts, max_new, serve
    config kwargs): the ring ``Engine``'s greedy tokens and every step's
    logits."""
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    from repro_torch.runtime import Runtime, TPConfig
    from repro_torch.serve import Engine, Request, ServeConfig

    ar = _count_gemm_ar()
    mm = _count_matmuls()
    flash = [0]
    inner_fa = ops.flash_attention

    def fa_counted(*a, **kw):
        flash[0] += 1
        return inner_fa(*a, **kw)

    ops.flash_attention = fa_counted
    out = {"_jax_imported": False}

    arch, tree, xs = block
    cfg = get_arch(arch).smoke()
    for S, x_np in xs.items():
        for mode in ("barrier", "cais"):
            tpc = tp_mod.TPContext(group, backend=mode,
                                   cais=prim.CAISConfig(num_chunks=2))
            blk = _block_shard(cfg, tree, group)
            blk.requires_grad_(True)
            x = _t(x_np).requires_grad_(True)
            ar[0] = mm[0] = 0
            y, _ = tp_mod.sp_block(tpc, x, blk, cfg, "attn",
                                   norm_kind=cfg.norm, seq_sharded=False)
            fwd_ar, fwd_mm = ar[0], mm[0]
            (y * y).mean().backward()
            base, _ = tp_mod._period_graph(tpc, [blk], cfg, ("attn",),
                                           seq_sharded=False)
            B = x_np.shape[0]
            derived = [tp_mod.matmul_calls(g, tpc, B, S, cfg.d_model, 4)
                       for g in (dataflow.optimize(base),
                                 tp_mod.training_graph(base, cfg.norm)[1])]
            out[("block", S, mode)] = (
                y.detach().numpy(), x.grad.numpy(),
                {n: p.grad.numpy() for n, p in blk.named_parameters()},
                (fwd_ar, ar[0] - fwd_ar), (fwd_mm, mm[0] - fwd_mm), derived)

    cases, schedule = serve
    for arch, (over, params) in cases.items():
        cfg = get_arch(arch).smoke().scaled(**over)
        for mode, planner in SERVE_RUNS:
            if planner == "perfsim" and plan_root is None:
                continue
            if planner == "perfsim":
                cache = _plan_cache(plan_root)
            rt = Runtime(compute_dtype="float32",
                         tp=TPConfig(mode=mode, chunks=2, planner=planner))
            lm = LM(cfg, rt, device="cpu", seed=None, group=group)
            bridge.load_jax_params(lm, params)
            tpc = tp_mod.TPContext.from_config(rt.tp, group)
            pools = lm.init_pools(8, 4)
            logits, counts = [], []
            for toks, view in schedule:
                ar[0] = mm[0] = flash[0] = 0
                lg, pools = lm.serve_step(_t(toks), pools, _view(view))
                B, S = toks.shape
                P = len(cfg.layer_pattern)
                derived = 0
                for lo in range(0, cfg.num_layers, P):
                    kinds = cfg.layer_kinds()[lo:lo + P]
                    g, _ = tp_mod.serve_period_graph(
                        tpc, lm.blocks[lo:lo + P], cfg, kinds)
                    derived += tp_mod.matmul_calls(
                        dataflow.optimize(g), tpc, B, S, cfg.d_model, 4)
                logits.append(lg.numpy())
                counts.append((ar[0], mm[0], derived, flash[0]))
            key = ("serve", arch, mode) + (
                (planner,) if planner != "greedy" else ())
            out[key] = (logits, [{k: v.numpy() for k, v in p.items()}
                                 for p in pools], counts)
            if planner == "perfsim":
                out[("plans", arch)] = (cache.hits, cache.misses,
                                        cache.memo_hits)

    arch, over, params, prompts, max_new, sc_kw = engine
    cfg = get_arch(arch).smoke().scaled(**over)
    rt = Runtime(compute_dtype="float32", tp=TPConfig(mode="cais"))
    lm = LM(cfg, rt, device="cpu", seed=None, group=group)
    bridge.load_jax_params(lm, params)
    seen = []
    step = lm.serve_step

    def recorded(*a):
        lg, pools = step(*a)
        seen.append(lg.numpy())
        return lg, pools

    lm.serve_step = recorded
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    eng = Engine(lm, cfg, rt, ServeConfig(**sc_kw), device="cpu")
    eng.run(reqs, seed=0)
    out["engine"] = ([r.out_tokens for r in reqs], seen,
                     eng.last_report["steps"])
    out["_jax_imported"] = "jax" in sys.modules
    return out


# ---------------------------------------------------------------------------
# MoE over the ring (tests/test_torch_moe.py)
# ---------------------------------------------------------------------------


def _a2a_cells(group, a):
    """The expert all-to-all and its adjoint through each schedule, the
    expert fn and its VJP those of the period graph (``_moe_graph_fns``),
    on this rank's send rows and its whole experts of ``a["wu"]`` etc."""
    n, r = group.size, group.rank
    _, expert_fn, _ = tp_mod._moe_graph_fns(a["cfg"], n, r)
    ws = tuple(_rows(a[k], r, n, 0) for k in ("wu", "wg", "wd"))
    send, gy = _t(a["send"][r]), _t(a["gy"][r])
    row = dataflow._row_vjp(expert_fn, ws)
    out = {}
    for name, be, bidir in (("barrier", "barrier", True),
                            ("cais", "cais", True),
                            ("cais_uni", "cais", False)):
        be = backends.get_backend(be)
        cais = prim.CAISConfig(bidirectional=bidir)
        out[f"a2a.{name}"] = be.a2a_expert_ffn(
            send, lambda c: expert_fn(c, *ws), group, cais).numpy()
        d, dws = be.grad_a2a_expert_ffn(send, gy, row, group, cais)
        out[f"grad.{name}"] = (d.numpy(), [w.numpy() for w in dws])
    return out


def _moe_lm_cells(group, cfg, params, tokens, count, flash):
    """LM.loss, its graph-built backward and ``sync_grads`` on this rank for
    barrier and cais; {mode: (loss, {param: grad}, matmul calls made,
    derived from the graphs, flash calls made, derived, backend a2a
    dispatches (forward, backward))}."""
    from repro_torch import bridge
    from repro_torch.models import LM
    from repro_torch.runtime import SMOKE, Runtime, TPConfig

    a2a = {"a2a_expert_ffn": 0, "grad_a2a_expert_ffn": 0}
    for name in ("barrier", "cais"):
        be = backends.get_backend(name)
        for meth in a2a:
            def counted(*a, _inner=getattr(be, meth), _m=meth, **kw):
                a2a[_m] += 1
                return _inner(*a, **kw)
            setattr(be, meth, counted)
    tok = _t(tokens)
    B, S = tokens.shape
    out = {}
    for mode in ("barrier", "cais"):
        rt = Runtime(compute_dtype="float32", loss_chunk=SMOKE.loss_chunk,
                     remat=False, tp=TPConfig(mode=mode, chunks=2))
        lm = LM(cfg, rt, device="cpu", seed=None, group=group)
        bridge.load_jax_params(lm, params)
        lm.requires_grad_(True)
        count[0] = flash[0] = 0
        for k in a2a:
            a2a[k] = 0
        loss = lm.loss({"tokens": tok, "labels": tok})
        loss.backward()
        lm.sync_grads(tok.shape[1])
        made = (count[0], flash[0], a2a["a2a_expert_ffn"],
                a2a["grad_a2a_expert_ffn"])
        tpc = tp_mod.TPContext.from_config(rt.tp, group)
        x = torch.empty(B, S // group.size, cfg.d_model, device="meta")
        derived = fderived = 0
        P = len(cfg.layer_pattern)
        for p in range(cfg.num_layers // P):
            period, _ = tp_mod.build_period(
                tpc, x, lm.blocks[p * P:(p + 1) * P], cfg, cfg.layer_pattern,
                norm_kind=cfg.norm)
            for g in (period.graph, period.training()[1]):
                derived += tp_mod.matmul_calls(g, tpc, B, S, cfg.d_model, 4)
                fderived += tp_mod.flash_calls(g)
        out[mode] = (float(loss.detach()),
                     {k: p.grad.numpy() for k, p in lm.named_parameters()},
                     made[0], derived, made[1], fderived, made[2:])
    return out


def _moe_ce_cell(group, cfg, params, tokens):
    """The cais ring's cross-entropy (the aux loss's weight set to 0) of
    ``LM.loss`` (multidev_checks' ``moe.auto_vs_cais_ce``)."""
    from repro_torch import bridge
    from repro_torch.models import LM, transformer
    from repro_torch.runtime import SMOKE, Runtime, TPConfig

    rt = Runtime(compute_dtype="float32", loss_chunk=SMOKE.loss_chunk,
                 tp=TPConfig(mode="cais", chunks=2))
    lm = LM(cfg, rt, device="cpu", seed=None, group=group)
    bridge.load_jax_params(lm, params)
    saved, transformer.AUX_LOSS_WEIGHT = transformer.AUX_LOSS_WEIGHT, 0.0
    try:
        tok = _t(tokens)
        return float(lm.loss({"tokens": tok, "labels": tok}))
    finally:
        transformer.AUX_LOSS_WEIGHT = saved


def _moe_e_lt_tp_cell(group, cfg, tree, x):
    """``sp_moe_ffn`` with fewer experts than ranks (multidev_checks'
    ``sp_moe_ffn.e_lt_tp``): every rank holds the whole (replicated)
    experts of ``tree`` and its sequence shard of ``x``; returns its output
    shard."""
    from repro_torch.models.ffn import MoE

    moe = MoE(cfg, torch.float32, torch.device("cpu"),
              cfg.moe.num_experts)
    with torch.no_grad():
        for k in ("router", "w_up", "w_gate", "w_down"):
            getattr(moe, k).copy_(_t(tree["ffn"][k]))
    tpc = tp_mod.TPContext(group, backend="cais",
                           cais=prim.CAISConfig(num_chunks=2))
    out, aux = tp_mod.sp_moe_ffn(tpc, _rows(x, group.rank, group.size, 1),
                                 _t(tree["norm2"]["scale"]), moe, cfg)
    return out.numpy(), float(aux)


def _moe_step_cell(group, cfg, params, batch, lr, opt_name="adamw"):
    """One train step (``make_train_step``, AdamW unless ``opt_name``) of
    the cais ring; returns (loss, grad norm, {param: this rank's updated
    value})."""
    from repro_torch import bridge
    from repro_torch.models import LM
    from repro_torch.optim import constant_schedule, make_optimizer
    from repro_torch.runtime import SMOKE, Runtime, TPConfig
    from repro_torch.train.step import init_state, make_train_step

    rt = Runtime(compute_dtype="float32", loss_chunk=SMOKE.loss_chunk,
                 remat=False, tp=TPConfig(mode="cais", chunks=2))
    lm = LM(cfg, rt, device="cpu", seed=None, group=group)
    bridge.load_jax_params(lm, params)
    opt = make_optimizer(opt_name, constant_schedule(lr))
    state = init_state(lm, opt)
    state, m = make_train_step(lm, opt, rt)(state, batch)
    return (float(m["loss"]), float(m["grad_norm"]),
            {k: p.detach().numpy().copy()
             for k, p in lm.named_parameters()})


def moe_cells(group, data):
    """Every MoE cell of ``tests/test_torch_moe.py`` on one spawn: "a2a" (the
    expert all-to-all), "lm" (LM.loss and grads, barrier and cais), "ce"
    (the cais cross-entropy), and where ``data`` holds them "e_lt_tp" and
    "step"."""
    count = _count_matmuls()
    flash = [0]
    inner_fa = ops.flash_attention

    def fa_counted(*a, **kw):
        flash[0] += 1
        return inner_fa(*a, **kw)

    ops.flash_attention = fa_counted
    out = {"a2a": _a2a_cells(group, data["a2a"]),
           "lm": _moe_lm_cells(group, *data["lm"], count, flash),
           "ce": _moe_ce_cell(group, *data["ce"])}
    if "e_lt_tp" in data:
        out["e_lt_tp"] = _moe_e_lt_tp_cell(group, *data["e_lt_tp"])
    if "step" in data:
        out["step"] = _moe_step_cell(group, *data["step"])
    out["_jax_imported"] = "jax" in sys.modules
    return out


# ---------------------------------------------------------------------------
# checkpoints across ring layouts (tests/test_torch_checkpoint.py)
# ---------------------------------------------------------------------------


CKPT_MESHES = {"4": {}, "2": dict(dp=2), "2x2": dict(tp_in=2, tp_out=2)}


def ckpt_step_run(mesh, cfg, root, batches, opt_name, lr, layout, src=None):
    """One layout's run of the checkpoint cells, on ``mesh`` (None: one
    device): a fresh train state, then step 0 and a save as step 1 under
    ``root/opt/layout`` (``src`` None), or the step-1 checkpoint of layout
    ``src`` restored; then step 1, saved as step 2 under ``root/opt/out/
    layout`` (``layout<-src`` for a restore). Returns (step 1's loss, grad norm). A replica of a data
    axis steps on its rows of each batch."""
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import replica_rows
    from repro_torch.models import build_model
    from repro_torch.optim import constant_schedule, make_optimizer
    from repro_torch.runtime import SMOKE, Runtime, TPConfig
    from repro_torch.train.step import (init_state, make_train_step,
                                        state_placement)

    rt = Runtime(compute_dtype="float32", loss_chunk=SMOKE.loss_chunk,
                 remat=False, tp=TPConfig(mode="cais", chunks=2))
    lm = build_model(cfg, rt, device="cpu", seed=0, group=mesh)
    opt = make_optimizer(opt_name, constant_schedule(lr))
    state = init_state(lm, opt)
    step = make_train_step(lm, opt, rt)
    place = state_placement(lm, opt)
    if lm.dp > 1:
        batches = [replica_rows(b, lm.data.rank, lm.dp) for b in batches]
    d = os.path.join(root, opt_name)
    if src is None:
        step(state, batches[0])
        store.save(os.path.join(d, layout), state, 1, group=lm.mesh,
                   placement=place)
    else:
        store.restore(os.path.join(d, src), state, placement=place, step=1)
    _, m = step(state, batches[1])
    run = layout if src is None else f"{layout}<-{src}"
    store.save(os.path.join(d, "out", run), state, 2, group=lm.mesh,
               placement=place)
    return float(m["loss"]), float(m["grad_norm"])


def ckpt_layout_cells(group, cfg, root, batches, runs, lr):
    """Every (optimizer, layout, source) of ``runs`` on this rank
    (:func:`ckpt_step_run`), the layouts the meshes of CKPT_MESHES factored
    from this world of 4; returns {(optimizer, "layout<-source"): (loss,
    grad norm)} ("layout" alone where it wrote its own)."""
    from repro_torch.sharding import init_mesh

    meshes = {k: group if not kw else init_mesh(group, **kw)
              for k, kw in CKPT_MESHES.items()}
    out = {}
    for opt_name, layout, src in runs:
        out[(opt_name, layout if src is None else f"{layout}<-{src}")] = \
            ckpt_step_run(
                meshes[layout], cfg, root, batches, opt_name, lr, layout, src)
    out["_jax_imported"] = "jax" in sys.modules
    return out
