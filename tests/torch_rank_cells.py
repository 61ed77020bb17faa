"""Per-rank bodies of the port's multi-rank CPU tests (``tests/test_torch_core.py``,
``tests/test_torch_tp.py``, ``tests/test_torch_train.py``), run on every rank of a gloo ring by
``repro_torch.launch.ranks.run_ranks``. This module imports torch, numpy and
``repro_torch`` only, so the rank processes never import JAX; the tests
compare what the ranks return against JAX and against unsharded math."""
from __future__ import annotations

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


def loss_cells(group, cases, tokens):
    """``LM.loss`` on this rank for every (arch, mode, microbatches) case,
    with the bridged JAX parameters of ``cases[arch]``; returns
    {(arch, mode, mb): (loss, matmul calls made, calls derived from the
    optimized period graphs, overlap_asym nodes)}."""
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
    return res


def grad_cells(group, cases, tokens, runs, norm_tree):
    """``LM.loss`` and its backward on this rank for every (arch, mode,
    microbatches) run, with the bridged JAX parameters of ``cases[arch]``:
    returns {run: (loss, {param: this rank's grad}, matmul calls made,
    calls derived from the optimized forward and training graphs, flash
    calls made, flash calls derived, overlap_asym executions, overlap_asym
    nodes of those graphs, cross-direction overlap_asym nodes, the (M, K, N,
    layout) of every matmul call with a transposed operand)}, and under
    "norm" the ring's ``global_norm`` of ``norm_tree`` (:func:`norm_cell`)."""
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
    tok = _t(tokens)
    B, S = tokens.shape
    res = {}
    for arch, mode, mb in runs:
        cfg = get_arch(arch).smoke()
        rt = Runtime(compute_dtype="float32", loss_chunk=SMOKE.loss_chunk,
                     remat=False,
                     tp=TPConfig(mode=mode, chunks=2, microbatches=mb))
        lm = LM(cfg, rt, device="cpu", seed=None, group=group)
        bridge.load_jax_params(lm, cases[arch])
        lm.requires_grad_(True)
        count[0] = flash[0] = asym[0] = 0
        transposed.clear()
        loss = lm.loss({"tokens": tok, "labels": tok})
        loss.backward()
        lm.sync_grads()
        made = (count[0], flash[0], asym[0])
        tpc = tp_mod.TPContext.from_config(rt.tp, group)
        P = len(cfg.layer_pattern)
        derived = fderived = pairs = cross = 0
        for p in range(cfg.num_layers // P):
            base, _ = tp_mod._period_graph(tpc, lm.blocks[p * P:(p + 1) * P],
                                           cfg, cfg.layer_pattern)
            merged = tp_mod.microbatch_period_graph(base, mb)
            fwd = dataflow.optimize(merged)
            _, bwd = tp_mod.training_graph(merged, cfg.norm)
            for g in (fwd, bwd):
                derived += tp_mod.matmul_calls(g, tpc, B // mb, S,
                                               cfg.d_model, 4)
                fderived += tp_mod.flash_calls(g)
                pairs += sum(nd.op == "overlap_asym" for nd in g.nodes)
            cross += len(tp_mod.cross_direction_pairs(merged, bwd))
        res[(arch, mode, mb)] = (
            float(loss.detach()),
            {n: p.grad.numpy() for n, p in lm.named_parameters()},
            made[0], derived, made[1], fderived, made[2], pairs, cross,
            sorted(transposed))
    res["norm"] = norm_cell(group, norm_tree)
    return res


def norm_cell(group, tree):
    """``global_norm`` of ``tree`` on this rank, with "a" sharded by rows and
    "c" by its last dimension over the ring and "b" replicated."""
    from repro_torch.optim.optimizers import global_norm

    n, r = group.size, group.rank
    local = {"a": _rows(tree["a"], r, n, 0), "b": _t(tree["b"]),
             "c": _rows(tree["c"], r, n, 2)}
    return float(global_norm(local, group, sharded=("a", "c")))
