"""Per-rank bodies of ``tests/test_torch_sublayer.py``, run on every rank of
a gloo ring by ``repro_torch.launch.ranks.run_ranks``: the per-sub-layer TP
graphs (``sp_ffn``, ``sp_attention``), the split block, an MLA block, and
``LM.loss`` with its grads where blocks run sub-layer by sub-layer, at
ragged S and without sequence parallelism. Imports torch, numpy and
``repro_torch`` only, so the rank processes never import JAX; the test
compares what they return against JAX on one device."""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.core import primitives as prim
from repro_torch.core import tp as tp_mod
from repro_torch.kernels import ops

MODES = ("barrier", "cais")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(a, r, n, dim):
    """Rank r's contiguous slice of a numpy array along ``dim``."""
    s = a.shape[dim] // n
    return _t(np.take(a, range(r * s, (r + 1) * s), axis=dim))


def _tpc(group, mode, chunks=2):
    return tp_mod.TPContext(group, backend=mode,
                            cais=prim.CAISConfig(num_chunks=chunks))


def _np(t):
    return t.detach().numpy().copy()


def _block(kind, cfg, tree, group):
    """A ``Block`` of ``kind`` holding this rank's shards of a ``repro``
    block's parameters (a numpy tree {"norm1": {...}, "mixer": {...},
    ...})."""
    from repro_torch.models.transformer import Block

    blk = Block(kind, cfg, torch.float32, torch.device("cpu"), group.size)
    sd = {}
    for mod, leaves in tree.items():
        for leaf, a in leaves.items():
            dim = tp_mod.param_shard_dim(f"blocks.0.{mod}.{leaf}", cfg,
                                         group.size)
            sd[f"{mod}.{leaf}"] = _t(a) if dim is None else \
                _rows(a, group.rank, group.size, dim)
    blk.load_state_dict(sd)
    blk.requires_grad_(True)
    return blk


def _seeded(x, gy, sharded, r, n):
    """(x, the output cotangent) as this rank holds them: its sequence rows
    where the layout is sharded, whole otherwise."""
    if sharded:
        return _rows(x, r, n, 1).requires_grad_(True), _rows(gy, r, n, 1)
    return _t(x).requires_grad_(True), _t(gy)


def ffn_cells(group, d, tpc_group=None):
    """``sp_ffn`` forward and grads: {(layout, mode, chunks): (out, dx,
    [d scale, d w_up, d w_gate, d w_down])}, out and dx this rank's rows
    (sharded) or whole (replicated), the weights' grads this rank's shards.
    ``tpc_group`` (a 2D mesh's composite group) runs it there."""
    g = tpc_group or group
    n, r = g.size, g.rank
    out = {}
    for layout in ("sharded", "replicated"):
        sharded = layout == "sharded"
        S = "" if sharded else "3"
        for mode, chunks in (("barrier", 2), ("cais", 2), ("cais", None)):
            x, gy = _seeded(d["x" + S], d["gy" + S], sharded, r, n)
            ws = [_t(d["ns"]), _rows(d["wu"], r, n, 1),
                  _rows(d["wg"], r, n, 1), _rows(d["wd"], r, n, 0)]
            for w in ws:
                w.requires_grad_(True)
            y = tp_mod.sp_ffn(_tpc(g, mode, chunks), x, *ws, "silu",
                              seq_sharded=sharded)
            y.backward(gy)
            out[(layout, mode, chunks)] = (_np(y), _np(x.grad),
                                           [_np(w.grad) for w in ws])
    return out


def attention_cells(group, cases):
    """``sp_attention`` forward and grads per (case, layout, mode): (out,
    dx, [d scale, d wq, d wk, d wv, d wo]); wk/wv whole on every rank where
    the case's kv heads do not split over the ring."""
    n, r = group.size, group.rank
    out = {}
    for label, (cfg, d) in cases.items():
        kv_dim = 1 if cfg.num_kv_heads % n == 0 else None
        for layout in ("sharded", "replicated"):
            sharded = layout == "sharded"
            S = "" if sharded else "3"
            for mode in MODES:
                x, gy = _seeded(d["x" + S], d["gy" + S], sharded, r, n)
                ws = [_t(d["ns"]), _rows(d["wq"], r, n, 1)]
                ws += [_t(d[k]) if kv_dim is None else _rows(d[k], r, n, 1)
                       for k in ("wk", "wv")]
                ws.append(_rows(d["wo"], r, n, 0))
                for w in ws:
                    w.requires_grad_(True)
                y = tp_mod.sp_attention(_tpc(group, mode), x, *ws, cfg,
                                        seq_sharded=sharded)
                y.backward(gy)
                out[(label, layout, mode)] = (_np(y), _np(x.grad),
                                              [_np(w.grad) for w in ws])
    return out


def split_cells(group, cfg, tree, x_np):
    """The split composition ``x + sp_attention`` then ``+ sp_ffn`` against
    the whole-block graph ``sp_block`` on this rank's rows, per mode:
    (split output, whole-block output)."""
    n, r = group.size, group.rank
    out = {}
    for mode in MODES:
        tpc = _tpc(group, mode)
        blk = _block("attn", cfg, tree, group)
        x = _rows(x_np, r, n, 1)
        with torch.no_grad():
            m, f = blk.mixer, blk.ffn
            r1 = x + tp_mod.sp_attention(tpc, x, blk.norm1.scale, m.wq,
                                         m.wk, m.wv, m.wo, cfg)
            y = r1 + tp_mod.sp_ffn(tpc, r1, blk.norm2.scale, f.w_up,
                                   f.w_gate, f.w_down, cfg.act)
            whole, _ = tp_mod.sp_block(tpc, x, blk, cfg, "attn")
        out[mode] = (_np(y), _np(whole))
    return out


def mla_block_cells(group, cfg, tree, x_np, gy_np):
    """An MLA block (its mixer replicated, its FFN through ``sp_ffn``) on
    this rank's rows, per mode: (out rows, dx rows, {param: grad}), the
    replicated parameters' partial grads summed over the ring as
    ``LM.sync_grads`` sums them."""
    from repro_torch.models.transformer import (block_forward,
                                                replicated_block_params)

    n, r = group.size, group.rank
    out = {}
    for mode in MODES:
        tpc = _tpc(group, mode)
        blk = _block("mla", cfg, tree, group)
        x, gy = _seeded(x_np, gy_np, True, r, n)
        y, _ = block_forward("mla", blk, x, cfg, tpc)
        y.backward(gy)
        partial = replicated_block_params("mla", cfg, tpc)
        grads = {}
        for k, p in blk.named_parameters():
            g = group.all_reduce(p.grad) if k.startswith(partial) else p.grad
            grads[k] = _np(g)
        out[mode] = (_np(y), _np(x.grad), grads)
    return out


def _counters():
    """Count the kernels' calls on this rank (matmul, flash attention,
    matmul_rmsnorm) through their ``ops`` entry points; returns the
    counter dict."""
    count = {"matmul": 0, "flash": 0, "matmul_rmsnorm": 0}
    for key, name in (("matmul", "matmul"), ("flash", "flash_attention"),
                      ("matmul_rmsnorm", "matmul_rmsnorm")):
        inner = getattr(ops, name)

        def counted(*a, _inner=inner, _k=key, **kw):
            count[_k] += 1
            return _inner(*a, **kw)

        setattr(ops, name, counted)
    return count


def lm_cells(group, cases, count):
    """``LM.loss``, its backward and ``sync_grads`` per case and run:
    {(case, mode, mb, sequence_parallel): (loss, {param: this rank's grad},
    the kernel calls made, the counts ``tp.step_launches`` derives from
    what the forward recorded)}."""
    from repro_torch import bridge
    from repro_torch.core import tp as tp_mod
    from repro_torch.models import LM
    from repro_torch.models.transformer import activation_layout
    from repro_torch.runtime import SMOKE, Runtime, TPConfig

    out = {}
    for label, (cfg, params, tokens, runs) in cases.items():
        tok = _t(tokens)
        B, S = tokens.shape
        for mode, mb, sp in runs:
            rt = Runtime(compute_dtype="float32",
                         loss_chunk=SMOKE.loss_chunk, remat=False,
                         tp=TPConfig(mode=mode, chunks=2, microbatches=mb,
                                     sequence_parallel=sp))
            lm = LM(cfg, rt, device="cpu", seed=None, group=group)
            bridge.load_jax_params(lm, params)
            lm.requires_grad_(True)
            for k in count:
                count[k] = 0
            with tp_mod.recording() as rec:
                loss = lm.loss({"tokens": tok, "labels": tok})
            loss.backward()
            lm.sync_grads(S)
            made = dict(count)
            derived = tp_mod.step_launches(rec, B, S, cfg.d_model, 4)
            derived["layout"] = activation_layout(rt, S, group.size)
            out[(label, mode, mb, sp)] = (
                float(loss.detach()),
                {k: _np(p.grad) for k, p in lm.named_parameters()}, made,
                {k: derived[k] for k in ("layout", "matmul", "flash",
                                         "matmul_rmsnorm")})
    return out


def sublayer_cells(group, data):
    """Every cell of one spawn: "ffn", "attn", "split", "mla", "lm", and
    where ``data`` holds it "ffn_2d" (sp_ffn on tp_in 2 x tp_out 2 of a
    world of 4)."""
    count = _counters()
    out = {"ffn": ffn_cells(group, data["ffn"]),
           "attn": attention_cells(group, data["attn"]),
           "split": split_cells(group, *data["split"]),
           "mla": mla_block_cells(group, *data["mla"]),
           "lm": lm_cells(group, data["lm"], count)}
    if "ffn_2d" in data:
        from repro_torch.sharding import init_mesh

        mesh = init_mesh(group, tp_in=2, tp_out=2)
        out["ffn_2d"] = ffn_cells(group, data["ffn_2d"], mesh.tp)
    out["_jax_imported"] = "jax" in sys.modules
    return out
