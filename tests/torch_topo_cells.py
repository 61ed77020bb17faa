"""Per-rank bodies of ``tests/test_torch_topo.py``: the 2D (``tp_in`` x
``tp_out``) mesh, the ``data`` x ``model`` mesh and a ``data`` axis of 4,
all factored from one gloo world of 4 by
:func:`repro_torch.sharding.init_mesh`. Imports torch, numpy and
``repro_torch`` only, so the rank processes never import JAX; the test
compares what they return against JAX on one device and against the
port's flat ring of 4."""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.core import backends, dataflow as df
from repro_torch.core import primitives as prim
from repro_torch.core import tp as tp_mod
from repro_torch.kernels import ops
from repro_torch.sharding import CompositeGroup

CAIS2 = prim.CAISConfig(num_chunks=2)
MODES = ("barrier", "cais")
# a sub-layer graph's weight key -> the LM parameter it stands for
SUBLAYER_PARAMS = {"scale": None, "wq": "mixer.wq", "wk": "mixer.wk",
                   "wv": "mixer.wv", "wo": "mixer.wo", "w_up": "ffn.w_up",
                   "w_gate": "ffn.w_gate", "w_down": "ffn.w_down"}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seq(a, group):
    """This rank's sequence shard (dim 1) of ``a`` on ``group``."""
    s = a.shape[1] // group.size
    return _t(a[:, group.rank * s:(group.rank + 1) * s])


def _shard(a, key, cfg, group):
    leaf = SUBLAYER_PARAMS[key]
    t = _t(a)
    return t if leaf is None else tp_mod.shard_param(
        t, "blocks.0." + leaf, cfg, group).contiguous()


def _placement(name, cfg, group):
    place = tp_mod.param_placement(name, cfg, group)
    return None if place is None else (place[0], place[1].size,
                                       place[1].rank)


def _name(group, mesh):
    """Which of ``mesh``'s groups ``group`` is."""
    for k in ("tp_out", "tp", "tp_in", "data", "world"):
        if group is getattr(mesh, k):
            return "composite" if isinstance(group, CompositeGroup) else k
    return "other"


def layout_cells(world, meshes):
    """Each mesh's ranks and members as this rank sees them, and one
    ppermute around each tp_in and tp_out ring of the 2D mesh (a subgroup
    whose global ranks are not its group ranks)."""
    out = {}
    for key, m in meshes.items():
        out[key] = {k: (getattr(m, k).rank, getattr(m, k).ranks)
                    for k in ("data", "tp", "tp_in", "tp_out")}
        out[key]["is_2d"] = m.is_2d
    m2 = meshes["2d"]
    for k in ("tp_in", "tp_out"):
        g = getattr(m2, k)
        perm = [(i, (i + 1) % g.size) for i in range(g.size)]
        got = g.ppermute(torch.tensor([float(world.rank)]), perm)
        out[f"ppermute.{k}"] = float(got[0])
    return out


def _ffn_graph():
    nodes = [df.Node("x", "input"),
             df.Node("ln", "layernorm", ("x",), ("scale",))]
    nodes += tp_mod._ffn_chain_nodes("ln", "out", True, "silu")
    return df.Graph(nodes, outputs=("out",))


def _attention_graph(core):
    """JAX's ``attention_sublayer_graph``: LN → AG → q|k|v → core → out
    GEMM → RS, without the residual."""
    N = df.Node
    return df.Graph([
        N("x", "input"), N("ln", "layernorm", ("x",), ("scale",)),
        N("agx", "allgather", ("ln",)),
        N("q", "gemm_col", ("agx",), ("wq",)),
        N("k", "gemm_col", ("agx",), ("wk",)),
        N("v", "gemm_col", ("agx",), ("wv",)),
        N("o", "custom", ("q", "k", "v"), fn=core),
        N("proj", "gemm_row", ("o",), ("wo",)),
        N("out", "reduce_scatter", ("proj",))], outputs=("out",))


def sweep_cells(groups, d):
    """``sweep.{ffn,attn,gqa}.{mode}.S{S}`` on each group of ``groups``
    ({"flat": the world ring, "2d": the composite group}): this rank's
    output shard of the sub-layer on its sequence shard."""
    count = [0]
    inner = ops.matmul

    def counted(a, b, **kw):
        count[0] += 1
        return inner(a, b, **kw)

    ops.matmul = counted
    out = {}
    try:
        for gname, g in groups.items():
            for kind in ("ffn", "attn", "gqa"):
                cfg = d["cfg_gqa"] if kind == "gqa" else d["cfg"]
                if kind == "ffn":
                    graph, keys = _ffn_graph(), ("scale", "w_up", "w_gate",
                                                 "w_down")
                else:
                    graph = _attention_graph(tp_mod._attention_core_fn(
                        cfg, g.size, rank=g.rank))
                    keys = ("scale", "wq", "wk", "wv", "wo")
                graph = df.optimize(graph)
                ws = {k: _shard(d["w"][kind][k], k, cfg, g) for k in keys}
                for mode in MODES:
                    for S, x in d["x"].items():
                        count[0] = 0
                        y = df.execute(graph, {"x": _seq(x, g)}, ws,
                                       group=g, cais=CAIS2,
                                       backend=mode)[0]
                        tpc = tp_mod.TPContext(g, backend=mode, cais=CAIS2)
                        derived = tp_mod.matmul_calls(
                            graph, tpc, x.shape[0], S, x.shape[2], 4)
                        out[(gname, kind, mode, S)] = (y.numpy(), count[0],
                                                       derived)
    finally:
        ops.matmul = inner
    return out


def ragged_cells(group, d):
    """``ragged.gemm_ar.{mode}.S{S}``: each backend's ``gemm_ar`` on the
    composite group with x feature-sharded and w row-sharded (the
    hierarchical AR, and the monolithic allreduce where S does not split
    over the whole group)."""
    out = {}
    n, r = group.size, group.rank
    w = d["w"]
    f = w.shape[0] // n
    for mode in MODES:
        be = backends.get_backend(mode)
        for S, x in d["x"].items():
            xl = _t(x[:, :, r * f:(r + 1) * f])
            out[(mode, S)] = be.gemm_ar(xl, _t(w[r * f:(r + 1) * f]), group,
                                        CAIS2).numpy()
    return out


class RecordingCAIS(backends.CAISBackend):
    """cais, recording the group of every expert all-to-all and adjoint it
    is asked for."""

    name = "cais-record"

    def __init__(self):
        self.seen = []

    def a2a_expert_ffn(self, send, ffn, group, cais):
        self.seen.append(("a2a", group))
        return super().a2a_expert_ffn(send, ffn, group, cais)

    def grad_a2a_expert_ffn(self, send, gy, bwd_row, group, cais):
        self.seen.append(("grad", group))
        return super().grad_a2a_expert_ffn(send, gy, bwd_row, group, cais)


def grouped_ep_cells(mesh, d):
    """``grouped_ep.moe.{mode}``: ``sp_moe_ffn`` on the 2D mesh, a rank's
    whole experts those of its tp_out index; and the recording backend's
    dispatches (``sp_moe_ffn``, then an MoE LM's loss and backward)."""
    from repro_torch import bridge
    from repro_torch.models import LM
    from repro_torch.models.ffn import MoE
    from repro_torch.runtime import SMOKE, Runtime, TPConfig

    g = mesh.tp
    cfg, tree = d["cfg"], d["tree"]
    e_loc = cfg.moe.num_experts // g.tp_out.size
    moe = MoE(cfg, torch.float32, torch.device("cpu"), e_loc)
    with torch.no_grad():
        moe.router.copy_(_t(tree["ffn"]["router"]))
        for k in ("w_up", "w_gate", "w_down"):
            getattr(moe, k).copy_(tp_mod.shard_param(
                _t(tree["ffn"][k]), "blocks.0.ffn." + k, cfg, g))
    xs = _seq(d["x"], g)
    scale = _t(tree["norm2"]["scale"])
    out = {}
    for mode in MODES:
        tpc = tp_mod.TPContext(g, backend=mode, cais=CAIS2)
        y, aux = tp_mod.sp_moe_ffn(tpc, xs, scale, moe, cfg)
        out[mode] = (y.numpy(), float(aux))
    rec = backends.register_backend(RecordingCAIS())
    try:
        tpc = tp_mod.TPContext(g, backend=rec.name, cais=CAIS2)
        tp_mod.sp_moe_ffn(tpc, xs, scale, moe, cfg)
        lcfg, params, tokens = d["lm"]
        rt = Runtime(compute_dtype="float32", loss_chunk=SMOKE.loss_chunk,
                     remat=False, tp=TPConfig(mode=rec.name, chunks=2))
        lm = LM(lcfg, rt, device="cpu", seed=None, group=mesh)
        bridge.load_jax_params(lm, params)
        lm.requires_grad_(True)
        tok = _t(tokens)
        lm.loss({"tokens": tok, "labels": tok}).backward()
    finally:
        backends.unregister_backend(rec.name)
    out["dispatch"] = [(k, _name(grp, mesh)) for k, grp in rec.seen]
    return out


def lm_cells(meshes, cases):
    """``topo2d.{label}.{mode}``: ``LM.loss``, its graph-built backward and
    ``sync_grads`` on each mesh of ``meshes`` for every case ({label: (cfg,
    numpy params, tokens)}); returns {(label, mesh, mode): (loss, {param:
    (this rank's grad, placement)}, matmul calls made, derived from the
    planned graphs)}."""
    from repro_torch import bridge
    from repro_torch.models import LM
    from repro_torch.runtime import SMOKE, Runtime, TPConfig

    count = [0]
    inner = ops.matmul

    def counted(a, b, **kw):
        count[0] += 1
        return inner(a, b, **kw)

    ops.matmul = counted
    out = {}
    try:
        for label, (cfg, params, tokens) in cases.items():
            tok = _t(tokens)
            B, S = tokens.shape
            for mname, mesh in meshes.items():
                for mode in MODES:
                    rt = Runtime(compute_dtype="float32",
                                 loss_chunk=SMOKE.loss_chunk, remat=False,
                                 tp=TPConfig(mode=mode, chunks=2))
                    lm = LM(cfg, rt, device="cpu", seed=None, group=mesh)
                    bridge.load_jax_params(lm, params)
                    lm.requires_grad_(True)
                    count[0] = 0
                    loss = lm.loss({"tokens": tok, "labels": tok})
                    loss.backward()
                    lm.sync_grads(tok.shape[1])
                    made = count[0]
                    tpc = tp_mod.TPContext.from_config(rt.tp, lm.group)
                    x = torch.empty(B, S // lm.tp, cfg.d_model,
                                    device="meta")
                    P = len(cfg.layer_pattern)
                    derived = 0
                    for p in range(cfg.num_layers // P):
                        period, _ = tp_mod.build_period(
                            tpc, x, lm.blocks[p * P:(p + 1) * P], cfg,
                            cfg.layer_pattern, norm_kind=cfg.norm)
                        for gr in (period.graph, period.training()[1]):
                            derived += tp_mod.matmul_calls(
                                gr, tpc, B // period.mb, S, cfg.d_model, 4)
                    grads = {k: (p.grad.numpy(),
                                 _placement(k, cfg, lm.group))
                             for k, p in lm.named_parameters()}
                    out[(label, mname, mode)] = (float(loss.detach()), grads,
                                                 made, derived)
    finally:
        ops.matmul = inner
    return out


def dp_cells(mesh, d):
    """``model.dp.{mode}``: one AdamW train step (``make_train_step``) on
    the data 2 x model 2 mesh, each replica on its rows of the global
    batch; returns {mode: (loss, grad norm, {param: (grad, updated value,
    placement)})}."""
    from repro_torch import bridge
    from repro_torch.data.pipeline import replica_rows
    from repro_torch.models import LM
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.runtime import SMOKE
    from repro_torch.train.step import init_state, make_train_step
    import dataclasses

    cfg, params, batch, lr = d
    rows = replica_rows(batch, mesh.data.rank, mesh.data.size)
    out = {}
    for mode in MODES:
        rt = dataclasses.replace(SMOKE, tp=dataclasses.replace(
            SMOKE.tp, mode=mode, chunks=2))
        lm = LM(cfg, rt, device="cpu", seed=None, group=mesh)
        bridge.load_jax_params(lm, params)
        opt = adamw(constant_schedule(lr))
        state = init_state(lm, opt)
        state, m = make_train_step(lm, opt, rt)(state, rows)
        out[mode] = (float(m["loss"]), float(m["grad_norm"]),
                     {k: (p.grad.numpy().copy(), p.detach().numpy().copy(),
                          _placement(k, cfg, lm.group))
                      for k, p in lm.named_parameters()})
    return out


def compression_cells(mesh, local_grads, steps=16):
    """``compression.int8_close`` and ``.error_feedback_unbiased`` on the
    data axis of 4: this replica's row of ``local_grads`` reduced once,
    and the mean of ``steps`` reductions with error feedback."""
    from repro_torch.optim.compression import (compressed_psum,
                                               init_error_feedback,
                                               wire_bytes_saved)

    g = {"g": _t(local_grads[mesh.data.rank])}
    ef = init_error_feedback(g)
    red, _ = compressed_psum(g, ef, mesh.data)
    acc = torch.zeros_like(g["g"])
    for _ in range(steps):
        r, ef = compressed_psum(g, ef, mesh.data)
        acc = acc + r["g"]
    return red["g"].numpy(), (acc / steps).numpy(), wire_bytes_saved(g)


def plan_cells(meshes, d, root):
    """The perfsim plans of a 2-block period on each mesh of ``meshes``
    (2 microbatches, and ``"auto"``), written to the plan cache at
    ``root/<mesh>``; returns {mesh: every entry of that cache}."""
    import os

    from repro_torch import plan
    from repro_torch.configs import get_arch

    cfg = get_arch(d["arch"]).smoke()
    out = {}
    for mname, mesh in meshes.items():
        sub = os.path.join(root, mname)
        plan.cache._DEFAULT = plan.PlanCache(root=sub)
        blocks = [_block(cfg, t, mesh.tp) for t in d["trees"]]
        x = d["x"]
        rows = x.shape[0] // mesh.data.size
        xs = _seq(x[mesh.data.rank * rows:(mesh.data.rank + 1) * rows],
                  mesh.tp)
        for mode in MODES:
            for mb in (2, "auto"):
                tpc = tp_mod.TPContext(mesh.tp, backend=mode, cais=CAIS2,
                                       planner="perfsim")
                tp_mod.build_period(tpc, xs, blocks, cfg, d["kinds"],
                                    num_microbatches=mb)
        mesh.world.all_reduce(torch.zeros(1))     # every rank has written
        out[mname] = {f[:-5]: open(os.path.join(sub, f)).read()
                      for f in sorted(os.listdir(sub)) if f.endswith(".json")}
    return out


def _block(cfg, tree, group):
    """A ``Block`` holding this rank's shards of a ``repro`` block tree."""
    from repro_torch.models.transformer import Block

    blk = Block("attn", cfg, torch.float32, torch.device("cpu"), group.size)
    blk.load_state_dict({
        f"{mod}.{leaf}": tp_mod.shard_param(
            _t(a), f"blocks.0.{mod}.{leaf}", cfg, group).contiguous()
        for mod, leaves in tree.items() for leaf, a in leaves.items()})
    return blk


def topo_cells(world, data, root):
    """Every cell of ``tests/test_torch_topo.py`` on one world of 4."""
    from repro_torch.sharding import init_mesh

    m2 = init_mesh(world, tp_in=2, tp_out=2)
    mdp = init_mesh(world, dp=2)
    m4 = init_mesh(world, dp=4)
    flat = init_mesh(world)
    out = {"layout": layout_cells(world, {"2d": m2, "dp": mdp, "d4": m4,
                                          "flat": flat})}
    out["sweep"] = sweep_cells({"flat": world, "2d": m2.tp}, data["sweep"])
    out["ragged"] = ragged_cells(m2.tp, data["ragged"])
    out["grouped_ep"] = grouped_ep_cells(m2, data["grouped_ep"])
    out["lm"] = lm_cells({"flat": flat, "2d": m2}, data["lm"])
    out["dp"] = dp_cells(mdp, data["dp"])
    out["compression"] = compression_cells(m4, data["compression"])
    out["plans"] = plan_cells({"2d": m2, "dp": mdp}, data["plans"], root)
    out["_jax_imported"] = "jax" in sys.modules
    return out
