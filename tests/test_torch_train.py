"""The port's training slice against the JAX package on the CPU: the
graph-built backward (training graphs node for node, before and after
``optimize()``; each adjoint against ``jax.vjp`` of the unoptimized graph;
the derived weights), the LM gradients on gloo rings of 2 and 4 ranks
against JAX's one-device ``jax.value_and_grad`` of ``LM.loss``, AdamW and
its clip and schedules, the train step with gradient accumulation, the data
pipeline, remat, the launcher, the matmul kernel's transposed layouts, and
the configs the two packages share. The ranks run in their own processes
(``tests/torch_rank_cells.py``, no JAX), spawned once per world size."""
import contextlib
import functools
import io
import math
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.core import dataflow as jdf  # noqa: E402
from repro.core import tp as jtp  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa

import torch_rank_cells as cells  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import dataflow as df  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.core.tp import param_shard_dim  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import matmul as mmk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.runtime import SMOKE, Runtime  # noqa: E402
from repro_torch.train.step import init_state, make_train_step  # noqa: E402

TOKENS = np.random.default_rng(3).integers(0, 256, (2, 32)).astype(np.int32)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
GRAD_RTOL = 1e-5          # per tensor: max|Δ| <= 1e-5 * max(1, max|g|)
PORTED = ("gemma3-1b", "internlm2-1.8b", "deepseek-7b", "minicpm3-4b",
          "mixtral-8x7b", "mamba2-130m", "recurrentgemma-2b", "whisper-tiny",
          "paligemma-3b", "arctic-480b")


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# training graphs, node for node
# ---------------------------------------------------------------------------


def _jcore(q, k, v):
    return q * jax.nn.sigmoid(k) + v


def _tcore(q, k, v):
    return q * torch.sigmoid(k) + v


def _pass2(mod, g):
    return mod.fuse_sublayer_chain(mod.fuse_shared_gather(
        mod.fuse_compute_aware(g)))


def _graphs(which):
    """(JAX graph, port graph), each made by its own package."""
    if which == "sublayer":
        return jdf.sublayer_graph(), df.sublayer_graph()
    if which == "dual_sublayer":
        return jdf.dual_sublayer_graph(), df.dual_sublayer_graph()
    mb = {"period": 1, "period_mb2": 2, "period_mb4": 4}[which]
    gj = jtp.dense_period_graph([_jcore, _jcore], True, "silu")
    gt = tp.dense_period_graph([_tcore, _tcore], True, "silu")
    return (jtp.microbatch_period_graph(gj, mb),
            tp.microbatch_period_graph(gt, mb))


def _structure(g):
    return [(n.name, n.op, n.inputs, n.weights, n.outputs) for n in g.nodes]


GRAPHS = ["sublayer", "dual_sublayer", "period", "period_mb2", "period_mb4"]


@pytest.mark.parametrize("which", GRAPHS)
def test_training_graph_equals_repro(which):
    gj, gt = _graphs(which)
    tj = jdf.build_training_graph(_pass2(jdf, gj))
    tt = df.build_training_graph(_pass2(df, gt))
    assert _structure(tt.graph) == _structure(tj.graph)
    assert tt.graph.outputs == tj.graph.outputs
    assert (tt.grad_inputs, tt.dx, tt.dweights) == \
        (tj.grad_inputs, tj.dx, tj.dweights)
    oj, ot = jdf.optimize(tj.graph), df.optimize(tt.graph)
    assert _structure(ot) == _structure(oj)
    assert df.derived_weight_keys(ot) == jdf.derived_weight_keys(oj)
    # pass 3 pairs a backward node with a forward one once there are two
    # chains to pair
    cross = tp.cross_direction_pairs(gt, ot)
    assert bool(cross) == (which == "dual_sublayer"
                           or which.startswith("period_mb")), cross


# ---------------------------------------------------------------------------
# adjoints against jax.vjp of the unoptimized graph (reference path, f32)
# ---------------------------------------------------------------------------


def _rand(seed, *shape, scale=0.3, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + offset).astype(np.float32)


def _period_weights(seed, n_blocks=2, d=16, f=24):
    w, s = {}, seed
    for i in range(n_blocks):
        p = f"b{i}."
        w[p + "scale1"] = _rand(s, d, scale=0.1, offset=1.0)
        for j, kk in enumerate(("wq", "wk", "wv", "wo")):
            w[p + kk] = _rand(s + 1 + j, d, d, scale=0.1)
        w[p + "scale2"] = _rand(s + 5, d, scale=0.1, offset=1.0)
        w[p + "w_up"] = _rand(s + 6, d, f, scale=0.1)
        w[p + "w_gate"] = _rand(s + 7, d, f, scale=0.1)
        w[p + "w_down"] = _rand(s + 8, f, d, scale=0.1)
        s += 9
    return w


def _adjoint_case(which):
    """(JAX graph, port graph, numpy weights, numpy inputs, fused)."""
    d, f = 8, 12
    if which == "ag_gemm":
        mk = lambda m: m.Graph([m.Node("x", "input"),
                                m.Node("y", "ag_gemm", ("x",), ("w",))],
                               ("y",))
        return (mk(jdf), mk(df), {"w": _rand(0, d, f)},
                {"x": _rand(1, 2, 6, d)}, False)
    if which == "ag_gemm_multi":
        mk = lambda m: m.Graph(
            [m.Node("x", "input"),
             m.Node("qkv", "ag_gemm_multi", ("x",), ("wa", "wb"),
                    outputs=("ya", "yb"))], ("ya", "yb"))
        return (mk(jdf), mk(df), {"wa": _rand(2, d, f), "wb": _rand(3, d, f)},
                {"x": _rand(4, 2, 6, d)}, False)
    if which == "gemm_rs":
        mk = lambda m: m.Graph([m.Node("h", "input"),
                                m.Node("y", "gemm_rs", ("h",), ("w",))],
                               ("y",))
        return (mk(jdf), mk(df), {"w": _rand(5, f, d)},
                {"h": _rand(6, 2, 6, f)}, False)
    if which == "fused_seam":
        d, f = 10, 14
        return (jdf.sublayer_graph(), df.sublayer_graph(),
                {"w1": _rand(7, d, f), "scale": _rand(8, f, scale=0.1,
                                                      offset=1.0),
                 "w2": _rand(9, f, d)}, {"x": _rand(10, 2, 4, d)}, True)
    gj, gt = _graphs("period" if which == "dense_period" else "period_mb2")
    vals = ({"x": _rand(11, 2, 8, 16)} if which == "dense_period" else
            {"mb0.x": _rand(12, 1, 8, 16), "mb1.x": _rand(13, 1, 8, 16)})
    return gj, gt, _period_weights(20), vals, True


ADJOINTS = ["ag_gemm", "ag_gemm_multi", "gemm_rs", "fused_seam",
            "dense_period", "microbatch_chains"]


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("which", ADJOINTS)
def test_adjoint_matches_jax_vjp(which, optimize):
    gj, gt, w, vals, fused = _adjoint_case(which)
    names = sorted(vals)
    wj = {k: jnp.asarray(v) for k, v in w.items()}
    outs = jdf.execute(gj, {k: jnp.asarray(v) for k, v in vals.items()}, wj)
    gys = [np.cos(np.arange(o.size, dtype=np.float32)).reshape(o.shape) * 0.3
           for o in outs]
    _, pull = jax.vjp(lambda xs, ww: tuple(jdf.execute(
        gj, dict(zip(names, xs)), ww)),
        tuple(jnp.asarray(vals[k]) for k in names), wj)
    dxs, dw_ref = pull(tuple(jnp.asarray(g) for g in gys))
    dx_ref = dict(zip(names, dxs))

    g2 = _pass2(df, gt) if fused else gt
    tg = df.build_training_graph(g2)
    bwd = df.optimize(tg.graph) if optimize else tg.graph
    env = {k: torch.from_numpy(v) for k, v in vals.items()}
    env.update(zip(tg.grad_inputs, (torch.from_numpy(g) for g in gys)))
    wt = df.derived_weights(bwd, {k: torch.from_numpy(v)
                                  for k, v in w.items()})
    got = dict(zip(bwd.outputs, df.execute(bwd, env, wt)))
    for k, v in tg.dx.items():
        np.testing.assert_allclose(_np(got[v]), np.asarray(dx_ref[k]),
                                   atol=1e-5, err_msg=f"dx[{k}]")
    for k in w:
        dw = sum(got[v] for v in tg.dweights[k])
        np.testing.assert_allclose(_np(dw), np.asarray(dw_ref[k]),
                                   atol=1e-5, err_msg=f"dw[{k}]")


def test_derived_weights_are_views_equal_to_jax():
    d, f = 6, 8
    mk = lambda m: m.Graph([m.Node("x", "input"),
                            m.Node("qkv", "ag_gemm_multi", ("x",),
                                   ("wa", "wb"), outputs=("ya", "yb")),
                            m.Node("z", "gemm_rs", ("ya",), ("wc",))],
                           ("z", "yb"))
    tj = jdf.build_training_graph(mk(jdf))
    tt = df.build_training_graph(mk(df))
    keys = df.derived_weight_keys(tt.graph)
    assert keys == jdf.derived_weight_keys(tj.graph)
    assert set(keys) == {"wa+wb^T", "wc^T"}
    w = {"wa": _rand(0, d, f), "wb": _rand(1, d, f), "wc": _rand(2, f, d)}
    want = jdf.derived_weights(tj.graph, {k: jnp.asarray(v)
                                          for k, v in w.items()})
    wt = {k: torch.from_numpy(v) for k, v in w.items()}
    got = df.derived_weights(tt.graph, wt)
    for k in keys:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
        assert not got[k].is_contiguous() and got[k].T.is_contiguous()
    # the single transpose is a view of the shard itself
    assert got["wc^T"].data_ptr() == wt["wc"].data_ptr()
    assert df.derived_weight_shapes(tt.graph, {k: v.shape for k, v in
                                               w.items()})["wa+wb^T"] == \
        (2 * f, d)


def test_graph_backward_off_raises_on_a_ring():
    """TPConfig(graph_backward=False) on a ring needs autodiff through the
    ring collectives (JAX's fallback); the port raises before any of them
    runs, and only where autograd records."""
    from repro_torch.runtime import TPConfig
    from repro_torch.sharding import TPGroup

    cfg = get_arch("internlm2-1.8b").smoke()
    group = TPGroup(0, 2, "gloo")            # no collective is reached
    lm = LM(cfg, SMOKE, device="cpu", seed=None, group=group)
    tpc = tp.TPContext.from_config(
        TPConfig(mode="cais", graph_backward=False), group)
    x = torch.zeros(2, 8, cfg.d_model, requires_grad=True)
    with pytest.raises(NotImplementedError, match="A15"):
        tp.sp_period(tpc, x, [lm.blocks[0]], cfg, ("attn",))


def test_backward_vocabulary_raises_where_not_ported():
    # the expert all-to-all's adjoint is ported (A10): on one device a
    # bwd_a2a_ffn node whose fn brings no VJP of its own takes autograd's,
    # row by row, the weight grads summed over the rows
    g = df.Graph([df.Node("s", "input"), df.Node("d", "input"),
                  df.Node("y", "bwd_a2a_ffn", ("s", "d"), ("we",),
                          outputs=("ds", "dw"), fn=lambda c, w: c @ w)],
                 ("ds", "dw"))
    s_, d_, w_ = (torch.from_numpy(_rand(i, *shape)) for i, shape in
                  ((1, (2, 3, 4)), (2, (2, 3, 5)), (3, (4, 5))))
    ds, dw = df.execute(g, {"s": s_, "d": d_}, {"we": w_})
    np.testing.assert_allclose(_np(ds), _np(d_ @ w_.T), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(dw), _np(torch.einsum("rcs,rco->so",
                                                         s_, d_)),
                               rtol=1e-5, atol=1e-5)
    g_raw = df.Graph([df.Node("x", "input"),
                      df.Node("y", "allreduce", ("x",))], ("y",))
    assert not df.supports_backward(g_raw)
    with pytest.raises(df.GraphError, match="supports_backward"):
        df.build_training_graph(g_raw)
    # repro's vocabulary and one op more: expert_ar, the MoE of the
    # replicated layout (repro runs that MoE under GSPMD, with no graph)
    assert set(df.ADJOINTS) - set(jdf.ADJOINTS) == {"expert_ar"}
    assert set(jdf.ADJOINTS) <= set(df.ADJOINTS)
    assert all(df.ADJOINTS[k] == jdf.ADJOINTS[k] for k in jdf.ADJOINTS)


# ---------------------------------------------------------------------------
# LM gradients on a gloo ring against JAX's one-device gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_grads(arch):
    """(numpy params, loss, {port param name: grad}) of JAX's LM.loss at
    smoke size, f32, on one CPU device."""
    cfg = jax_get_arch(arch).smoke()
    model = jax_build_model(cfg, JAX_SMOKE)
    params = model.init(jax.random.key(0))
    toks = jnp.asarray(TOKENS)
    loss, grads = jax.value_and_grad(model.loss)(
        params, {"tokens": toks, "labels": toks})
    g = bridge.state_dict_from_jax(jax.tree.map(np.asarray, grads),
                                   get_arch(arch).smoke())
    return (jax.tree.map(np.asarray, params), float(loss),
            {k: v.numpy() for k, v in g.items()})


RING_RUNS = {2: [("internlm2-1.8b", m, mb) for m in ("barrier", "cais")
                 for mb in (1, 2)]}
# the perfsim planner's training step: it picks the split and pairs both
# directions itself
RING_RUNS[4] = RING_RUNS[2] + [("deepseek-7b", "cais", 2),
                               ("internlm2-1.8b", "cais", "auto", "perfsim")]
RING_CELLS = [(n, run) for n in (2, 4) for run in RING_RUNS[n]]
RING_IDS = [f"world{n}-" + "-".join(map(str, run)) for n, run in RING_CELLS]


@functools.lru_cache(maxsize=None)
def grad_ring(n):
    """Every run of ``RING_RUNS[n]`` on one spawn of ``n`` gloo ranks."""
    cases = {a: jax_grads(a)[0] for a in {r[0] for r in RING_RUNS[n]}}
    with tempfile.TemporaryDirectory() as root:
        return run_ranks(cells.grad_cells, n, cases, TOKENS, RING_RUNS[n],
                         _tree(5), root, ada_ring_case())


@pytest.mark.parametrize("n,run", RING_CELLS, ids=RING_IDS)
def test_ring_grads_match_jax(n, run):
    res = grad_ring(n)
    arch = run[0]
    _, loss, want = jax_grads(arch)
    cfg = get_arch(arch).smoke()
    losses = [r[run][0] for r in res]
    assert len(set(losses)) == 1
    assert abs(losses[0] - loss) <= 1e-5 * abs(loss)
    # world 4: 2 kv heads do not split over 4 ranks, so wk/wv replicate
    # and their grads take the period backward's all-reduce
    assert (param_shard_dim("blocks.0.mixer.wk", cfg, n) is None) == \
        (cfg.num_kv_heads % n != 0)
    for name, g_ref in want.items():
        dim = param_shard_dim(name, cfg, n)
        parts = [r[run][1][name] for r in res]
        got = parts[0] if dim is None else np.concatenate(parts, axis=dim)
        if dim is None:
            for p in parts[1:]:
                np.testing.assert_array_equal(p, parts[0])
        bound = GRAD_RTOL * max(1.0, float(np.abs(g_ref).max()))
        assert float(np.abs(got - g_ref).max()) <= bound, name


@pytest.mark.parametrize("n,run", RING_CELLS, ids=RING_IDS)
def test_ring_launch_counts_match_the_graphs(n, run):
    for r in grad_ring(n):
        (_, _, made, derived, fmade, fderived, asym, pairs, cross, _,
         mb) = r[run]
        assert made == derived > 0
        assert fmade == fderived > 0
        assert asym == pairs
        if run[3:] == ("perfsim",):
            assert mb in (1, 2)     # its own choice; its pairs are checked
        else:                       # by asym == pairs, from its plans
            assert (cross > 0) == (run[2] == 2), (cross, run)


@pytest.mark.parametrize("n,run", RING_CELLS, ids=RING_IDS)
def test_train_matmul_shapes_cover_the_backward(n, run):
    """chip_smoke.py's arithmetic of the backward's transposed matmul calls
    (phase 3 checks those shapes, phase 9 asserts its calls are among them)
    holds every call a ring makes, at smoke size."""
    cfg = get_arch(run[0]).smoke()
    want = {tuple(s) for s in CS.train_matmul_shapes(
        cfg, world=n, batch=TOKENS.shape[0], seq=TOKENS.shape[1],
        runs=[(run[1], run[2], "float32") + run[3:]])}
    for r in grad_ring(n):
        got = {tuple(s) for s in r[run][9]}
        assert got and got <= want, sorted(got - want)
        assert {s[3] for s in got} == {"nt", "tn"}


# ---------------------------------------------------------------------------
# optimizer, schedules, clip
# ---------------------------------------------------------------------------


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((8, 6)) * scale).astype(np.float32),
            "b": (rng.standard_normal((7,)) * scale).astype(np.float32),
            "c": (rng.standard_normal((3, 4, 4)) * scale).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("step", [0, 5])
def test_adamw_matches_jax(step):
    params, grads = _tree(0), _tree(1, scale=0.7)
    m, v = _tree(2, 0.1), {k: np.abs(x) for k, x in _tree(3, 0.01).items()}
    sched_j, sched_t = (jopt.cosine_schedule(1e-2, 3, 10),
                        opt.cosine_schedule(1e-2, 3, 10))
    pj, sj = jopt.adamw(sched_j).apply(
        {k: jnp.asarray(x) for k, x in params.items()},
        {k: jnp.asarray(x) for k, x in grads.items()},
        {"m": {k: jnp.asarray(x) for k, x in m.items()},
         "v": {k: jnp.asarray(x) for k, x in v.items()}}, jnp.int32(step))
    tparams = _t(params)
    pt, st = opt.adamw(sched_t).apply(tparams, _t(grads),
                                      {"m": _t(m), "v": _t(v)}, step)
    assert all(pt[k] is tparams[k] for k in params)     # in place
    for k in params:
        np.testing.assert_allclose(_np(pt[k]), np.asarray(pj[k]), atol=1e-6)
        np.testing.assert_allclose(_np(st["m"][k]), np.asarray(sj["m"][k]),
                                   atol=1e-6)
        np.testing.assert_allclose(_np(st["v"][k]), np.asarray(sj["v"][k]),
                                   atol=1e-6)


def test_norm_clip_and_schedules_match_jax():
    g = _tree(4, scale=2.0)
    gj = {k: jnp.asarray(x) for k, x in g.items()}
    np.testing.assert_allclose(float(opt.global_norm(_t(g))),
                               float(jopt.global_norm(gj)), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        ct, nt = opt.clip_by_global_norm(_t(g), max_norm)
        cj, nj = jopt.clip_by_global_norm(gj, max_norm)
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(_np(ct[k]), np.asarray(cj[k]),
                                       rtol=1e-6, atol=1e-7)
    for mk in ((lambda m: m.cosine_schedule(3e-4, 20, 100)),
               (lambda m: m.cosine_schedule(1e-3, 0, 5, floor=0.0)),
               (lambda m: m.constant_schedule(1e-3))):
        for step in (0, 1, 10, 20, 60, 100, 150):
            np.testing.assert_allclose(
                float(mk(opt)(step)), float(mk(jopt)(jnp.int32(step))),
                rtol=1e-6, atol=1e-12)
    ada = opt.make_optimizer("adafactor", opt.constant_schedule(1.0))
    assert ada.name == "adafactor" and ada.placement is not None
    with pytest.raises(ValueError):
        opt.make_optimizer("lion", opt.constant_schedule(1.0))


@pytest.mark.parametrize("world", [2, 4])
def test_global_norm_on_a_ring_counts_each_element_once(world):
    want = float(jopt.global_norm({k: jnp.asarray(x)
                                   for k, x in _tree(5).items()}))
    got = [r["norm"] for r in grad_ring(world)]
    assert len(set(got)) == 1
    np.testing.assert_allclose(got[0], want, rtol=1e-6)


# ---------------------------------------------------------------------------
# Adafactor against JAX's, per JAX leaf
# ---------------------------------------------------------------------------


ADA_LR = 1e-2
ADA_SLABS = (1, opt.APPLY_CHUNK)       # streamed one row a slab, and whole
ADA_SCALES = (0.01, 10.0, 0.3)         # three steps' grad scales


def _stacked_to_port(tree, stacked):
    """A JAX tree of leaves -> (the port's params {name: array}, their
    leaves {name: (leaf, index)}): a stacked leaf is one parameter a
    layer."""
    out, leaves = {}, {}
    for k, a in tree.items():
        if k in stacked:
            for i in range(a.shape[0]):
                out[f"{k}.{i}"], leaves[f"{k}.{i}"] = np.array(a[i]), (k, i)
        else:
            out[k], leaves[k] = np.array(a), (k, None)
    return out, leaves


def _jax_adafactor(tree, grads, leaf_opt=None):
    """JAX's Adafactor over ``len(grads)`` steps: the final params."""
    o = jopt.adafactor(jopt.constant_schedule(ADA_LR))
    p = jax.tree.map(jnp.asarray, tree)
    st = o.init(p)
    for step, g in enumerate(grads):
        p, st = o.apply(p, jax.tree.map(jnp.asarray, g), st, jnp.int32(step))
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, st)


def _ada_close(got, want):
    """Within 1e-6 of the tensor's scale (a rounding of p - lr·u)."""
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


# 1-D to 4-D leaves; "s2"/"s3"/"sv" are stacks of two layers (a stacked
# vector is factored: its vc averages over the layers)
ADA_SHAPES = {"v": (5,), "m": (6, 7), "e": (3, 4, 5), "q": (2, 3, 4, 5),
              "sv": (2, 8), "s2": (2, 6, 7), "s3": (2, 3, 4, 5)}


@functools.lru_cache(maxsize=None)
def ada_tree_case():
    rng = np.random.default_rng(30)
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in ADA_SHAPES.items()}
    grads = [{k: (sc * rng.standard_normal(s)).astype(np.float32)
              for k, s in ADA_SHAPES.items()} for sc in ADA_SCALES]
    return tree, grads, _jax_adafactor(tree, grads)


@pytest.mark.parametrize("slab", ADA_SLABS)
def test_adafactor_matches_jax(slab):
    tree, grads, (want, jstate) = ada_tree_case()
    stacked = ("sv", "s2", "s3")
    params, lv = _stacked_to_port(tree, stacked)
    leaves = {k: opt.Leaf(*v) for k, v in lv.items()}
    o = opt.make_optimizer("adafactor", opt.constant_schedule(ADA_LR),
                           slab=slab)
    tp_ = _t(params)
    state = o.init(tp_, leaves=leaves)
    for step, g in enumerate(grads):
        got, state = o.apply(tp_, _t(_stacked_to_port(g, stacked)[0]), state,
                             step, leaves=leaves)
        assert all(got[k] is tp_[k] for k in tp_)      # in place
    ref, _ = _stacked_to_port(want, stacked)
    for k in ref:
        _ada_close(_np(tp_[k]), ref[k])
    # JAX's stacked state shapes: a stack of vectors keeps vr (2,), vc (8,)
    assert set(state) == set(jstate)
    for k in jstate:
        assert set(state[k]) == set(jstate[k])
        for s_ in jstate[k]:
            assert tuple(state[k][s_].shape) == jstate[k][s_].shape
            np.testing.assert_allclose(_np(state[k][s_]), jstate[k][s_],
                                       rtol=1e-5)
    assert tuple(state["sv"]["vr"].shape) == (2,)


ADA_MODELS = [("internlm2-1.8b", 2), ("gemma3-1b", 7), ("whisper-tiny", 2),
              ("paligemma-3b", 2)]


@pytest.mark.parametrize("slab", ADA_SLABS)
@pytest.mark.parametrize("arch,layers", ADA_MODELS)
def test_adafactor_on_a_model_matches_jax(arch, layers, slab):
    """A model's parameters grouped by ``opt_leaves()``: a 2-period stack
    (internlm2-1.8b, whose stacked norm scales the grouping changes), one
    period and a ``rem`` layer (gemma3-1b at 7 layers of its 6-layer
    pattern), the enc-dec stacks and the VLM's ``vision_proj``."""
    from repro_torch.models import build_model

    jc = jax_get_arch(arch).smoke().scaled(num_layers=layers)
    tc = get_arch(arch).smoke().scaled(num_layers=layers)
    tree = jax.tree.map(np.asarray, jax_build_model(jc, JAX_SMOKE).init(
        jax.random.key(3)))
    rng = np.random.default_rng(31)
    grads = [jax.tree.map(lambda a, sc=sc: (sc * rng.standard_normal(
        a.shape)).astype(np.float32), tree) for sc in ADA_SCALES]
    want, _ = _jax_adafactor(tree, grads)
    model = build_model(tc, SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(model, tree)
    leaves = model.opt_leaves()
    assert len({lf.name for lf in leaves.values()}) == \
        len(jax.tree.leaves(tree))
    o = opt.adafactor(opt.constant_schedule(ADA_LR), slab=slab)
    params = dict(model.named_parameters())
    state = o.init(params, leaves=leaves)
    for step, g in enumerate(grads):
        o.apply(params, bridge.state_dict_from_jax(g, tc), state, step,
                leaves=leaves)
    ref = bridge.state_dict_from_jax(want, tc)
    for k, p in params.items():
        _ada_close(_np(p), ref[k].numpy())


# per-layer shapes of a ring case: (JAX leaf shape, stacked, shard dim of
# the layer's tensor); n = 2 and 4 divide every split dimension
ADA_RING = {"col": ((2, 8, 12), True, 1), "row": ((2, 12, 8), True, 0),
            "exp": ((2, 4, 6, 8), True, 0), "expc": ((4, 6, 8), False, 2),
            "expr": ((4, 8, 6), False, 1), "vec": ((2, 8), True, None),
            "svec": ((2, 12), True, 0), "b": ((12,), False, 0),
            "emb": ((12, 8), False, None)}


@functools.lru_cache(maxsize=None)
def ada_ring_case():
    rng = np.random.default_rng(32)
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, (s, _, _) in ADA_RING.items()}
    grads = [{k: (sc * rng.standard_normal(a.shape)).astype(np.float32)
              for k, a in tree.items()} for sc in ADA_SCALES]
    stacked = [k for k, (_, st, _) in ADA_RING.items() if st]
    params, lv = _stacked_to_port(tree, stacked)
    leaves = {k: (leaf, i, ADA_RING[leaf][2]) for k, (leaf, i) in lv.items()}
    return dict(params=params, leaves=leaves, lr=ADA_LR, slabs=ADA_SLABS,
                grads=[_stacked_to_port(g, stacked)[0] for g in grads],
                _want=_stacked_to_port(_jax_adafactor(tree, grads)[0],
                                       stacked)[0])


@pytest.mark.parametrize("world", [2, 4])
def test_adafactor_on_a_ring_gives_each_shard_the_one_device_update(world):
    """Column-, row- and expert-split leaves (stacked and not, the sums
    that cross the split all-reduced) and whole ones: each rank's shard
    after three steps equals its slice of JAX's one-device update,
    streamed and not."""
    case = ada_ring_case()
    res = [r["adafactor"] for r in grad_ring(world)]
    for slab in ADA_SLABS:
        for name, want in case["_want"].items():
            dim = case["leaves"][name][2]
            parts = [r[slab][name] for r in res]
            got = parts[0] if dim is None else np.concatenate(parts, dim)
            _ada_close(got, want)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_converges_quadratic(name):
    """``tests/test_substrate.py::test_optimizer_converges_quadratic`` on
    the port: both optimizers drive a toy quadratic to its optimum."""
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3), "m": torch.zeros(4, 3)}
    o = opt.make_optimizer(name, opt.constant_schedule(5e-2),
                           weight_decay=0.0)
    state = o.init(params)

    def loss_fn(p):
        return torch.sum((p["w"] - target) ** 2) + torch.sum(p["m"] ** 2)

    for step in range(300):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(
            loss_fn(leaves), list(leaves.values()))))
        o.apply(params, grads, state, step)
    assert float(loss_fn(params)) < 1e-2, float(loss_fn(params))


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------


LR = 1e-3


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    arch = "deepseek-7b"
    jcfg, cfg = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    model = jax_build_model(jcfg, JAX_SMOKE)
    jopt_ = jopt.adamw(jopt.constant_schedule(LR))
    params = model.init(jax.random.key(0))
    jstate = {"params": params, "opt": jopt_.init(params),
              "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jax_make_train_step(model, jopt_, JAX_SMOKE,
                                        microbatches))
    lm = LM(cfg, SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(lm, jax.tree.map(np.asarray, params))
    topt = opt.adamw(opt.constant_schedule(LR))
    state = init_state(lm, topt)
    step = make_train_step(lm, topt, SMOKE, microbatches)
    shape = ShapeConfig("t", 32, 4, "train")
    near_zero = {}
    for s in range(2):
        batch = pipeline.make_batch(cfg, shape, s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * abs(float(jm["grad_norm"]))
        assert state["step"] == int(jstate["step"]) == s + 1
        for k, p in lm.named_parameters():
            g = np.abs(_np(p.grad))
            near = g <= GRAD_RTOL * max(1.0, float(g.max()))
            near_zero[k] = near_zero.get(k, near) | near
    # parameters after two steps: Adam's step is about lr·sign(g) where the
    # gradient is far from zero, so those elements agree to 1e-5; where a
    # gradient lies within its error of zero the sign may differ, and such
    # an element may differ by up to 2·lr a step
    want = {k: v.numpy() for k, v in bridge.state_dict_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), cfg).items()}
    at_bound = 0
    for k, p in lm.named_parameters():
        err = np.abs(_np(p) - want[k])
        limit = np.where(near_zero[k], 2 * 2 * LR, 1e-5)
        assert (err <= limit).all(), k
        at_bound += int((err > 1e-5).sum())
    assert at_bound <= 0.001 * sum(p.numel() for p in lm.parameters())


# ---------------------------------------------------------------------------
# data, configs, remat, launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_bit_equal(seed):
    jcfg, cfg = jax_get_arch("internlm2-1.8b"), get_arch("internlm2-1.8b")
    shape = ShapeConfig("t", 64, 3, "train")
    for step in (0, 1):
        want = jpipe.make_batch(jcfg, jpipe.ShapeConfig("t", 64, 3, "train"),
                                step, jpipe.DataConfig(seed))
        got = pipeline.make_batch(cfg, shape, step, pipeline.DataConfig(seed))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", PORTED)
def test_config_fields_equal_repro(arch):
    import dataclasses

    for smoke in (False, True):
        j, t = jax_get_arch(arch), get_arch(arch)
        if smoke:
            j, t = j.smoke(), t.smoke()
        jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        for name in set(jf) & set(tf):
            if name in ("mla", "moe", "ssm", "rglru", "encoder") and \
                    jf[name] is not None:
                assert dataclasses.asdict(jf[name]) == \
                    dataclasses.asdict(tf[name])
            else:
                assert tf[name] == jf[name], (arch, smoke, name)
        assert t.optimizer == ("adafactor" if arch == "arctic-480b"
                               else "adamw")
        assert t.param_count() == j.param_count()
        assert t.is_enc_dec == j.is_enc_dec
        # every field of repro's ArchConfig, the enc-dec and VLM families'
        # encoder, num_prefix_tokens and vision_width included
        assert set(jf) == set(tf)
    assert [dataclasses.astuple(s) for s in SHAPES] == \
        [dataclasses.astuple(s) for s in JAX_SHAPES]


def test_remat_on_and_off_give_equal_loss_and_grads():
    cfg = get_arch("deepseek-7b").smoke().scaled(
        num_layers=3, layer_pattern=("attn", "attn"), d_model=32,
        num_heads=4, num_kv_heads=4, head_dim=8, d_ff=48)
    assert cfg.num_layers % len(cfg.layer_pattern) != 0
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    out = {}
    for remat in (False, True):
        lm = LM(cfg, Runtime(compute_dtype="float32", remat=remat,
                             loss_chunk=16), device="cpu", seed=1)
        lm.requires_grad_(True)
        loss = lm.loss({"tokens": tok, "labels": tok})
        loss.backward()
        out[remat] = (float(loss.detach()),
                      {n: _np(p.grad) for n, p in lm.named_parameters()})
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for n, g in out[False][1].items():
        np.testing.assert_allclose(out[True][1][n], g, rtol=1e-6, atol=1e-7)


def _launch(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trainer = train_launch.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("step ")]
    return trainer, lines


def test_launcher_runs_three_steps():
    trainer, lines = _launch(["--arch", "deepseek-7b", "--smoke", "--device",
                              "cpu", "--steps", "3", "--tp-mode", "cais"])
    assert len(lines) == 3
    losses = [h["loss"] for h in trainer.history]
    assert all(math.isfinite(x) for x in losses)
    # the default cosine schedule warms up over 20 steps from lr 0, so these
    # steps barely move; with the warmup cut to one step the loss falls
    _, lines = _launch(["--arch", "deepseek-7b", "--smoke", "--device",
                        "cpu", "--steps", "3", "--lr", "1e-2", "--warmup",
                        "1"])
    falling = [float(ln.split()[3]) for ln in lines]
    assert falling[2] < falling[0]
    # --mesh debug (A14): 8 ranks on data 2 x model 4; rank 0's lines, and
    # its losses those of --mesh none (a replica's half of every batch, the
    # grads summed over the replicas)
    argv = ["--arch", "deepseek-7b", "--smoke", "--device", "cpu", "--steps",
            "2", "--tp-mode", "cais"]
    one, _ = _launch(argv)
    run, _ = _launch(argv + ["--mesh", "debug"])
    # and with no --tp-mode: the default auto, DTensor on each replica's
    # TP group
    auto, _ = _launch(argv[:-2] + ["--mesh", "debug"])
    for r in (run, auto):
        assert len(r.ranks) == 8 and len(r.history) == 2
        for h in r.ranks:
            for a, b in zip(h, one.history):
                assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
    with pytest.raises(NotImplementedError, match="hosts"):
        train_launch.main(["--arch", "deepseek-7b", "--smoke", "--device",
                           "cpu", "--mesh", "single"])
    # --ckpt-dir: the same command again resumes from the latest
    # checkpoint (step 2 of 3), bitwise the first run's step 2; more
    # --steps go on from there
    with tempfile.TemporaryDirectory() as d:
        ck = argv[:-2] + ["--steps", "3", "--ckpt-dir", d, "--ckpt-every",
                          "2"]
        first, _ = _launch(ck)
        again, lines = _launch(ck)
        assert any("restored step 2" in e for e in again.events)
        assert [h["step"] for h in again.history] == [2]
        assert again.history[0]["loss"] == first.history[2]["loss"]
        assert lines[0].startswith("step      2")
        more, _ = _launch(ck[:-4] + ["--steps", "4"] + ck[-4:])
        assert [h["step"] for h in more.history] == [2, 3]


def test_train_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launch.main(["--arch", "deepseek-7b", "--smoke", "--steps",
                           "1"])


# ---------------------------------------------------------------------------
# the matmul kernel's transposed layouts (CPU: its plain version)
# ---------------------------------------------------------------------------


MM_SHAPES = [(128, 128, 128), (256, 512, 128), (64, 384, 96), (32, 32, 32),
             (512, 128, 256), (128, 1024, 64)]
TOL = {"float32": dict(rtol=2e-5, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-1)}


@pytest.mark.parametrize("layout", ["tn", "nt", "tt"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", MM_SHAPES)
def test_transposed_matmul_matches_pallas(M, K, N, dtype, layout):
    rng = np.random.default_rng(M + K + N)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jops.matmul(jnp.asarray(a, jd), jnp.asarray(b, jd)),
                      np.float32)
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    at = torch.from_numpy(a).to(td)
    bt = torch.from_numpy(b).to(td)
    if layout[0] == "t":
        at = at.T.contiguous().T          # the same values, stored (K, M)
    if layout[1] == "t":
        bt = bt.T.contiguous().T
    assert mmk.layout(at, bt) == layout
    for fn in (ops.matmul, ref.matmul_ref):
        got = fn(at, bt)
        np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_matmul_refuses_other_strided_operands():
    a = torch.randn(8, 16)
    b = torch.randn(16, 12)
    for bad_a, bad_b in ((a[:, ::2], b[:8]), (a, b[:, :6]),
                         (a[::2], b), (a.unsqueeze(0), b)):
        with pytest.raises(ValueError, match="transpose of a contiguous"):
            ops.matmul(bad_a, bad_b)
    # a transposed view passes as it lies: no copy is made, and the kernel
    # reads its storage at the storage's row stride
    x = torch.randn(24, 8)
    ops.matmul(x.T, torch.randn(24, 5))
    assert mmk.layout(x.T, b) == "tn" and mmk.layout(a, b.T.T) == "nn"
    w = torch.randn(12, 16)                    # b = wᵀ, storage (N, K)
    assert mmk.row_strides(a, b) == ("nn", 16, 12)
    assert mmk.row_strides(torch.randn(16, 8).T, w.T) == ("tt", 8, 16)
