"""The port's meshes against the JAX package on the CPU: the hierarchical 2D
(``tp_in`` 2 x ``tp_out`` 2) mesh, the ``data`` 2 x ``model`` 2 mesh and a
``data`` axis of 4, all factored by ``repro_torch.sharding.init_mesh`` from
one gloo world of 4 ranks (one spawn; the rank bodies are
``tests/torch_topo_cells.py``, no JAX). The cells are those of
``tests/topo_checks.py`` and ``tests/multidev_checks.py``, held against JAX
on one CPU device (the JAX package's own 2D suite needs 8 virtual devices)
and against the port's flat ring of 4 (flat == 2D, the topo cells' rule):

* the rank layout (global rank ``d·tp + i_in·tp_out + i_out``, composite
  index ``i_in·tp_out + i_out``) and point-to-point on subgroups whose
  global ranks are not their group ranks;
* ``sweep.{ffn,attn,gqa}.{barrier,cais}.t2x2.S{8,24}`` (JAX's ``sp_ffn`` /
  ``sp_attention`` on one device 1e-5, the flat ring 1e-6), with the matmul
  calls equal to ``matmul_calls`` of the 2D graph;
* ``ragged.gemm_ar.{mode}.t2x2.S{1,3,5}`` against ``x @ w`` (1e-5);
* ``grouped_ep.moe.{mode}.t2x2`` (+ ``.aux``) against JAX's one-device MoE
  of the same groups, and ``grouped_ep.{dispatch,grad_dispatch}
  .tp_out_only``;
* ``topo2d.{dense,gqa,moe}.{barrier,cais}`` loss and train grads against
  ``jax.value_and_grad`` on one device (1e-5) and the flat ring (1e-6);
* ``model.dp.{barrier,cais}``: loss, grads and one AdamW step of the
  data 2 x model 2 mesh against JAX's one-device ``train_step``;
* ``compression.int8_close`` / ``.error_feedback_unbiased`` at data 4;
* the perfsim plans and cache keys of a 2D and a dp period against
  ``repro``'s ``_plan_period`` on the matching ``AbstractMesh``.

Single-process cells beside them: ``TPContext``'s ``topology``,
``route_ring`` and ``is_2d`` defaults and the inter-tier microbatch plan
against JAX's on the matching abstract meshes."""
import dataclasses
import functools
import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro import sharding as jsharding  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.core import tp as jtp  # noqa: E402
from repro.core.primitives import CAISConfig as JCAISConfig  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.hw import HWSpec as JHWSpec  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.layers import apply_norm as japply_norm  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.plan import cache as jcache  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa

import torch_topo_cells as cells  # noqa: E402
from repro_torch import bridge, hw  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.sharding import CompositeGroup, TPGroup  # noqa: E402

WORLD = 4
TP_IN, TP_OUT = 2, 2
CAIS = JCAISConfig(num_chunks=2)
GRAD_RTOL = 1e-5          # per tensor: max|Δ| <= 1e-5 * max(1, max|g|)
STEP_LR = 1e-3
MODES = ("barrier", "cais")


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, *shape, scale=0.1):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(arch, **over):
    """(JAX cfg, port cfg) of ``arch``'s smoke config scaled by ``over`` (a
    ``moe`` entry is a dict of MoEConfig fields to replace)."""
    moe = over.pop("moe", None)
    j = jax_get_arch(arch).smoke().scaled(**over)
    t = get_arch(arch).smoke().scaled(**over)
    if moe:
        j = j.scaled(moe=dataclasses.replace(j.moe, **moe))
        t = t.scaled(moe=dataclasses.replace(t.moe, **moe))
    return j, t


# ---------------------------------------------------------------------------
# the cases (numpy, made here) and JAX's one-device references
# ---------------------------------------------------------------------------

D, D_FF = 32, 48
SWEEP_S = (8, 24)
RAGGED_S = (1, 3, 5)


@functools.lru_cache(maxsize=None)
def sweep_case():
    jc, tc = _both("deepseek-7b", num_layers=1, d_model=D, num_heads=8,
                   num_kv_heads=8, head_dim=8, d_ff=D_FF)
    jg, tg = jc.scaled(num_kv_heads=2), tc.scaled(num_kv_heads=2)
    dh = jc.resolved_head_dim
    ns = (_normal(0, D) + 1.0).astype(np.float32)
    ffn = {"scale": ns, "w_up": _normal(1, D, D_FF),
           "w_gate": _normal(2, D, D_FF), "w_down": _normal(3, D_FF, D)}
    hd = jc.num_heads * dh
    attn = {"scale": ns, "wq": _normal(4, D, hd), "wk": _normal(5, D, hd),
            "wv": _normal(6, D, hd), "wo": _normal(7, hd, D)}
    gqa = dict(attn, wk=_normal(8, D, 2 * dh), wv=_normal(9, D, 2 * dh))
    xs = {S: _normal(100 + S, 2, S, D, scale=1.0) for S in SWEEP_S}
    return dict(jcfg=jc, jcfg_gqa=jg, cfg=tc, cfg_gqa=tg, x=xs,
                w={"ffn": ffn, "attn": attn, "gqa": gqa})


@functools.lru_cache(maxsize=None)
def jax_sweep(kind, S):
    """JAX's ``sp_ffn`` / ``sp_attention`` on one device."""
    c = sweep_case()
    tpc = jtp.TPContext(mesh=jsharding.make_mesh((1, 1), ("data", "model")),
                        backend="cais", cais=CAIS)
    w = {k: jnp.asarray(v) for k, v in c["w"][kind].items()}
    x = jnp.asarray(c["x"][S])
    if kind == "ffn":
        fn = lambda x, w: jtp.sp_ffn(tpc, x, w["scale"], w["w_up"],  # noqa
                                     w["w_gate"], w["w_down"], "silu")
    else:
        cfg = c["jcfg_gqa"] if kind == "gqa" else c["jcfg"]
        fn = lambda x, w: jtp.sp_attention(  # noqa: E731
            tpc, x, w["scale"], w["wq"], w["wk"], w["wv"], w["wo"], cfg)
    return np.asarray(jax.jit(fn)(x, w))


@functools.lru_cache(maxsize=None)
def ragged_case():
    return {"w": _normal(10, D, D),
            "x": {S: _normal(200 + S, 2, S, D, scale=1.0)
                  for S in RAGGED_S}}


@functools.lru_cache(maxsize=None)
def grouped_ep_case():
    """mixtral-8x7b's smoke MoE (E = 4) at capacity factor 8, x (1, 64, d):
    a rank's sequence shard of 16 is one device's routing group of 16, so
    the two route the same groups; and an MoE LM (tokens (1, 64)) for the
    dispatch recording."""
    jc, tc = _both("mixtral-8x7b", num_layers=1, d_model=D, num_heads=4,
                   num_kv_heads=4, head_dim=8, d_ff=D_FF, window=16,
                   moe={"capacity_factor": 8.0})
    tree = jax.tree.map(np.asarray, jtr.init_block(jax.random.key(4), "attn",
                                                   jc, jnp.float32))
    tree["norm2"]["scale"] = (_normal(11, D) + 1.0).astype(np.float32)
    x = _normal(12, 1, 64, D, scale=1.0)
    jl, tl = _both("mixtral-8x7b")
    params = jax.tree.map(np.asarray, jax_build_model(jl, JAX_SMOKE).init(
        jax.random.key(0)))
    toks = _rng(13).integers(0, tl.vocab_size, (1, 64)).astype(np.int32)
    return jc, tc, tree, x, (tl, params, toks)


@functools.lru_cache(maxsize=None)
def jax_grouped_ep():
    jc, _, tree, x, _ = grouped_ep_case()
    xn = japply_norm(jc.norm, {"scale": jnp.asarray(tree["norm2"]["scale"])},
                     jnp.asarray(x))
    y, aux = jax.jit(lambda p, v: jffn.moe_forward(p, v, jc))(
        jax.tree.map(jnp.asarray, tree["ffn"]), xn)
    return np.asarray(y), float(aux)


LM_LABELS = ("dense", "gqa", "moe")


@functools.lru_cache(maxsize=None)
def lm_case(label):
    """(JAX cfg, port cfg, numpy params, tokens): topo_checks' full-model
    configs. The MoE at E = 8 shards on the flat ring (2 a rank) and
    grouped on the 2D mesh (4 a rank); its tokens (1, 64) give each of the
    4 ranks one device's routing group of 16 (capacity factor 8: no
    drops)."""
    if label == "moe":
        jc, tc = _both("mixtral-8x7b", num_layers=2, d_model=64, num_heads=8,
                       num_kv_heads=8, head_dim=16, d_ff=64, window=16,
                       moe={"num_experts": 8, "capacity_factor": 8.0})
        shape = (1, 64)
    else:
        jc, tc = _both("deepseek-7b", num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=4 if label == "dense" else 2,
                       head_dim=16, d_ff=128)
        shape = (2, 32)
    params = jax.tree.map(np.asarray, jax_build_model(jc, JAX_SMOKE).init(
        jax.random.key(0)))
    toks = _rng(7).integers(0, tc.vocab_size, shape).astype(np.int32)
    return jc, tc, params, toks


@functools.lru_cache(maxsize=None)
def jax_lm(label):
    """JAX's one-device (loss, {port param: grad})."""
    jc, tc, params, toks = lm_case(label)
    t = jnp.asarray(toks)
    loss, grads = jax.jit(jax.value_and_grad(
        jax_build_model(jc, JAX_SMOKE).loss))(params,
                                              {"tokens": t, "labels": t})
    g = bridge.state_dict_from_jax(jax.tree.map(np.asarray, grads), tc)
    return float(loss), {k: v.numpy() for k, v in g.items()}


@functools.lru_cache(maxsize=None)
def dp_case():
    jc, tc = _both("deepseek-7b")
    params = jax.tree.map(np.asarray, jax_build_model(jc, JAX_SMOKE).init(
        jax.random.key(0)))
    batch = jpipe.make_batch(jc, JShapeConfig("t", 32, 4, "train"), 0)
    return jc, tc, params, batch


@functools.lru_cache(maxsize=None)
def jax_dp():
    """JAX's one-device train step of ``dp_case``: (loss, grad norm,
    {param: grad}, {param: updated value})."""
    jc, tc, params, batch = dp_case()
    model = jax_build_model(jc, JAX_SMOKE)
    o = jopt.adamw(jopt.constant_schedule(STEP_LR))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    _, grads = jax.jit(jax.value_and_grad(model.loss))(params, b)
    state = {"params": params, "opt": o.init(params),
             "step": jnp.zeros((), jnp.int32)}
    state, m = jax.jit(jax_make_train_step(model, o, JAX_SMOKE))(state, b)
    sd = lambda tree: {k: v.numpy() for k, v in bridge.state_dict_from_jax(
        jax.tree.map(np.asarray, tree), tc).items()}
    return (float(m["loss"]), float(m["grad_norm"]), sd(grads),
            sd(state["params"]))


def compression_case():
    return (_rng(14).standard_normal((WORLD, 64)).astype(np.float32)
            * np.linspace(0.1, 3.0, WORLD, dtype=np.float32)[:, None])


PLAN_ARCH = "internlm2-1.8b"
PLAN_KINDS = ("attn", "attn")


@functools.lru_cache(maxsize=None)
def plan_case():
    cfg = jax_get_arch(PLAN_ARCH).smoke()
    trees = [jax.tree.map(np.asarray, jtr.init_block(
        jax.random.key(60 + j), "attn", cfg, jnp.float32)) for j in range(2)]
    x = _normal(61, 4, 16, cfg.d_model, scale=1.0)
    return dict(arch=PLAN_ARCH, trees=trees, x=x, kinds=PLAN_KINDS)


JAX_MESHES = {"2d": ((1, TP_IN, TP_OUT), ("data", "tp_in", "tp_out")),
              "dp": ((2, 2), ("data", "model"))}


def _h100():
    return JHWSpec(**dataclasses.asdict(hw.H100))


def jax_plans(mname, root) -> dict:
    """{cache key: plan} of ``repro``'s ``_plan_period`` for the plan
    cells' period on the abstract mesh ``mname``, both backends, at 2
    microbatches and ``"auto"``."""
    c = plan_case()
    cfg = jax_get_arch(PLAN_ARCH).smoke()
    mesh = AbstractMesh(*JAX_MESHES[mname])
    saved = jcache._DEFAULT
    jcache._DEFAULT = jplan.PlanCache(root=str(root))
    try:
        for mode in MODES:
            tpc = jtp.TPContext(mesh=mesh, backend=mode, cais=CAIS,
                                planner="perfsim", hw=_h100())
            base, weights, _, _ = jtp._period_graph(tpc, c["trees"], cfg,
                                                    PLAN_KINDS)
            x = jax.ShapeDtypeStruct(c["x"].shape, jnp.float32)
            b_loc = c["x"].shape[0] // jsharding.dp_size(mesh)
            hints = jtp._core_comp_hints(cfg, PLAN_KINDS, b_loc,
                                         c["x"].shape[1])
            for mb in (2, "auto"):
                jtp._plan_period(tpc, base, weights, x, mb, moe=False,
                                 comp_hints=hints)
    finally:
        jcache._DEFAULT = saved
    out = {}
    for f in sorted(root.iterdir()):
        if f.suffix == ".json":
            out[f.stem] = json.loads(f.read_text())
    return out


# ---------------------------------------------------------------------------
# the one spawn
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _spawn():
    """Start the one spawn in a thread, so that the ranks run while the
    JAX references compute; returns its future."""
    from concurrent.futures import ThreadPoolExecutor

    sw = sweep_case()
    jc, tc, tree, x, lm = grouped_ep_case()
    _, dtc, dparams, batch = dp_case()
    data = {
        "sweep": dict(cfg=sw["cfg"], cfg_gqa=sw["cfg_gqa"], x=sw["x"],
                      w=sw["w"]),
        "ragged": ragged_case(),
        "grouped_ep": dict(cfg=tc, tree=tree, x=x, lm=lm),
        "lm": {lb: lm_case(lb)[1:] for lb in LM_LABELS},
        "dp": (dtc, dparams, batch, STEP_LR),
        "compression": compression_case(),
        "plans": plan_case(),
    }

    def run():
        with tempfile.TemporaryDirectory() as root:
            return run_ranks(cells.topo_cells, WORLD, data, root)

    pool = ThreadPoolExecutor(1)
    future = pool.submit(run)
    pool.shutdown(wait=False)
    return future


@pytest.fixture(scope="module", autouse=True)
def _start_spawn():
    """Start the spawn with the module's first test, then compute the JAX
    references while the ranks run."""
    _spawn()
    for kind in ("ffn", "attn", "gqa"):
        for S in SWEEP_S:
            jax_sweep(kind, S)
    jax_grouped_ep()
    for label in LM_LABELS:
        jax_lm(label)
    jax_dp()


def ranks():
    """What every rank of the spawn returned, in world order."""
    return _spawn().result()


def _concat_seq(kind_of, order):
    """The shards of the ranks in ``order`` concatenated on dim 1."""
    return np.concatenate([kind_of(r) for r in order], axis=1)


def _composite_order(res):
    """World ranks in composite-index order on the 2D mesh."""
    idx = {r["layout"]["2d"]["tp"][0]: w for w, r in enumerate(res)}
    return [idx[c] for c in range(WORLD)]


def test_no_rank_imports_jax():
    assert not any(r["_jax_imported"] for r in ranks())


# ---------------------------------------------------------------------------
# layout and subgroup point-to-point
# ---------------------------------------------------------------------------


def test_mesh_rank_layout_is_jax_s():
    res = ranks()
    for w, r in enumerate(res):
        lay = r["layout"]
        # 2D, dp 1: global = i_in·tp_out + i_out, composite index = global
        i_in, i_out = lay["2d"]["tp_in"][0], lay["2d"]["tp_out"][0]
        assert w == i_in * TP_OUT + i_out
        assert lay["2d"]["tp"] == (w, tuple(range(WORLD)))
        assert lay["2d"]["tp_in"][1] == tuple(
            i * TP_OUT + i_out for i in range(TP_IN))
        assert lay["2d"]["tp_out"][1] == tuple(
            i_in * TP_OUT + o for o in range(TP_OUT))
        assert lay["2d"]["data"] == (0, (w,)) and lay["2d"]["is_2d"]
        # data 2 x model 2: global = d·tp + m
        d, m = lay["dp"]["data"][0], lay["dp"]["tp"][0]
        assert w == d * 2 + m and not lay["dp"]["is_2d"]
        assert lay["dp"]["data"][1] == (m, 2 + m)
        assert lay["dp"]["tp"][1] == (2 * d, 2 * d + 1)
        assert lay["d4"]["data"] == (w, tuple(range(WORLD)))
        assert lay["d4"]["tp"] == (0, (w,))
        assert lay["flat"]["tp"] == (w, tuple(range(WORLD)))
        assert lay["flat"]["data"] == (0, (w,))


def test_subgroup_ppermute_reaches_global_peers():
    """One hop around each tp_in ring ({0, 2}, {1, 3}) and tp_out ring
    ({0, 1}, {2, 3}): the peers are global ranks, not group ranks."""
    for w, r in enumerate(ranks()):
        i_in, i_out = divmod(w, TP_OUT)
        prev_in = ((i_in - 1) % TP_IN) * TP_OUT + i_out
        prev_out = i_in * TP_OUT + (i_out - 1) % TP_OUT
        assert r["layout"]["ppermute.tp_in"] == prev_in
        assert r["layout"]["ppermute.tp_out"] == prev_out


# ---------------------------------------------------------------------------
# sweep and ragged
# ---------------------------------------------------------------------------

SWEEP = [(k, m, S) for k in ("ffn", "attn", "gqa") for m in MODES
         for S in SWEEP_S]


@pytest.mark.parametrize("kind,mode,S", SWEEP,
                         ids=[f"{k}.{m}.t2x2.S{S}" for k, m, S in SWEEP])
def test_sweep_2d_matches_flat_and_jax(kind, mode, S):
    res = ranks()
    two = _concat_seq(lambda r: res[r]["sweep"][("2d", kind, mode, S)][0],
                      _composite_order(res))
    flat = _concat_seq(lambda r: res[r]["sweep"][("flat", kind, mode, S)][0],
                       range(WORLD))
    assert float(np.abs(two - flat).max()) <= 1e-6
    np.testing.assert_allclose(two, jax_sweep(kind, S), rtol=0, atol=1e-5)
    for r in res:
        made, derived = r["sweep"][("2d", kind, mode, S)][1:]
        assert made == derived > 0


RAGGED = [(m, S) for m in MODES for S in RAGGED_S]


@pytest.mark.parametrize("mode,S", RAGGED,
                         ids=[f"{m}.t2x2.S{S}" for m, S in RAGGED])
def test_ragged_gemm_ar_2d(mode, S):
    c = ragged_case()
    want = c["x"][S] @ c["w"]
    for r in ranks():
        got = r["ragged"][(mode, S)]
        assert float(np.abs(got - want).max()) <= 1e-5


# ---------------------------------------------------------------------------
# grouped EP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_grouped_ep_moe_matches_jax(mode):
    """``grouped_ep.moe.{mode}.t2x2`` (1e-5) and ``.aux`` (1e-6): E = 4
    experts, 2 a rank over tp_out, replicated across tp_in."""
    res = ranks()
    want, want_aux = jax_grouped_ep()
    got = _concat_seq(lambda r: res[r]["grouped_ep"][mode][0],
                      _composite_order(res))
    assert float(np.abs(got - want).max()) <= 1e-5
    auxes = {r["grouped_ep"][mode][1] for r in res}
    assert len(auxes) == 1
    assert abs(auxes.pop() - want_aux) <= 1e-6


def test_grouped_ep_dispatch_is_tp_out_only():
    """``grouped_ep.dispatch.tp_out_only`` and
    ``grouped_ep.grad_dispatch.tp_out_only``: every concrete expert
    all-to-all and adjoint (past the composite group's dispatch) names the
    tp_out ring."""
    for r in ranks():
        seen = r["grouped_ep"]["dispatch"]
        concrete = [(k, g) for k, g in seen if g != "composite"]
        assert {k for k, _ in concrete} == {"a2a", "grad"}
        assert all(g == "tp_out" for _, g in concrete), seen


# ---------------------------------------------------------------------------
# the model on the 2D mesh
# ---------------------------------------------------------------------------


def _assemble(parts):
    """The whole tensor from every rank's (shard, placement)."""
    shard, place = parts[0]
    if place is None:
        for s, p in parts[1:]:
            np.testing.assert_array_equal(s, shard)
        return shard
    dim, n, _ = place
    by = {}
    for s, p in parts:
        if p[2] in by:
            np.testing.assert_array_equal(s, by[p[2]])
        by[p[2]] = s
    assert sorted(by) == list(range(n))
    return np.concatenate([by[i] for i in range(n)], axis=dim)


TOPO2D = [(lb, m) for lb in LM_LABELS for m in MODES]


@pytest.mark.parametrize("label,mode", TOPO2D,
                         ids=[f"{lb}.{m}" for lb, m in TOPO2D])
def test_topo2d_loss_and_grads(label, mode):
    """``topo2d.{label}.{mode}``: loss and train grads on the 2D mesh
    against JAX's one-device ``value_and_grad`` (1e-5) and the flat ring of
    4 (1e-6); the matmul calls equal the 2D graphs'."""
    res = ranks()
    want_loss, want = jax_lm(label)
    runs = {mn: [r["lm"][(label, mn, mode)] for r in res]
            for mn in ("flat", "2d")}
    losses = {mn: {r[0] for r in rs} for mn, rs in runs.items()}
    assert all(len(v) == 1 for v in losses.values())
    l2, lf = losses["2d"].pop(), losses["flat"].pop()
    assert abs(l2 - lf) <= 1e-6
    assert abs(l2 - want_loss) <= 1e-5 * abs(want_loss)
    for name, g_ref in want.items():
        got = {mn: _assemble([r[1][name] for r in rs])
               for mn, rs in runs.items()}
        bound = GRAD_RTOL * max(1.0, float(np.abs(g_ref).max()))
        assert float(np.abs(got["2d"] - g_ref).max()) <= bound, name
        assert float(np.abs(got["2d"] - got["flat"]).max()) <= \
            1e-6 * max(1.0, float(np.abs(g_ref).max())), name
    for r in runs["2d"]:
        assert r[2] == r[3] > 0


# ---------------------------------------------------------------------------
# data parallelism and gradient compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_dp_train_step_matches_jax(mode):
    """``model.dp.{mode}``: one AdamW step on the data 2 x model 2 mesh
    against JAX's one-device train step: loss and grad norm (1e-5), every
    grad (1e-5 of its max), every parameter (1e-5, or 2·lr where the
    gradient lies within its bound of zero, where Adam's sign may
    differ)."""
    loss, gnorm, grads, params = jax_dp()
    res = [r["dp"][mode] for r in ranks()]
    assert len({r[0] for r in res}) == 1 and len({r[1] for r in res}) == 1
    assert abs(res[0][0] - loss) <= 1e-5 * abs(loss)
    assert abs(res[0][1] - gnorm) <= 1e-5 * abs(gnorm)
    for name, g_ref in grads.items():
        g = _assemble([(r[2][name][0], r[2][name][2]) for r in res])
        bound = GRAD_RTOL * max(1.0, float(np.abs(g_ref).max()))
        assert float(np.abs(g - g_ref).max()) <= bound, name
        p = _assemble([(r[2][name][1], r[2][name][2]) for r in res])
        near = np.abs(g_ref) <= bound
        limit = np.where(near, 2 * STEP_LR, 1e-5)
        assert (np.abs(p - params[name]) <= limit).all(), name


def test_compression_at_data_4():
    """``compression.int8_close`` (0.05) and
    ``compression.error_feedback_unbiased`` (0.01), relative to the exact
    mean's max, on every replica; and the 4x wire headline."""
    local = compression_case()
    exact = local.mean(axis=0)
    scale = float(np.abs(exact).max()) + 1e-9
    res = [r["compression"] for r in ranks()]
    for red, mean_ef, wire in res:
        np.testing.assert_array_equal(red, res[0][0])
        assert float(np.abs(red - exact).max()) / scale <= 0.05
        assert float(np.abs(mean_ef - exact).max()) / scale <= 0.01
        assert wire == (64 * 4, 64)


# ---------------------------------------------------------------------------
# plans, topology defaults, the inter-tier microbatch plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mname", sorted(JAX_MESHES))
def test_plans_and_keys_match_jax(mname, tmp_path):
    want = jax_plans(mname, tmp_path)
    got = [{k: json.loads(v) for k, v in r["plans"][mname].items()}
           for r in ranks()]
    assert got[0].keys() == want.keys() and want
    for k, w in want.items():
        g = got[0][k]
        for f in ("pairing", "num_chunks", "num_microbatches", "backend"):
            assert g[f] == w[f], (k, f)
        for f in ("makespan", "greedy_makespan"):
            assert abs(g[f] - w[f]) <= 1e-12 * abs(w[f])
    assert all(r == got[0] for r in got)


def _composite(i_in=0, i_out=0, tp_in=TP_IN, tp_out=TP_OUT):
    """A composite group object (no process group: nothing is sent)."""
    inner = TPGroup(i_in, tp_in, "gloo")
    outer = TPGroup(i_out, tp_out, "gloo")
    return CompositeGroup(i_in * tp_out + i_out, tp_in * tp_out, "gloo",
                          None, range(tp_in * tp_out), inner, outer)


@pytest.mark.parametrize("shape", [(1, 4, 1), (1, 2, 2), (1, 1, 4),
                                   (2, 2, 2)])
def test_topology_defaults_match_jax(shape):
    """``tp``, ``is_2d``, ``route_ring`` and ``topology`` of a 2D mesh and of
    the flat ring of the same TP degree (test_topology's defaults)."""
    dp, i, o = shape
    jm2 = AbstractMesh(shape, ("data", "tp_in", "tp_out"))
    jm1 = AbstractMesh((dp, i * o), ("data", "model"))
    for jm, group in ((jm2, _composite(tp_in=i, tp_out=o)),
                      (jm1, TPGroup(0, i * o, "gloo"))):
        j = jtp.TPContext(mesh=jm, backend="cais")
        t = tp.TPContext(group, backend="cais")
        assert (t.tp, t.is_2d, t.route_ring, t.topology) == \
            (j.tp, j.is_2d, j.route_ring, j.topology)
        assert jsharding.tp_size(jm) == t.tp


MB_CASES = [(b, s, dt, i, o) for b in (2, 8) for s in (512, 4096)
            for dt in ("float32", "bfloat16") for i, o in ((2, 2), (4, 2))]


@pytest.mark.parametrize("b,s,dt,i,o", MB_CASES)
def test_inter_tier_microbatch_plan_matches_jax(b, s, dt, i, o):
    """``"auto"`` on a 2D mesh plans against the inter tier on the per-node
    payload, as JAX's ``resolve_microbatches``: the port's x is the
    replica's (B, S/tp, d), JAX's the global (dp·B, S, d)."""
    dp, d = 2, 2048
    jm = AbstractMesh((dp, i, o), ("data", "tp_in", "tp_out"))
    j = jtp.TPContext(mesh=jm, backend="cais", num_microbatches="auto",
                      hw=_h100())
    want = jtp.resolve_microbatches(
        j, jax.ShapeDtypeStruct((dp * b, s, d), jnp.dtype(dt)))
    t = tp.TPContext(_composite(tp_in=i, tp_out=o), backend="cais",
                     num_microbatches="auto")
    x = torch.empty(b, s // (i * o), d, dtype=getattr(torch, dt),
                    device="meta")
    assert tp.resolve_microbatches(t, x) == want
