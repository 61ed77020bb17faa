"""The port's MoE against the JAX package on the CPU, in f32: the config
fields and parameter counts; ``_top2_dispatch`` and ``moe_forward`` (one
device, groups of ``group_size`` over the batch-major tokens) with their
``jax.vjp`` grads, including drops at decode and the group shrink; the
period graph's ``route_fn``/``expert_fn``/``unroute_fn`` and the expert
VJP against ``repro``'s ``_moe_graph_fns`` closures; the expert all-to-all
and its adjoint at gloo world 2 and 4 against a one-device emulation built
from those closures; the MoE period's forward, aux and graph-built grads
on the ring against ``jax.value_and_grad`` of JAX's one-device ``LM.loss``;
``sp_moe_ffn`` with fewer experts than ranks; one train step at world 4;
the perfsim plans and keys of an MoE period; and paged serving.

Routing is discrete (argmax, cumsum), so each comparison that could route
another way says which routing it holds to. The ring routes each rank's
B·S_loc tokens as one group; one device routes groups of ``group_size``
over the batch-major flattening; the two are one function where B = 1 and
S_loc = group_size, which the ring cells use (S = 16·world at the smoke
group of 16). The cells at capacity factor 8 drop no token, so there the
routing does not depend on the grouping and only the aux differs.

The ranks run in their own processes (``tests/torch_rank_cells.py``, no
JAX), one spawn per world size."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import dataflow as jdf  # noqa: E402
from repro.core import tp as jtp  # noqa: E402
from repro.core.primitives import CAISConfig as JCAISConfig  # noqa: E402
from repro.hw import HWSpec as JHWSpec  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import counting as jcounting  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.plan import cache as jcache  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa

import torch_rank_cells as cells  # noqa: E402
from repro_torch import bridge, hw  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import dataflow as df  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.core.tp import param_shard_dim  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import LM, counting, ffn  # noqa: E402
from repro_torch.runtime import Runtime, SMOKE, TPConfig  # noqa: E402
from repro_torch.sharding import TPGroup  # noqa: E402

ARCH = "mixtral-8x7b"
TOL = dict(rtol=1e-5, atol=1e-5)     # f32, the same math summed in orders
GRAD_RTOL = 1e-5                     # per tensor: 1e-5 * max(1, max|g|)
WORLDS = (2, 4)


def _np(t):
    return t.detach().cpu().numpy()


def _rng(seed):
    return np.random.default_rng(seed)


def _cfgs(**over):
    """(JAX cfg, port cfg): mixtral-8x7b's smoke config with ``over`` (a
    ``moe`` entry is a dict of MoEConfig fields to replace)."""
    moe = over.pop("moe", {})
    j, t = jax_get_arch(ARCH).smoke(), get_arch(ARCH).smoke()
    j = j.scaled(moe=dataclasses.replace(j.moe, **moe), **over)
    t = t.scaled(moe=dataclasses.replace(t.moe, **moe), **over)
    return j, t


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["full", "smoke", "dense_residual"])
def test_config_and_param_count_equal_repro(which):
    j, t = jax_get_arch(ARCH), get_arch(ARCH)
    if which != "full":
        j, t = j.smoke(), t.smoke()
    if which == "dense_residual":       # arctic-480b's path at smoke size
        j, t = (c.scaled(moe=dataclasses.replace(c.moe,
                                                 dense_residual_d_ff=64))
                for c in (j, t))
    assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
    for f in dataclasses.fields(t):
        if f.name != "moe":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.param_count() == j.param_count()


def test_mixtral_resolves_and_arctic_raises():
    """Both MoE archs resolve; arctic-480b, once named here as the arch
    that raised, carries its dense residual and trains with adafactor."""
    assert get_arch(ARCH).moe.num_experts == 8
    arctic = get_arch("arctic-480b")
    assert arctic.moe.num_experts == 128
    assert arctic.moe.dense_residual_d_ff == 4864
    assert arctic.optimizer == "adafactor"


def test_expert_ffn_flops_equal_repro():
    for jc, tc in (_cfgs(), (jax_get_arch(ARCH), get_arch(ARCH))):
        assert counting.expert_ffn_flops(tc, 2, 512) == \
            jcounting.expert_ffn_flops(jc, 2, 512)


# ---------------------------------------------------------------------------
# one device: _top2_dispatch and moe_forward against jax.vjp
# ---------------------------------------------------------------------------


def _probs(seed, G, g, E, ties=False):
    rng = _rng(seed)
    if ties:        # whole rows tied, and pairs of equal maxima
        logits = rng.integers(0, 3, (G, g, E)).astype(np.float32)
    else:
        logits = rng.standard_normal((G, g, E)).astype(np.float32)
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))


DISPATCH = {"groups": (2, 16, 4, 10, False),
            # decode: g 4, cap 1, so most second choices and some first
            # choices drop
            "decode_drop": (1, 4, 4, 1, False),
            # exact ties: the first maximum wins in both packages
            "ties": (2, 8, 4, 4, True)}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_top2_dispatch_matches_jax(case):
    G, g, E, cap, ties = DISPATCH[case]
    probs = _probs(1, G, g, E, ties)
    gc = _rng(2).standard_normal((G, g, E, cap)).astype(np.float32)
    @jax.jit
    def ref(p, cots):
        (d, c, a), pull = jax.vjp(lambda q: jffn._top2_dispatch(q, cap), p)
        return d, c, a, pull((jnp.zeros_like(d), *cots))[0]
    jd, jc, ja, jgrad = ref(jnp.asarray(probs),
                            (jnp.asarray(gc), jnp.float32(0.7)))
    p = torch.from_numpy(probs).requires_grad_()
    d, c, a = ffn._top2_dispatch(p, cap)
    np.testing.assert_array_equal(_np(d), np.asarray(jd))   # routing
    np.testing.assert_allclose(_np(c), np.asarray(jc), **TOL)
    np.testing.assert_allclose(float(a), float(ja), **TOL)
    (grad,) = torch.autograd.grad((c, a), p, (torch.from_numpy(gc),
                                              torch.tensor(0.7)))
    np.testing.assert_allclose(_np(grad), np.asarray(jgrad), **TOL)
    if case == "decode_drop":
        assert int(np.asarray(jd).sum()) < 2 * G * g      # tokens dropped


def _moe_case(over, B, S, seed):
    """(JAX cfg, port cfg, numpy MoE tree of the JAX init, x (B, S, d))."""
    jc, tc = _cfgs(**over)
    tree = jax.tree.map(np.asarray, jffn.init_moe(jax.random.key(seed), jc))
    x = _rng(seed).standard_normal((B, S, tc.d_model)).astype(np.float32)
    return jc, tc, tree, x


def _port_moe(tc, tree):
    moe = ffn.MoE(tc, torch.float32, torch.device("cpu"),
                  tc.moe.num_experts)
    sd = {k: torch.from_numpy(v) for k, v in tree.items() if k != "dense"}
    sd.update({f"dense.{k}": torch.from_numpy(v)
               for k, v in tree.get("dense", {}).items()})
    moe.load_state_dict(sd)
    return moe


def _group(cfg_moe, B, S):
    """(group size, capacity) of moe_forward's grouping."""
    g = min(cfg_moe.group_size, B * S)
    while (B * S) % g:
        g //= 2
    return g, max(1, int(g * cfg_moe.top_k / cfg_moe.num_experts
                         * cfg_moe.capacity_factor))


MOE_CASES = {
    "groups": ({}, 2, 16),                       # G 2 of the smoke group 16
    "decode": ({}, 4, 1),                        # g 4, cap 2: drops
    "shrink": ({}, 4, 6),                        # 24 tokens: g 16 -> 8
    "dense_residual": ({"moe": {"dense_residual_d_ff": 64}}, 2, 8),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_forward_matches_jax(case):
    over, B, S = MOE_CASES[case]
    jc, tc, tree, x = _moe_case(dict(over), B, S, seed=3)
    gy = _rng(4).standard_normal(x.shape).astype(np.float32)
    g, cap = _group(jc.moe, B, S)

    @jax.jit
    def ref(p, xx, cots):
        (out, aux), pull = jax.vjp(lambda q, y: jffn.moe_forward(q, y, jc),
                                   p, xx)
        probs = jax.nn.softmax(xx.reshape(-1, g, xx.shape[-1])
                               @ p["router"], -1)
        return out, aux, pull(cots), jffn._top2_dispatch(probs, cap)[0]
    jout, jaux, (jgp, jgx), jd = ref(jax.tree.map(jnp.asarray, tree),
                                     jnp.asarray(x),
                                     (jnp.asarray(gy), jnp.float32(0.3)))
    moe = _port_moe(tc, tree)
    moe.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = ffn.moe_forward(moe, xt, tc)
    # routing first: the (token, expert choice, slot) of every token as JAX
    probs = ffn.router_probs(xt.detach().reshape(-1, g, tc.d_model),
                             moe.router.detach())
    td = ffn._top2_dispatch(probs, cap)[0]
    assert int((_np(td) != np.asarray(jd)).any(-1).any(-1).sum()) == 0
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    torch.autograd.backward((out, aux), (torch.from_numpy(gy),
                                         torch.tensor(0.3)))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jgx), **TOL)
    want = dict(jax.tree.map(np.asarray, jgp))
    want.update({f"dense.{k}": v for k, v in want.pop("dense", {}).items()})
    for k, p in moe.named_parameters():
        bound = GRAD_RTOL * max(1.0, float(np.abs(want[k]).max()))
        assert float(np.abs(_np(p.grad) - want[k]).max()) <= bound, k


# ---------------------------------------------------------------------------
# the period graph's closures against repro's _moe_graph_fns
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ring", [1, 2, 4])
def test_moe_graph_fns_match_jax(ring):
    jc, tc = _cfgs()
    E, d = tc.moe.num_experts, tc.d_model
    tree = jax.tree.map(np.asarray, jffn.init_moe(jax.random.key(5), jc))
    xn = _rng(6).standard_normal((1, 16, d)).astype(np.float32)
    jroute, jexp, junroute = jtp._moe_graph_fns(jc, ring, True)
    troute, texp, tunroute = tp._moe_graph_fns(tc, ring, 0)
    js, jcomb, jaux = jax.jit(jroute)(jnp.asarray(xn),
                                      jnp.asarray(tree["router"]))
    ts, tcomb, taux = troute(torch.from_numpy(xn),
                             torch.from_numpy(tree["router"]))
    np.testing.assert_array_equal(_np(tcomb) > 0, np.asarray(jcomb) > 0)
    for got, want in ((ts, js), (tcomb, jcomb), (taux, jaux)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # the route adjoint: d(send), d(combine), d(aux) into xn and the router
    cots = [_rng(7 + i).standard_normal(np.asarray(v).shape).astype(
        np.float32) for i, v in enumerate((js, jcomb, jaux))]
    jg = jax.jit(lambda a, b, c: jax.vjp(jroute, a, b)[1](c))(
        jnp.asarray(xn), jnp.asarray(tree["router"]),
        tuple(map(jnp.asarray, cots)))
    vjp = df._fn_vjp(troute, 1, 1, (True, True, True))
    tg = vjp(torch.from_numpy(xn), *map(torch.from_numpy, cots),
             torch.from_numpy(tree["router"]))
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # every ring row through each owner's experts, forward and VJP
    E_loc = E // ring
    ws = [tree[k] for k in ("w_up", "w_gate", "w_down")]
    gy = _rng(9).standard_normal(np.asarray(js).shape).astype(np.float32)
    rows = []

    @jax.jit
    def jrow(c, g, *w):
        y, pull = jax.vjp(jexp, c, *w)
        return y, pull(g)
    for j in range(ring):
        wj = [w[j * E_loc:(j + 1) * E_loc] for w in ws]
        row = np.asarray(js)[j]
        jy, jd = jrow(jnp.asarray(row), jnp.asarray(gy[j]),
                      *map(jnp.asarray, wj))
        ty = texp(torch.from_numpy(row), *map(torch.from_numpy, wj))
        td, tdw = texp.vjp(torch.from_numpy(row), torch.from_numpy(gy[j]),
                           *map(torch.from_numpy, wj))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
        for got, want in zip((td,) + tdw, jd):
            np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        rows.append(np.asarray(jy))
    jy = junroute(jnp.asarray(np.stack(rows)), jcomb, jnp.asarray(xn))
    ty = tunroute(torch.from_numpy(np.stack(rows)), tcomb,
                  torch.from_numpy(xn))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    assert texp.matmul_calls == 3 * E_loc
    assert texp.vjp_matmul_calls == 8 * E_loc


@pytest.mark.parametrize("dense", [False, True])
def test_moe_block_graph_equals_repro(dense):
    """The MoE block's graph node for node, before and after ``optimize``
    (pass 2 fuses the attention-out RS → residual → LN2 → router seam into
    ``fused_rs_ln``), and its training graph."""
    f = lambda *a: a[0]                               # noqa: E731
    kw = dict(dense_fn=f, dense_weights=("d_up", "d_gate", "d_down")) \
        if dense else {}
    ew = ("w_up", "w_gate", "w_down")
    gj = jtp.moe_block_graph(f, f, f, f, ew, True, **kw)
    gt = tp.moe_block_graph(f, f, f, f, ew, **kw)

    def structure(g):
        return [(n.name, n.op, n.inputs, n.weights, n.outputs)
                for n in g.nodes], g.outputs
    assert structure(gt) == structure(gj)
    oj, ot = jdf.optimize(gj), df.optimize(gt)
    assert structure(ot) == structure(oj)
    assert "fused_rs_ln" in [n.op for n in ot.nodes]

    def pass2(m, g):
        return m.fuse_sublayer_chain(m.fuse_shared_gather(
            m.fuse_compute_aware(g)))
    tj = jdf.build_training_graph(pass2(jdf, gj))
    tt = df.build_training_graph(pass2(df, gt))
    assert structure(tt.graph) == structure(tj.graph)
    assert (tt.grad_inputs, tt.dx, tt.dweights) == \
        (tj.grad_inputs, tj.dx, tj.dweights)


def test_bwd_a2a_ffn_on_one_device_is_the_rows_vjp():
    """The executor's ``bwd_a2a_ffn`` without a ring: each row's expert VJP,
    the weight grads summed over the rows, as JAX's vmap."""
    jc, tc = _cfgs()
    tree = jax.tree.map(np.asarray, jffn.init_moe(jax.random.key(5), jc))
    ws = [tree[k] for k in ("w_up", "w_gate", "w_down")]
    send = _rng(1).standard_normal((2, 8, tc.d_model)).astype(np.float32)
    gy = _rng(2).standard_normal(send.shape).astype(np.float32)
    _, jexp, _ = jtp._moe_graph_fns(jc, 1, True)
    _, texp, _ = tp._moe_graph_fns(tc, 1, 0)
    g = df.Graph([df.Node("s", "input"), df.Node("d", "input"),
                  df.Node("y", "bwd_a2a_ffn", ("s", "d"),
                          ("wu", "wg", "wd"),
                          outputs=("ds", "dwu", "dwg", "dwd"), fn=texp)],
                 ("ds", "dwu", "dwg", "dwd"))
    got = df.execute(g, {"s": torch.from_numpy(send),
                         "d": torch.from_numpy(gy)},
                     dict(zip(("wu", "wg", "wd"),
                              map(torch.from_numpy, ws))))

    def rows(s, gg):
        _, pull = jax.vjp(jexp, s, *map(jnp.asarray, ws))
        return pull(gg)
    want = jax.vmap(rows)(jnp.asarray(send), jnp.asarray(gy))
    want = (want[0],) + tuple(jnp.sum(a, 0) for a in want[1:])
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# the ring: one spawn per world size
# ---------------------------------------------------------------------------


A2A_CAP = 3


@functools.lru_cache(maxsize=None)
def a2a_case(n):
    """The all-to-all cell's data: cfg (d 16, d_ff 24, E 4), each rank's
    send and output cotangent (n, E_loc·cap, d), the experts' weights."""
    jc, tc = _cfgs(d_model=16, d_ff=24)
    E, d, f = 4, 16, 24
    rng = _rng(11 + n)
    shape = (n, n, (E // n) * A2A_CAP, d)
    return jc, dict(
        cfg=tc, send=rng.standard_normal(shape).astype(np.float32),
        gy=rng.standard_normal(shape).astype(np.float32),
        wu=(0.3 * rng.standard_normal((E, d, f))).astype(np.float32),
        wg=(0.3 * rng.standard_normal((E, d, f))).astype(np.float32),
        wd=(0.3 * rng.standard_normal((E, f, d))).astype(np.float32))


@functools.lru_cache(maxsize=None)
def a2a_emulation(n):
    """One device: rank r's row j through owner j's experts (JAX's
    closures), its VJP, and each owner's weight grads summed over the
    rows that reached it."""
    jc, a = a2a_case(n)
    _, jexp, _ = jtp._moe_graph_fns(jc, n, True)
    E_loc = 4 // n

    @jax.jit
    def row(chunk, gy, *w):
        y, pull = jax.vjp(jexp, chunk, *w)
        return y, pull(gy)
    out = np.zeros_like(a["send"])
    dsend = np.zeros_like(a["send"])
    dws = [np.zeros_like(a[k]) for k in ("wu", "wg", "wd")]
    for j in range(n):
        sl = slice(j * E_loc, (j + 1) * E_loc)
        wj = [jnp.asarray(a[k][sl]) for k in ("wu", "wg", "wd")]
        for r in range(n):
            y, g = row(jnp.asarray(a["send"][r][j]),
                       jnp.asarray(a["gy"][r][j]), *wj)
            out[r][j], dsend[r][j] = np.asarray(y), np.asarray(g[0])
            for dw, gw in zip(dws, g[1:]):
                dw[sl] += np.asarray(gw)
    return out, dsend, dws


def lm_case(n):
    """(JAX cfg, port cfg, numpy params, tokens (1, 16·n)): S_loc equals the
    smoke group of 16, so ring and one device route the same groups."""
    jc, tc = _cfgs()
    params = jax.tree.map(np.asarray, jax_build_model(jc, JAX_SMOKE).init(
        jax.random.key(0)))
    toks = _rng(20 + n).integers(0, tc.vocab_size, (1, 16 * n)).astype(
        np.int32)
    return jc, tc, params, toks


@functools.lru_cache(maxsize=None)
def jax_lm_grads(n):
    jc, tc, params, toks = lm_case(n)
    model = jax_build_model(jc, JAX_SMOKE)
    t = jnp.asarray(toks)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        params, {"tokens": t, "labels": t})
    g = bridge.state_dict_from_jax(jax.tree.map(np.asarray, grads), tc)
    return float(loss), {k: v.numpy() for k, v in g.items()}


def ce_case():
    """multidev_checks' ``moe.auto_vs_cais_ce`` model: capacity factor 8 and
    group 1024 (no token drops), tokens (2, 32)."""
    jc, tc = _cfgs(num_layers=2, d_model=64, num_heads=8, num_kv_heads=8,
                   head_dim=16, d_ff=64, window=16,
                   moe={"capacity_factor": 8.0, "group_size": 1024})
    params = jax.tree.map(np.asarray, jax_build_model(jc, JAX_SMOKE).init(
        jax.random.key(0)))
    toks = _rng(13).integers(0, tc.vocab_size, (2, 32)).astype(np.int32)
    return jc, tc, params, toks


@functools.lru_cache(maxsize=None)
def jax_ce():
    jc, _, params, toks = ce_case()
    saved, jtr.AUX_LOSS_WEIGHT = jtr.AUX_LOSS_WEIGHT, 0.0
    try:
        t = jnp.asarray(toks)
        return float(jax.jit(jax_build_model(jc, JAX_SMOKE).loss)(
            params, {"tokens": t, "labels": t}))
    finally:
        jtr.AUX_LOSS_WEIGHT = saved


def e_lt_tp_case():
    """E = 2 experts on 4 ranks, capacity factor 8 (no drops): a block's
    MoE tree and x (2, 16, d)."""
    jc, tc = _cfgs(moe={"num_experts": 2, "capacity_factor": 8.0})
    tree = jax.tree.map(np.asarray, jtr.init_block(jax.random.key(24),
                                                   "attn", jc, jnp.float32))
    tree["norm2"]["scale"] = (0.1 * _rng(25).standard_normal(
        tree["norm2"]["scale"].shape)).astype(np.float32)
    x = _rng(26).standard_normal((2, 16, tc.d_model)).astype(np.float32)
    return jc, tc, tree, x


STEP_LR = 1e-3


@functools.lru_cache(maxsize=None)
def jax_step():
    """One JAX AdamW step of ``lm_case(4)`` on one device: (loss, grad
    norm, {param: updated value})."""
    jc, tc, params, toks = lm_case(4)
    model = jax_build_model(jc, JAX_SMOKE)
    o = jopt.adamw(jopt.constant_schedule(STEP_LR))
    state = {"params": params, "opt": o.init(params),
             "step": jnp.zeros((), jnp.int32)}
    t = jnp.asarray(toks)
    state, m = jax.jit(jax_make_train_step(model, o, JAX_SMOKE))(
        state, {"tokens": t, "labels": t})
    new = bridge.state_dict_from_jax(jax.tree.map(np.asarray,
                                                  state["params"]), tc)
    return (float(m["loss"]), float(m["grad_norm"]),
            {k: v.numpy() for k, v in new.items()})


@functools.lru_cache(maxsize=None)
def _ring_spawns():
    """Both spawns (one per world size) started at once in threads, so the
    ranks run while this process computes the JAX references."""
    from concurrent.futures import ThreadPoolExecutor

    datas = {}
    for n in WORLDS:
        _, tc, params, toks = lm_case(n)
        _, ctc, cparams, ctoks = ce_case()
        datas[n] = {"a2a": a2a_case(n)[1], "lm": (tc, params, toks),
                    "ce": (ctc, cparams, ctoks)}
        if n == 4:
            _, etc, tree, x = e_lt_tp_case()
            datas[n]["e_lt_tp"] = (etc, tree, x)
            datas[n]["step"] = (tc, params, {"tokens": toks,
                                             "labels": toks}, STEP_LR)
    pool = ThreadPoolExecutor(len(WORLDS))
    futures = {n: pool.submit(run_ranks, cells.moe_cells, n, datas[n])
               for n in WORLDS}
    pool.shutdown(wait=False)
    return futures


@pytest.fixture(scope="module", autouse=True)
def _start_ring_spawns():
    """Start the spawns with the module's first test, so the ranks run
    while the one-device tests do."""
    _ring_spawns()


def moe_ring(n):
    """Every MoE cell of one spawn of ``n`` gloo ranks, one result a rank."""
    return _ring_spawns()[n].result()


SCHEDULES = ["barrier", "cais", "cais_uni"]
A2A_CELLS = [(n, s) for n in WORLDS for s in SCHEDULES]
A2A_IDS = [f"world{n}-{s}" for n, s in A2A_CELLS]


@pytest.mark.parametrize("n,sched", A2A_CELLS, ids=A2A_IDS)
def test_a2a_expert_matches_one_device(n, sched):
    """multidev_checks' ``a2a_expert.{barrier,cais,cais_uni}`` (1e-5)."""
    want = a2a_emulation(n)[0]
    for r, res in enumerate(moe_ring(n)):
        np.testing.assert_allclose(res["a2a"][f"a2a.{sched}"], want[r],
                                   **TOL)


@pytest.mark.parametrize("n,sched", A2A_CELLS, ids=A2A_IDS)
def test_a2a_expert_grad_matches_one_device(n, sched):
    """The adjoint: each rank's d(send), and each owner's expert grads
    (complete at the owner, on no collective) against the emulation."""
    _, dsend, dws = a2a_emulation(n)
    E_loc = 4 // n
    for r, res in enumerate(moe_ring(n)):
        d, got = res["a2a"][f"grad.{sched}"]
        np.testing.assert_allclose(d, dsend[r], **TOL)
        for g, w in zip(got, dws):
            np.testing.assert_allclose(g, w[r * E_loc:(r + 1) * E_loc],
                                       **TOL)


RING_CELLS = [(n, m) for n in WORLDS for m in ("barrier", "cais")]
RING_IDS = [f"world{n}-{m}" for n, m in RING_CELLS]


@pytest.mark.parametrize("n,mode", RING_CELLS, ids=RING_IDS)
def test_moe_ring_grads_match_jax(n, mode):
    """``train_grad.graph_vs_autodiff.moe.*``: LM.loss (CE + the weighted
    mean of the ranks' aux) and every gradient of the ring's graph-built
    backward against ``jax.value_and_grad`` of one device; with S_loc the
    group size both route the same groups."""
    loss, want = jax_lm_grads(n)
    _, tc, _, _ = lm_case(n)
    res = [r["lm"][mode] for r in moe_ring(n)]
    assert len({r[0] for r in res}) == 1
    assert abs(res[0][0] - loss) <= 1e-5 * abs(loss)
    assert param_shard_dim("blocks.0.ffn.w_up", tc, n) == 0
    for name, g_ref in want.items():
        dim = param_shard_dim(name, tc, n)
        parts = [r[1][name] for r in res]
        got = parts[0] if dim is None else np.concatenate(parts, axis=dim)
        if dim is None:            # replicated: summed over the ring once
            for p in parts[1:]:
                np.testing.assert_array_equal(p, parts[0])
        bound = GRAD_RTOL * max(1.0, float(np.abs(g_ref).max()))
        assert float(np.abs(got - g_ref).max()) <= bound, name


@pytest.mark.parametrize("n,mode", RING_CELLS, ids=RING_IDS)
def test_moe_ring_launches_match_the_graphs(n, mode):
    """Matmul and flash calls equal ``matmul_calls``/``flash_calls`` of the
    forward and training graphs (the expert GEMMs included), and each MoE
    block dispatched its all-to-all through the backend twice (the forward
    and the training graph's recompute) and its adjoint once."""
    _, tc, _, _ = lm_case(n)
    for r in moe_ring(n):
        _, _, made, derived, fmade, fderived, a2a = r["lm"][mode]
        assert made == derived > 0
        assert fmade == fderived > 0
        assert a2a == (2 * tc.num_layers, tc.num_layers)


@pytest.mark.parametrize("n", WORLDS)
def test_moe_auto_vs_cais_ce(n):
    """``moe.auto_vs_cais_ce`` (2e-5): the cais ring's cross-entropy against
    one device's (what JAX's ``auto`` computes), capacity 8, no drops."""
    got = [r["ce"] for r in moe_ring(n)]
    assert len(set(got)) == 1
    assert abs(got[0] - jax_ce()) <= 2e-5


def test_sp_moe_ffn_e_lt_tp():
    """``sp_moe_ffn.e_lt_tp`` (1e-5): E = 2 on 4 ranks (expert e on rank
    2e, zero-capacity padding on the others) against JAX's one-device MoE
    of the normed input (``sp_moe_ffn`` on one device computes the same:
    at capacity factor 8 no token drops, so the grouping changes only the
    aux)."""
    from repro.models.layers import apply_norm as japply_norm

    jc, _, tree, x = e_lt_tp_case()
    xn = japply_norm(jc.norm, {"scale": jnp.asarray(tree["norm2"]["scale"])},
                     jnp.asarray(x))
    want, _ = jax.jit(lambda p, y: jffn.moe_forward(p, y, jc))(
        jax.tree.map(jnp.asarray, tree["ffn"]), xn)
    res = moe_ring(4)
    got = np.concatenate([r["e_lt_tp"][0] for r in res], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert len({r["e_lt_tp"][1] for r in res}) == 1     # one ring mean


def test_moe_train_step_world4():
    """One AdamW step of the cais ring against JAX's one-device step: loss
    and grad norm (1e-5), and every parameter (1e-5, or 2·lr where the
    gradient lies within its bound of zero, where Adam's sign may
    differ)."""
    loss, gnorm, want = jax_step()
    _, grads = jax_lm_grads(4)
    _, tc, _, _ = lm_case(4)
    res = [r["step"] for r in moe_ring(4)]
    assert abs(res[0][0] - loss) <= 1e-5 * abs(loss)
    assert abs(res[0][1] - gnorm) <= 1e-5 * abs(gnorm)
    for name, w in want.items():
        dim = param_shard_dim(name, tc, 4)
        parts = [r[2][name] for r in res]
        got = parts[0] if dim is None else np.concatenate(parts, axis=dim)
        g = np.abs(grads[name])
        near = g <= GRAD_RTOL * max(1.0, float(g.max()))
        limit = np.where(near, 2 * STEP_LR, 1e-5)
        assert (np.abs(got - w) <= limit).all(), name


def test_moe_rank_cells_import_no_jax():
    assert not any(r["_jax_imported"] for n in WORLDS for r in moe_ring(n))


# ---------------------------------------------------------------------------
# the perfsim planner on an MoE period
# ---------------------------------------------------------------------------


def _planned_keys(root):
    return cells._plans_on_disk(str(root))


@pytest.mark.parametrize("mode", ["barrier", "cais"])
def test_moe_period_plans_equal_repro(mode, tmp_path):
    """The perfsim plans and cache keys of a 2-block MoE period and of its
    training graph on a ring of 4 equal ``repro``'s ``_plan_period`` /
    ``_bwd_planner`` (an abstract mesh: planning reads shapes only). The
    split ``auto`` never splits an MoE period (candidates (1,)); the expert
    hints are keyed on kind ``"moe"``, which no layer pattern holds, so
    neither package hints the expert FFN."""
    from repro_torch import plan

    n, kinds = 4, ("swa", "swa")
    jc, tc = _cfgs()
    trees = [jax.tree.map(np.asarray, jtr.init_block(
        jax.random.key(40 + i), "swa", jc, jnp.float32)) for i in range(2)]
    B, S = 2, 64
    jtpc = jtp.TPContext(mesh=AbstractMesh((1, n), ("data", "model")),
                         backend=mode, cais=JCAISConfig(num_chunks=2),
                         planner="perfsim",
                         hw=JHWSpec(**dataclasses.asdict(hw.H100)))
    base, weights, _, aux = jtp._period_graph(jtpc, trees, jc, kinds)
    assert aux
    x = jax.ShapeDtypeStruct((B, S, jc.d_model), jnp.float32)
    hints = jtp._core_comp_hints(jc, kinds, B, S)
    assert not any(k.endswith("eout") for k in hints)
    assert "b0.eout" in jtp._core_comp_hints(jc, ("moe",), B, S)
    saved = jcache._DEFAULT
    jcache._DEFAULT = jplan.PlanCache(root=str(tmp_path / "jax"))
    try:
        mb, pairer = jtp._plan_period(jtpc, base, weights, x, "auto",
                                      moe=True, comp_hints=hints)
        merged = jtp.microbatch_period_graph(base, mb)
        g2 = jdf.fuse_sublayer_chain(jdf.fuse_shared_gather(
            jdf.fuse_compute_aware(merged)))
        tg = jdf.build_training_graph(g2)
        jdf.optimize(tg.graph, planner=jtp._bwd_planner(
            jtpc, tg, weights, x, mb, hints))
    finally:
        jcache._DEFAULT = saved
    assert mb == 1
    want = _planned_keys(tmp_path / "jax")

    group = TPGroup(0, n, "gloo")          # planning only: no collective
    blocks = [cells._block_shard(tc, t, group) for t in trees]
    saved_t = plan.cache._DEFAULT
    plan.cache._DEFAULT = plan.PlanCache(root=str(tmp_path / "torch"))
    try:
        tpc = tp.TPContext(group, backend=mode,
                           cais=tp.CAISConfig(num_chunks=2),
                           num_microbatches="auto", planner="perfsim")
        xm = torch.empty(B, S // n, tc.d_model, device="meta")
        period, _ = tp.build_period(tpc, xm, blocks, tc, kinds)
        period.training()
    finally:
        plan.cache._DEFAULT = saved_t
    assert period.mb == 1 and period.n_aux == 2
    got = _planned_keys(tmp_path / "torch")
    assert got == want and len(got) == 2


# ---------------------------------------------------------------------------
# paged serving on one device
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def serve_pair():
    jc, tc = _cfgs()
    jmodel = jax_build_model(jc, JAX_SMOKE)
    jparams = jmodel.init(jax.random.key(0))
    lm = LM(tc, SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(lm, jax.tree.map(np.asarray, jparams))
    return jc, jmodel, jparams, tc, lm


def test_serve_step_routes_padding_as_jax():
    """A mixed step (a prefill chunk, a decode row past the window, a
    padding row, padding positions): padding tokens route with the rest
    and take capacity, as in JAX; logits of the live rows and the new pools
    within 1e-5."""
    import test_torch_model as tm
    from repro.models import attention as jattn
    from repro_torch.models import attention

    jc, jmodel, jparams, tc, lm = serve_pair()
    rng = _rng(1)
    toks, bt, pos, ctx, last = tm.mixed_view(rng)
    shape = (8, 4, tc.num_kv_heads, tc.resolved_head_dim)
    layers = [{k: rng.standard_normal(shape).astype(np.float32)
               for k in ("k", "v")} for _ in range(tc.num_layers)]
    jview = jattn.KVView(*map(jnp.asarray, (bt, pos, ctx, last)))
    jlogits, jnew = jax.jit(jmodel.serve_step)(
        jparams, jnp.asarray(toks), tm.jax_pools(layers, jc), jview)
    pools = [{k: torch.from_numpy(t[k].copy()) for k in t} for t in layers]
    view = attention.KVView(*map(torch.from_numpy, (bt, pos, ctx, last)))
    logits, new = lm.serve_step(torch.from_numpy(toks), pools, view)
    np.testing.assert_allclose(_np(logits[:2]), np.asarray(jlogits)[:2],
                               **TOL)
    want = bridge.unstack_layers(jax.tree.map(np.asarray, jnew), tc)
    for g, w in zip(new, want):
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(g[k]), w[k], **TOL)
    # the padding is routed: 15 tokens of which 6 are padding give a group
    # of 15 with its capacity, not a group of the 9 live tokens
    assert (toks == 0).sum() >= 6


def test_engine_greedy_matches_jax():
    from repro.serve import Engine as JaxEngine
    from repro.serve import Request as JaxRequest
    from repro.serve import ServeConfig as JaxServeConfig
    from repro_torch.serve import Engine, Request, ServeConfig
    from repro_torch.serve.engine import paged_supported

    jc, jmodel, jparams, tc, lm = serve_pair()
    assert paged_supported(lm, tc)
    long = (np.arange(1, 20) % tc.vocab_size).astype(np.int32)
    short = np.arange(40, 46, dtype=np.int32)
    prompts = [long, short, long]
    kw = dict(max_batch=2, max_active=2, s_max=32, block_size=4,
              prefill_chunk=4)
    jeng = JaxEngine(jmodel, jparams, jc, JAX_SMOKE, JaxServeConfig(**kw))
    want = jeng.run([JaxRequest(rid=i, prompt=p, max_new_tokens=4)
                     for i, p in enumerate(prompts)])
    eng = Engine(lm, tc, SMOKE, ServeConfig(**kw), device="cpu")
    got = eng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                   for i, p in enumerate(prompts)])
    assert eng.paged
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]


def test_serving_attention_that_does_not_split_raises_by_name():
    """MoE serving on a ring runs (``tests/test_torch_moe_serve_tp.py``);
    a block whose query heads do not split over the ring (3 over 2 ranks)
    still raises, by its ROADMAP name: JAX falls back per sub-layer under
    GSPMD."""
    group = TPGroup(0, 2, "gloo")
    _, tc = _cfgs(num_heads=3, num_kv_heads=1)
    lm = LM(tc, Runtime(compute_dtype="float32", tp=TPConfig(mode="cais")),
            device="cpu", seed=0, group=group)
    view = None
    with pytest.raises(NotImplementedError, match=r"ROADMAP A11 \(b\)"):
        lm.serve_step(torch.zeros(1, 1, dtype=torch.int32),
                      lm.init_pools(4, 4), view)
