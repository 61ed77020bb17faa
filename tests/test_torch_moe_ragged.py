"""MoE training at a sequence that does not split over the ring (S % tp !=
0) against the JAX package on the CPU, in f32, on gloo rings of 2 and 4
ranks at smoke widths. JAX runs such a block replicated under GSPMD
(``src/repro/models/transformer.py``, ``block_forward``: neither ``sp_block``
branch applies); the port runs it in the replicated activation layout:
every rank routes the whole batch alike (a ``route`` node), runs its own
experts on the matmul kernel, and the ``expert_ar`` node's all-reduce sums
them; the graph-built backward takes the experts' declared VJP and
all-reduces the partial cotangents of the routed activation and the
combine weights (:mod:`repro_torch.core.tp`, ``_moe_replicated_nodes``).

Held against ``jax.value_and_grad`` of JAX's one-device ``LM.loss``:
routing first (exactly JAX's), then the loss within 1e-5 relative and
every grad after ``sync_grads`` within ``GRAD_RTOL`` · max(1, max|g|), the
same loss on every rank and every grad a rank holds whole bitwise equal on
every rank; the aux loss of ``LM.forward`` and its router grads alone,
counted once (not tp times); the matmul and flash calls against
``tp.step_launches``; ``planner="perfsim"`` bitwise greedy's with no plan
lookup. The cases: mixtral-8x7b's and arctic-480b's smoke configs (4
experts; arctic's dense residual MLP of 64, replicated, its grads not
summed) at world 2 and 4, ``barrier`` and ``cais``; B 1 x S 3 (one group
of 3 tokens, capacity 1: the choices past an expert's slot dropped, as JAX
drops them), B 1 x S 17 (groups of one token, capacity 1: both choices
kept, in slot 0 of two experts), B 8 x S 6 at world 4 (groups of 16,
capacity 10); tp_in 2 x tp_out 2 (grouped EP: each tp_in rank computes one
of its tp_out index's two experts, their grads summed over tp_in); data 2
x model 2 (B 32 x S 3: each replica's 48 tokens route in the global
batch's groups of 16; at B 8 x S 17 the global batch's groups of 8 would
straddle the replicas' 68 tokens each, which route in groups of 4, and
every rank refuses the shape by name); E = 2 on 4 ranks (the experts replicate: no
reduction); and 6 query heads on 4 ranks (the attention runs replicated,
the MoE through ``sp_moe_ffn``'s replicated-layout graph). Plus, on one
device, the ``expert_ar`` node's graph-built adjoint against
``torch.autograd`` of the plain MoE.

The ranks run in their own processes (``tests/torch_moe_ragged_cells.py``,
no JAX), one spawn per world size, started with the module's first test."""
import dataclasses
import functools
import sys
import tempfile
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
import torch_moe_ragged_cells as cells  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import dataflow as df  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.sharding import TPGroup  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5                     # per tensor: 1e-5 * max(1, max|g|)
# name: (arch, overrides (a "moe" entry: MoEConfig fields), tokens shape,
# JAX init key)
CASES = {"mixtral_s3": ("mixtral-8x7b", {}, (1, 3), 0),
         "arctic_s3": ("arctic-480b", {}, (1, 3), 1),
         "mixtral_s17": ("mixtral-8x7b", {}, (1, 17), 0),
         "mixtral_8x6": ("mixtral-8x7b", {}, (8, 6), 0),
         "mixtral_dp": ("mixtral-8x7b", {}, (32, 3), 0),
         "mixtral_dp_8x17": ("mixtral-8x7b", {}, (8, 17), 0),
         "e2": ("mixtral-8x7b", {"moe": {"num_experts": 2}}, (2, 5), 2),
         "heads6": ("mixtral-8x7b", {"num_heads": 6}, (2, 7), 3)}
MESH_2D, MESH_DP = (("tp_in", 2), ("tp_out", 2)), (("dp", 2),)
# (case, mode, planner, mesh) a world runs
RUNS = {2: [(c, m, "greedy", None) for c in ("mixtral_s3", "arctic_s3")
            for m in ("barrier", "cais")]
        + [("mixtral_s17", "cais", "greedy", None)],
        4: [(c, m, "greedy", None) for c in ("mixtral_s3", "arctic_s3",
                                             "mixtral_8x6")
            for m in ("barrier", "cais")]
        + [("mixtral_s17", "cais", "greedy", None),
           ("mixtral_8x6", "cais", "perfsim", None),
           ("mixtral_8x6", "cais", "greedy", MESH_2D),
           ("arctic_s3", "barrier", "greedy", MESH_2D),
           ("mixtral_dp", "cais", "greedy", MESH_DP),
           ("e2", "cais", "greedy", None),
           ("heads6", "cais", "greedy", None)]}
# a data-axis shape whose global routing groups straddle the replicas: the
# ranks refuse it (ROADMAP A11 (b)), so it runs no JAX reference
STRADDLE = ("mixtral_dp_8x17", "cais", "greedy", MESH_DP)
RUNS[4].append(STRADDLE)
ALL_RUNS = [(n,) + r for n in sorted(RUNS) for r in RUNS[n]
            if r != STRADDLE]


def _run_id(run):
    n, case, mode, planner, mesh = run
    return (f"w{n}-{case}-{mode}" + ("-perfsim" if planner == "perfsim"
                                      else "")
            + ("" if mesh is None else "-2d" if mesh == MESH_2D else "-dp"))


def _cfgs(name):
    """(JAX cfg, port cfg) of a case."""
    arch, over, _, _ = CASES[name]
    over = dict(over)
    moe = over.pop("moe", {})
    j, t = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    return (j.scaled(moe=dataclasses.replace(j.moe, **moe), **over),
            t.scaled(moe=dataclasses.replace(t.moe, **moe), **over))


def _port_names(tree, tc):
    g = bridge.state_dict_from_jax(jax.tree.map(np.asarray, tree), tc)
    return {k: v.numpy() for k, v in g.items()}


@functools.lru_cache(maxsize=None)
def _init(arch, over, key):
    """(JAX model, its params, numpy params), one a configuration."""
    jc, _ = _cfgs(next(n for n, c in CASES.items()
                       if (c[0], repr(c[1]), c[3]) == (arch, over, key)))
    model = jax_build_model(jc, JAX_SMOKE)
    params = jax.jit(model.init)(jax.random.key(key))
    return model, params, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def jax_params(name):
    """(JAX model, its params, numpy params, tokens) of a case."""
    arch, over, shape, key = CASES[name]
    toks = np.random.default_rng(40 + len(name)).integers(
        0, _cfgs(name)[1].vocab_size, shape).astype(np.int32)
    return _init(arch, repr(over), key) + (toks,)


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """JAX on one device: ``LM.loss`` and its grads, the aux of
    ``LM.forward`` and its grads, and the routing of the loss's forward
    (one :func:`chip_smoke.compact_routing` record a layer)."""
    _, tc = _cfgs(name)
    model, params, _, toks = jax_params(name)
    t = jnp.asarray(toks)
    rec = []
    inner = jffn._top2_dispatch

    def recorded(probs, capacity):
        out = inner(probs, capacity)
        jax.debug.callback(lambda p, d: rec.append(CS.compact_routing(
            torch.from_numpy(np.array(p)), torch.from_numpy(np.array(d)))),
            probs, out[0], ordered=True)
        return out

    jffn._top2_dispatch = recorded
    try:
        (loss, grads), (aux, aux_grads) = jax.jit(lambda p: (
            jax.value_and_grad(model.loss)(p, {"tokens": t, "labels": t}),
            jax.value_and_grad(lambda q: model.forward(q, t)[1])(p)))(params)
        jax.block_until_ready(aux)
    finally:
        jffn._top2_dispatch = inner
    return dict(loss=float(loss), grads=_port_names(grads, tc),
                aux=float(aux), aux_grads=_port_names(aux_grads, tc),
                routing=rec[:tc.num_layers])


def _spawn(n):
    cases = {}
    for case, *_ in RUNS[n]:
        if case not in cases:
            cases[case] = (_cfgs(case)[1],) + jax_params(case)[2:]
    with tempfile.TemporaryDirectory() as root:
        return run_ranks(cells.ragged_cells, n, cases, RUNS[n], root)


@functools.lru_cache(maxsize=None)
def _ring_spawns():
    """Both spawns (one per world size) started at once in threads, so the
    ranks run while this process computes the JAX references."""
    from concurrent.futures import ThreadPoolExecutor

    for name in CASES:
        jax_params(name)
    pool = ThreadPoolExecutor(len(RUNS))
    futures = {n: pool.submit(_spawn, n) for n in RUNS}
    pool.shutdown(wait=False)
    return futures


@pytest.fixture(scope="module", autouse=True)
def _start_ring_spawns():
    _ring_spawns()


def _result(run):
    """Every rank's result of one run."""
    n, *key = run
    return [r[tuple(key)] for r in _ring_spawns()[n].result()]


def _whole(parts, name):
    """The whole grad of ``name`` from every rank's (grad, placement):
    ranks that hold the same shard (or the whole) hold it bitwise alike."""
    shards = {}
    for g, placed in parts:
        dim, idx, size = placed if placed is not None else (0, 0, 1)
        if idx in shards:
            np.testing.assert_array_equal(g, shards[idx], err_msg=name)
        shards[idx] = g
    assert sorted(shards) == list(range(size)), name
    return np.concatenate([shards[i] for i in range(size)], axis=dim)


def _grad_close(got, want, name):
    bound = GRAD_RTOL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound, name


def _routing_equal(run, ranks):
    """Routing first: every rank's (its replica's rows on a data axis)
    exactly JAX's."""
    n, case, _, _, mesh = run
    want = jax_case(case)["routing"]
    dp = dict(mesh or ()).get("dp", 1)
    for i, r in enumerate(ranks):
        rows = len(want[0][0]) // dp
        d = (i // (n // dp)) * rows
        sl = [(w[d:d + rows], top[d:d + rows]) for w, top in want]
        diff = CS.routing_differences(r["routing"], sl)
        assert diff["choice"] == 0 and diff["slots"] == 0, (i, diff)


@pytest.mark.parametrize("run", ALL_RUNS, ids=[_run_id(r) for r in ALL_RUNS])
def test_ragged_moe_loss_and_grads_match_jax(run):
    """Routing, then LM.loss (one value on every rank) and every grad after
    ``sync_grads`` against ``jax.value_and_grad`` of one device; in the
    replicated layout."""
    ranks = _result(run)
    ref = jax_case(run[1])
    assert {r["layout"] for r in ranks} == {"replicated"}
    _routing_equal(run, ranks)
    assert len({r["loss"] for r in ranks}) == 1
    assert abs(ranks[0]["loss"] - ref["loss"]) <= LOSS_RTOL * abs(
        ref["loss"])
    for name, want in ref["grads"].items():
        _grad_close(_whole([r["grads"][name] for r in ranks], name), want,
                    name)


@pytest.mark.parametrize("n", sorted(RUNS))
def test_small_groups_route_and_drop_as_jax(n):
    """The routing at a ragged S, held as JAX routes it (not "fixed"):
    at B 1 x S 17 ``route_tokens`` halves the group of 16 until it divides
    17, so every group is one token with capacity 1, whose two choices go
    to two experts and both take slot 0 (nothing is dropped); B 1 x S 3 is
    one group of 3 with capacity 1, where the choices past an expert's one
    slot, first or second, are dropped. Every rank's routing is JAX's."""
    s17 = jax_case("mixtral_s17")["routing"]
    assert all((w[:, [1, 3]] == 0).all() for w, _ in s17)
    s3 = jax_case("mixtral_s3")["routing"]
    assert any((w[:, [1, 3]] == -1).any() for w, _ in s3)
    for case, want in (("mixtral_s17", s17), ("mixtral_s3", s3)):
        for r in _result((n, case, "cais", "greedy", None)):
            for (g, _), (w, _) in zip(r["routing"], want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("run", ALL_RUNS, ids=[_run_id(r) for r in ALL_RUNS])
def test_ragged_moe_aux_and_router_grad_counted_once(run):
    """The aux loss of ``LM.forward`` is JAX's on every rank, and its
    router grads alone (the aux's only way to the router) are JAX's on
    every rank, bitwise alike: counted once, not tp times nor 1/tp."""
    ranks = _result(run)
    ref = jax_case(run[1])
    assert len({r["aux"] for r in ranks}) == 1
    assert abs(ranks[0]["aux"] - ref["aux"]) <= LOSS_RTOL * abs(ref["aux"])
    routers = [k for k in ref["grads"] if k.endswith("ffn.router")]
    assert routers
    for name in routers:
        got = [r["aux_router"][name] for r in ranks]
        for g in got[1:]:
            np.testing.assert_array_equal(g, got[0], err_msg=name)
        _grad_close(got[0], ref["aux_grads"][name], name)
        assert np.abs(ref["aux_grads"][name]).max() > 0


@pytest.mark.parametrize("run", ALL_RUNS, ids=[_run_id(r) for r in ALL_RUNS])
def test_ragged_moe_calls_equal_step_launches(run):
    """Each rank's matmul and flash calls equal ``tp.step_launches`` of
    what its forward recorded, the expert GEMMs included (3 an expert a
    rank computes in each forward and recompute, 9 in its VJP)."""
    for r in _result(run):
        assert r["made"]["matmul"] == r["derived"]["matmul"] > 0
        assert r["made"]["flash"] == r["derived"]["flash"] > 0


def test_ragged_moe_perfsim_is_greedy_and_plans_nothing():
    """An MoE graph of the replicated layout is planned greedily under
    ``planner="perfsim"`` (JAX plans none): loss and grads bitwise the
    greedy run's, and the plan cache is never consulted."""
    greedy = _result((4, "mixtral_8x6", "cais", "greedy", None))
    planned = _result((4, "mixtral_8x6", "cais", "perfsim", None))
    for g, p in zip(greedy, planned):
        assert p["looked"] == (0, 0, 0)
        assert p["loss"] == g["loss"]
        for name, (grad, _) in g["grads"].items():
            np.testing.assert_array_equal(p["grads"][name][0], grad)


def test_ragged_moe_grouped_ep_sums_experts_over_tp_in():
    """On tp_in 2 x tp_out 2 a tp_out index's two experts are computed one
    a tp_in rank, so before the sum over tp_in each rank's grad of the
    other expert is zero: the two tp_in ranks' summed grads are alike and
    whole, while the replicated dense MLP's (arctic) are complete on every
    rank without a sum (equal to JAX's, above)."""
    for case in ("mixtral_8x6", "arctic_s3"):
        run = (4, case, "cais" if case.startswith("mixtral") else "barrier",
               "greedy", MESH_2D)
        ranks = _result(run)
        ref = jax_case(case)
        name = "blocks.0.ffn.w_up"
        placed = [r["grads"][name][1] for r in ranks]
        assert [p[1:] for p in placed] == [(0, 2), (1, 2), (0, 2), (1, 2)]
        got = _whole([r["grads"][name] for r in ranks], name)
        _grad_close(got, ref["grads"][name], name)


def test_ragged_moe_refuses_groups_straddling_data_replicas():
    """JAX routes the global batch in one piece under GSPMD, in groups of
    ``group_size`` halved until they divide B·S; a replica of the port's
    replicated layout routes its own rows. Where the two group sizes differ
    the port cannot give JAX's routing and raises by name, on every rank
    and before any collective: B 8 x S 17 on data 2 x model 2 (136 tokens
    in groups of 8, each replica's 68 in groups of 4). Where they agree
    (B 32 x S 3: 16 and 16) it runs, held to JAX above. The rule, at smoke
    widths (groups of 16) and mixtral-8x7b's own (512): B 8 x S 1025 on
    two replicas routes in groups of 8 globally, 4 a replica."""
    for r in _result((4,) + STRADDLE):
        assert "A11 (b)" in r["raised"] and "groups of 8" in r["raised"]
    smoke, full = _cfgs("mixtral_dp")[1], get_arch("mixtral-8x7b")
    assert ffn.group_size(136, smoke) == 8
    assert ffn.group_size(68, smoke) == 4
    assert ffn.group_size(8200, full) == 8
    assert ffn.group_size(4100, full) == 4
    for cfg, tokens, dp in ((smoke, 68, 2), (smoke, 6, 2), (full, 4100, 2)):
        with pytest.raises(NotImplementedError, match=r"A11 \(b\)"):
            ffn.check_replica_routing(cfg, tokens, dp)
    for cfg, tokens, dp in ((smoke, 48, 2), (smoke, 6, 1), (full, 8192, 2)):
        ffn.check_replica_routing(cfg, tokens, dp)


def test_ragged_moe_rank_cells_import_no_jax():
    assert not any(r["_jax_imported"] for n in RUNS
                   for r in _ring_spawns()[n].result())


# ---------------------------------------------------------------------------
# one device: the expert_ar node and its adjoint
# ---------------------------------------------------------------------------


def test_expert_ar_adjoint_equals_autograd_of_the_plain_moe():
    """On a group of 1 the graph route → expert_ar and its graph-built
    backward (the experts' declared VJP, the all-reduces of d xn and d
    combine) against ``torch.autograd`` of ``models.ffn.moe_forward``, the
    plain MoE: the output, the aux, d x and every weight grad, for random
    cotangents of the output and the aux. B 2 x S 7: one group of 14,
    capacity 8, some second choices dropped."""
    _, cfg = _cfgs("mixtral_s3")
    rng = np.random.default_rng(9)
    moe = ffn.MoE(cfg, torch.float32, torch.device("cpu"),
                  cfg.moe.num_experts)
    moe.reset_parameters(torch.Generator().manual_seed(9))
    x = torch.from_numpy(rng.standard_normal((2, 7, cfg.d_model)).astype(
        np.float32))
    gy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    gaux = torch.tensor([0.37])
    group = TPGroup(0, 1, "gloo")
    tpc = tp.TPContext(group, backend="cais")
    nodes, top, aux = tp._moe_replicated_nodes(cfg, tpc, "", "x")
    assert [n.op for n in nodes] == ["route", "expert_ar"]
    g = df.Graph([df.Node("x", "input")] + nodes, outputs=(top, aux))
    w = {"router": moe.router, "w_up": moe.w_up, "w_gate": moe.w_gate,
         "w_down": moe.w_down}
    y, a = df.execute(g, {"x": x}, w, group=group)
    tg = df.build_training_graph(g)
    assert sorted(n.name for n in tg.graph.nodes if n.op == "allreduce") \
        == ["d.combine@adj.moe", "d.x@adj.moe"]
    vals = {"x": x, tg.grad_inputs[0]: gy, tg.grad_inputs[1]: gaux}
    got = dict(zip(tg.graph.outputs, df.execute(tg.graph, vals, w,
                                                group=group)))

    leaves = {k: v.detach().clone().requires_grad_() for k, v in
              [("x", x)] + list(w.items())}
    plain = types.SimpleNamespace(dense=None, **{k: leaves[k] for k in w})
    with torch.enable_grad():
        y_ref, a_ref = ffn.moe_forward(plain, leaves["x"], cfg)
        grads = torch.autograd.grad(
            (y_ref * gy).sum() + a_ref * gaux[0], list(leaves.values()))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), y_ref.detach().numpy(), **tol)
    np.testing.assert_allclose(float(a), float(a_ref.detach()), **tol)
    want = dict(zip(leaves, grads))
    np.testing.assert_allclose(got[tg.dx["x"]].numpy(), want["x"].numpy(),
                               **tol)
    for k in w:
        (v,) = tg.dweights[k]
        np.testing.assert_allclose(got[v].numpy(), want[k].numpy(), **tol,
                                   err_msg=k)
