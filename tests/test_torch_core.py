"""The port's tensor-parallel core against the JAX package on the CPU:
chunk planning (identical plans with the TPU spec passed to both), the
dataflow optimizer (the same optimized node list on the same builder graphs;
the same GraphError cases as tests/test_dataflow_validation.py), and every
ring schedule of ``repro_torch.core.primitives`` at gloo world 2 and 4 —
the counterparts of the ``ag_gemm.ring*``, ``gemm_rs.c*.b*``, ``gemm_ar``
and ``overlap_asym.*`` cells of tests/multidev_checks.py, odd S_loc
included — within 1e-6 (f32) of unsharded math. The ranks run in their own
processes (``tests/torch_rank_cells.py``, no JAX), spawned once per world
size."""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import coordination as jcoord  # noqa: E402
from repro.core import dataflow as jdf  # noqa: E402
from repro.core import tp as jtp  # noqa: E402
from repro.hw import V5E as JV5E  # noqa: E402

import torch_rank_cells as cells  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.core import backends, coordination  # noqa: E402
from repro_torch.core import dataflow as df  # noqa: E402
from repro_torch.core import tp as tp_mod  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.sharding import TPGroup, init_mesh, init_tp_group  # noqa

TOL = 1e-6


# ---------------------------------------------------------------------------
# chunk planning: identical to repro's
# ---------------------------------------------------------------------------


def test_v5e_copy_matches_repro():
    assert dataclasses.asdict(hw.V5E) == dataclasses.asdict(JV5E)
    assert hw.H100.inter_tier().hop_latency == hw.H100.dcn_latency


@pytest.mark.parametrize("ring", [2, 4, 8])
def test_plan_matches_repro(ring):
    for payload in (1e4, 3e6, 6.7e7, 2.1e9):
        for bidir in (False, True):
            for compute in (0.0, 1e-4, 5e-3):
                for tier in (JV5E, JV5E.inter_tier()):
                    kw = dict(compute_time=compute, bidirectional=bidir)
                    mine = hw.V5E if tier is JV5E else hw.V5E.inter_tier()
                    want = jcoord.plan(payload, ring, hw=tier, **kw)
                    got = coordination.plan(payload, ring, hw=mine, **kw)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want)
            assert dataclasses.asdict(coordination.schedule_metrics(
                payload, ring, 3, 1e-3, bidir, hw.V5E)) == \
                dataclasses.asdict(jcoord.schedule_metrics(
                    payload, ring, 3, 1e-3, bidir, JV5E))


@pytest.mark.parametrize("ring", [1, 2, 4, 8])
def test_plan_microbatches_matches_repro(ring):
    for batch in (1, 2, 3, 4, 8, 16):
        for payload in (1e5, 2e7, 4e8, 8e9):
            for mmax in (2, 4, 8):
                assert coordination.plan_microbatches(
                    batch, payload, ring, max_microbatches=mmax,
                    hw=hw.V5E) == jcoord.plan_microbatches(
                    batch, payload, ring, max_microbatches=mmax, hw=JV5E)


def test_port_plans_against_the_h100_by_default():
    assert coordination.plan(6.7e7, 4) == coordination.plan(6.7e7, 4,
                                                            hw=hw.H100)
    assert coordination.plan(6.7e7, 4) != coordination.plan(6.7e7, 4,
                                                            hw=hw.V5E)


# ---------------------------------------------------------------------------
# dataflow optimizer: the same structure as repro's
# ---------------------------------------------------------------------------


def _core(q, k, v):
    return q


def structure(g):
    return [(n.op, n.inputs, n.outputs, n.weights) for n in g.nodes]


def _builders(m, tpm):
    return {
        "sublayer": m.sublayer_graph(),
        "dual_sublayer": m.dual_sublayer_graph(),
        "block.gated": tpm.dense_block_graph(_core, True, "silu"),
        "block.plain": tpm.dense_block_graph(_core, False, "gelu"),
        "period.1": tpm.dense_period_graph([_core], True, "silu"),
        "period.2": tpm.dense_period_graph([_core] * 2, True, "silu"),
        "period.2.mb2": tpm.microbatch_period_graph(
            tpm.dense_period_graph([_core] * 2, True, "silu"), 2),
        "period.1.mb4": tpm.microbatch_period_graph(
            tpm.dense_period_graph([_core], True, "gelu"), 4),
        "merge.prefixed": m.merge_graphs([m.sublayer_graph(),
                                          m.dual_sublayer_graph()]),
    }


@pytest.mark.parametrize("case", sorted(_builders(jdf, jtp)))
def test_optimize_matches_repro(case):
    want = _builders(jdf, jtp)[case]
    got = _builders(df, tp_mod)[case]
    assert structure(got) == structure(want)        # the builders agree
    opt = df.optimize(got)
    assert structure(opt) == structure(jdf.optimize(want))
    assert structure(df.optimize(opt)) == structure(opt)   # idempotent
    if case.endswith("mb2") or case.endswith("mb4"):
        assert any(n.op == "overlap_asym" for n in opt.nodes)


@pytest.mark.parametrize("tp,kv", [(2, "sharded"), (4, "replicated")])
def test_period_graph_of_the_model_matches_repro(tp, kv):
    """The port's model-path builder (GQA with Hkv = 2: sharded KV at tp 2,
    replicated at tp 4) gives repro's dense period graph, and the weights
    it reads are this rank's shards."""
    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    from repro_torch.runtime import SMOKE

    cfg = get_arch("internlm2-1.8b").smoke().scaled(num_layers=2)
    group = TPGroup(1, tp, "gloo")          # no process group: no wire
    lm = LM(cfg, SMOKE, device="cpu", seed=None, group=group)
    tpc = tp_mod.TPContext(group=group, backend="cais")
    base, weights = tp_mod._period_graph(tpc, list(lm.blocks), cfg,
                                         ("attn", "attn"))
    want = jtp.dense_period_graph([_core] * 2, True, cfg.act)
    assert structure(base) == structure(want)
    for mb in (1, 2):
        assert structure(df.optimize(tp_mod.microbatch_period_graph(
            base, mb))) == structure(jdf.optimize(
                jtp.microbatch_period_graph(want, mb)))
    d, dh = cfg.d_model, cfg.resolved_head_dim
    kv_cols = cfg.num_kv_heads * dh // (tp if kv == "sharded" else 1)
    assert weights["b0.wq"].shape == (d, cfg.num_heads * dh // tp)
    assert weights["b1.wk"].shape == (d, kv_cols)
    assert weights["b0.wo"].shape == (cfg.num_heads * dh // tp, d)
    assert weights["b1.w_down"].shape == (cfg.d_ff // tp, d)


def _bad_graphs(m):
    N, G = m.Node, m.Graph
    return {
        "cycle": (lambda: G([N("x", "input"), N("a", "add", ("x", "b")),
                             N("b", "add", ("x", "a"))], ("a",)).validate(),
                  "cycle"),
        "missing_producer": (lambda: G(
            [N("x", "input"), N("g1", "gemm_col", ("nowhere",), ("w1",))],
            ("g1",)).validate(), "'g1'.*'nowhere'"),
        "missing_in_optimize": (lambda: m.optimize(G(
            [N("x", "input"), N("g1", "gemm_row", ("missing",), ("w1",)),
             N("rs", "reduce_scatter", ("g1",))], ("rs",))), "missing"),
        "unknown_output": (lambda: G([N("x", "input")],
                                     ("ghost",)).validate(), "ghost"),
        "duplicate_producer": (lambda: G(
            [N("x", "input"), N("a", "layernorm", ("x",), ("s",)),
             N("dup", "add", ("x", "x"), outputs=("a",))], ("a",)).validate(),
            "'a'"),
        "unknown_op": (lambda: N("n1", "bogus"), "bogus"),
        "duplicate_prefix": (lambda: m.merge_graphs(
            [m.sublayer_graph()] * 2, prefixes=["p.", "p."]), "duplicate"),
    }


@pytest.mark.parametrize("case", sorted(_bad_graphs(jdf)))
def test_graph_errors_match_repro(case):
    for m in (jdf, df):
        build, match = _bad_graphs(m)[case]
        with pytest.raises(m.GraphError, match=match):
            build()


def test_unported_paths_raise_with_their_roadmap_item():
    # the perfsim planner is ported: optimize plans as repro's does
    got = df.optimize(df.sublayer_graph(), planner="perfsim")
    want = jdf.optimize(jdf.sublayer_graph(), planner="perfsim")
    assert [(n.name, n.op) for n in got.nodes] == \
        [(n.name, n.op) for n in want.nodes]
    # meshes are ported (A14): a world of one factors into a 2D mesh whose
    # composite group the hier_* compositions run on, each equal to the
    # plain math on a group of one
    mesh = init_mesh(init_tp_group(1, 0, init_method="file:///nowhere"),
                     dp=1, tp_in=1, tp_out=1)
    assert mesh.is_2d and mesh.tp.size == mesh.data.size == 1
    g = mesh.tp
    rng = np.random.default_rng(0)
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, 4, 6), (6, 5)))
    cais = backends.CAISConfig(num_chunks=2)
    for name in ("barrier", "cais"):
        be = backends.get_backend(name)
        assert be.hierarchical(g) and not be.hierarchical(TPGroup(0, 1,
                                                                  "none"))
        for got in (be.hier_ag_gemm_multi(x, (w,), g, cais)[0],
                    be.hier_gemm_rs(x, w, g, cais),
                    be.hier_gemm_ar(x, w, g, cais),
                    be.hier_grad_ag_gemm(x, w, g, cais)[0],
                    be.hier_overlap_asymmetric((x, w), (x, w), g, cais)[1]):
            torch.testing.assert_close(got, x @ w, rtol=1e-6, atol=1e-6)
        send = x.reshape(1, 8, 6)       # one row: the tp_out ring of one
        out = be.hier_a2a_expert_ffn(send, lambda c: c @ w, g, cais)
        torch.testing.assert_close(out, send @ w)
        d, dws = be.hier_grad_a2a_expert_ffn(
            send, out, lambda c, gy: (gy @ w.T, (c.T @ gy,)), g, cais)
        torch.testing.assert_close(d, out @ w.T)
    # the production meshes need a multi-host launcher
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(NotImplementedError, match="multi-host|many hosts"):
        make_production_mesh()
    assert backends.available_backends() == ["auto", "barrier", "cais"]
    assert not backends.get_backend("auto").explicit


# ---------------------------------------------------------------------------
# ring schedules at gloo world 2 and 4 against unsharded math
# ---------------------------------------------------------------------------


def _data(n):
    rng = np.random.default_rng(n)
    B, S, d, F = 2, 8 * n, 16, 24
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(B, S, d), w=f(d, F) * 0.1, x2=f(B, S, d),
                w2=f(d, F) * 0.1, xo=f(B, 3 * n, d), scale=f(F) * 0.1,
                wu=f(F, d) * 0.1)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ring(request):
    n = request.param
    data = _data(n)
    return n, data, run_ranks(cells.primitive_cells, n, data)


def _rms(z, s):
    return z / np.sqrt((z * z).mean(-1, keepdims=True) + 1e-6) * (1 + s)


def _expected(data):
    """cell -> (unsharded result, how the ranks' outputs assemble): "seq"
    concatenates rank outputs on dim 1, "feat" on the last dim, "full"
    means every rank holds the whole result."""
    x, w, x2, w2, xo = (data[k] for k in ("x", "w", "x2", "w2", "xo"))
    ref = x @ w
    z = ref
    seam = _rms(z, data["scale"]) @ data["wu"]
    want = {}
    for c, b in cells.RING_CHUNKS:
        want[f"ag_gemm.c{c}.b{int(b)}"] = (ref, "feat")
        want[f"gemm_rs.c{c}.b{int(b)}"] = (ref, "seq")
    want.update({
        "ag_gemm_multi": (None, "multi"),
        "gemm_ar": (ref, "full"),
        "overlap_asym.rs": (ref, "seq"),
        "overlap_asym.ag": (x2 @ w2, "feat"),
        "overlap_asym.multi": (None, "multi2"),
        "ring_all_gather": (x, "full"),
        "ring_reduce_scatter": (None, "rsum"),
        "barrier_ag_gemm": (ref, "feat"),
        "barrier_gemm_rs": (ref, "seq"),
        "barrier_gemm_ar": (ref, "full"),
    })
    for b in (0, 1):
        want[f"odd.gemm_rs.b{b}"] = (xo @ w, "seq")
        want[f"odd.ag_gemm.b{b}"] = (xo @ w, "feat")
        want[f"odd.ring_reduce_scatter.b{b}"] = (None, "rsum_odd")
        want[f"odd.ring_all_gather.b{b}"] = (xo, "full")
    for name in ("barrier", "cais"):
        want[f"fused_rs_ln_ag.{name}"] = (seam, "feat")
        want[f"fused_rs_ln_ag.{name}.z"] = (z, "seq")
        want[f"dataflow.sublayer.{name}"] = (seam, "feat")
        want[f"dataflow.dual.{name}.rs"] = (ref, "seq")
        want[f"dataflow.dual.{name}.ag"] = (x2 @ w2, "feat")
    return want


CELLS = sorted(_expected(_data(2)))


def test_every_cell_is_checked(ring):
    assert sorted(set(ring[2][0]) - {"_jax_imported"}) == CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_ring_schedule_matches_unsharded(ring, cell):
    n, data, outs = ring
    want, how = _expected(data)[cell]
    got = [o[cell] for o in outs]
    if how == "seq":
        got = np.concatenate(got, axis=1)
    elif how == "feat":
        got = np.concatenate(got, axis=-1)
    elif how == "full":
        for g in got[1:]:
            np.testing.assert_allclose(g, got[0], rtol=0, atol=TOL)
        got = got[0]
    elif how in ("multi", "multi2"):
        # per rank: [x @ w_r | x(2) @ w2_r (| x2 @ w_r)] on the last dim
        x, w, x2, w2 = (data[k] for k in ("x", "w", "x2", "w2"))
        a = x if how == "multi" else x2
        ws = (w, w2) if how == "multi" else (w2, w)
        F = w.shape[1] // n
        parts = [np.concatenate([g[..., k * F:(k + 1) * F] for g in got],
                                axis=-1) for k in range(2)]
        got = np.concatenate(parts, axis=-1)
        want = np.concatenate([a @ ws[0], a @ ws[1]], axis=-1)
    else:
        # reduce-scatter of the same full x on every rank: n * x, seq-split
        src = data["x"] if how == "rsum" else data["xo"]
        got = np.concatenate(got, axis=1)
        want = n * src
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_ranks_import_no_jax(ring):
    _, _, outs = ring
    assert "jax" in sys.modules                 # this process did
    assert [bool(o["_jax_imported"]) for o in outs] == [False] * len(outs)
