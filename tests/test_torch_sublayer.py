"""TP training past whole blocks against the JAX package on the CPU, in f32:
the port's counterpart of ``tests/multidev_checks.py``'s
``sp_ffn.{graph_vs_handfused,planned_chunks}``,
``sp_attention.{graph_vs_handfused,gqa_replicated_kv}``, the split-block
composition, ``decode.ragged_s_*`` and ``train_grad.decode_gemm_ar.*``
cells, on gloo rings of 2 and 4 ranks at smoke widths, each held to JAX on
one device (forward within 1e-5, grads within ``GRAD_RTOL`` of each
tensor's max):

- ``sp_ffn`` and ``sp_attention`` (one-sub-layer periods with their
  graph-built backward), sequence-sharded and in the replicated layout,
  ``barrier`` and ``cais`` (fixed and planned chunks), K/V sharded and
  replicated; ``sp_ffn`` also on a 2D mesh (tp_in 2 x tp_out 2);
- the split composition against JAX's block and the ring's whole-block
  graph (within 1e-6, multidev_checks' pin);
- an MLA block (its mixer replicated: the normed rows gathered, the whole
  mixer run, this rank's rows kept; its FFN through ``sp_ffn``) and a
  minicpm3-4b ``LM.loss`` with every grad against ``jax.value_and_grad``;
- an MoE with E = 2 experts on 4 ranks (``sp_attention`` + the replicated
  MoE) as a whole ``LM.loss``;
- ``LM.loss`` and grads at S = 1 and S = 3 (the ragged, replicated layout),
  and of an MoE at S = 31 on 2 ranks (its replicated-layout MoE graph);
- ``sequence_parallel=False`` equal to ``True``;
- every run's kernel calls equal to ``tp.step_launches``, derived from
  the graphs its forward recorded (``tp.recording``);
- MoE at ragged S running (it raised before); the launcher's ``--mesh
  debug`` on minicpm3-4b against ``--mesh none``;
- matmul_rmsnorm differentiable where its forward is not (the CUDA kernel
  writes through ctypes): an MLA block's latent-norm grads with a
  non-differentiable stand-in forward, against ``jax.grad``; and
  ``ops.matmul``, which has no gradient, raising where autograd records.

The ranks run in their own processes (``tests/torch_sublayer_cells.py``, no
JAX), one spawn per world size, both started with the module's first test
while this process computes the JAX references."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.attention import attention_forward  # noqa: E402
from repro.models.layers import activation as jactivation  # noqa: E402
from repro.models.layers import apply_norm as japply_norm  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402

import torch_sublayer_cells as cells  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.tp import param_shard_dim  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.transformer import block_forward  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from repro_torch.sharding import TPGroup  # noqa: E402

ATOL = 1e-5                 # forward, f32
GRAD_RTOL = 1e-5            # per tensor: 1e-5 * max(1, max|g|)
SPLIT_TOL = 1e-6            # split composition against the whole block
WORLDS = (2, 4)
D, D_FF = 32, 96
MLA_ARCH, DENSE_ARCH, MOE_ARCH = "minicpm3-4b", "internlm2-1.8b", \
    "mixtral-8x7b"


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, *shape, scale=0.1):
    return (scale * _rng(seed).standard_normal(shape)).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _both(arch, **over):
    """(JAX cfg, port cfg) of ``arch``'s smoke config with ``over``."""
    moe = over.pop("moe", None)
    j, t = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    if moe:
        import dataclasses
        j = j.scaled(moe=dataclasses.replace(j.moe, **moe))
        t = t.scaled(moe=dataclasses.replace(t.moe, **moe))
    return j.scaled(**over), t.scaled(**over)


def _grad_close(got, want, name=""):
    bound = GRAD_RTOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= bound, (name, err, bound)


# ---------------------------------------------------------------------------
# cases and their JAX references (one device)
# ---------------------------------------------------------------------------


def _act_x(seed):
    """x and an output cotangent, (2, 16, D) and their first 3 rows."""
    x, gy = _normal(seed, 2, 16, D, scale=1.0), _normal(seed + 1, 2, 16, D)
    return dict(x=x, gy=gy, x3=x[:, :3].copy(), gy3=gy[:, :3].copy())


@functools.lru_cache(maxsize=None)
def ffn_case():
    d = _act_x(40)
    d.update(ns=_normal(42, D) + 1.0, wu=_normal(43, D, D_FF),
             wg=_normal(44, D, D_FF), wd=_normal(45, D_FF, D))
    return d


def _ffn_ref(x, ns, wu, wg, wd):
    xn = japply_norm("rmsnorm", {"scale": ns}, x)
    return (jactivation("silu", xn @ wg) * (xn @ wu)) @ wd


@functools.lru_cache(maxsize=None)
def attn_cfgs(n):
    """{"dense": 4 kv heads (sharded), "gqa": kv heads that do not split
    over ``n`` ranks (replicated)}: (JAX cfg, port cfg)."""
    kw = dict(num_layers=1, d_model=D, num_heads=4, head_dim=8, d_ff=D_FF)
    return {"dense": _both("deepseek-7b", num_kv_heads=4, **kw),
            "gqa": _both("deepseek-7b", num_kv_heads=max(n // 2, 1) if n > 2
                         else 1, **kw)}


@functools.lru_cache(maxsize=None)
def attn_case(n, label):
    _, tc = attn_cfgs(n)[label]
    kv = tc.num_kv_heads * 8
    d = _act_x(50)
    d.update(ns=_normal(52, D) + 1.0, wq=_normal(53, D, 32),
             wk=_normal(54, D, kv), wv=_normal(55, D, kv),
             wo=_normal(56, 32, D))
    return d


def _vjp(f, args, gy):
    """(f(*args), the grads of <f(*args), gy>), compiled once."""
    def both(a, g):
        y, pull = jax.vjp(f, *a)
        return y, pull(g)

    y, grads = jax.jit(both)(jax.tree.map(jnp.asarray, tuple(args)),
                             jnp.asarray(gy))
    return np.asarray(y), [_np(g) for g in grads]


@functools.lru_cache(maxsize=None)
def jax_ffn(layout):
    d = ffn_case()
    S = "" if layout == "sharded" else "3"
    return _vjp(_ffn_ref, (d["x" + S], d["ns"], d["wu"], d["wg"], d["wd"]),
                d["gy" + S])


def jax_attn(n, label, layout):
    return _jax_attn(attn_cfgs(n)[label][1].num_kv_heads, label, layout)


@functools.lru_cache(maxsize=None)
def _jax_attn(kv, label, layout):
    n = 2 if label == "gqa" and kv == 1 else 4
    jc, _ = attn_cfgs(n)[label]
    d = attn_case(n, label)
    S = "" if layout == "sharded" else "3"

    def f(x, ns, wq, wk, wv, wo):
        xn = japply_norm("rmsnorm", {"scale": ns}, x)
        return attention_forward({"wq": wq, "wk": wk, "wv": wv, "wo": wo},
                                 xn, jc)

    return _vjp(f, [d[k] for k in ("x" + S, "ns", "wq", "wk", "wv", "wo")],
                d["gy" + S])


def _block_tree(kind, jc, seed):
    """A ``repro`` block's parameters with random norm scales (MLA's latent
    norms too), as numpy."""
    tree = _np(jax.jit(lambda k: jtr.init_block(k, kind, jc, jnp.float32))(
        jax.random.key(seed)))
    for mod in ("norm1", "norm2"):
        tree[mod]["scale"] = _normal(seed + 1, *tree[mod]["scale"].shape)
    if kind == "mla":
        for k in ("q_norm", "kv_norm"):
            tree["mixer"][k] = _normal(seed + 2, *tree["mixer"][k].shape)
    return tree


@functools.lru_cache(maxsize=None)
def split_case():
    jc, tc = attn_cfgs(4)["dense"]
    return (jc, tc, _block_tree("attn", jc, 60),
            _normal(63, 2, 16, D, scale=1.0))


@functools.lru_cache(maxsize=None)
def mla_case():
    jc, tc = _both(MLA_ARCH)
    x = _normal(71, 2, 16, tc.d_model, scale=1.0)
    return jc, tc, _block_tree("mla", jc, 70), x, _normal(72, *x.shape)


@functools.lru_cache(maxsize=None)
def jax_block(kind, which):
    """(out, (dx, dparams)) of JAX's one-device block_forward, the grads of
    <out, gy>."""
    jc, _, tree, x, *gy = mla_case() if which == "mla" else split_case()
    gy = gy[0] if gy else np.zeros_like(x)

    def f(x_, p):
        return jtr.block_forward(kind, p, x_, jc, JAX_SMOKE)[0]

    y, (dx, dp) = _vjp(f, (x, tree), gy)
    return y, dx, _np(dp)


# LM cases: (arch, overrides, tokens shape, runs (mode, mb, sp), worlds)
LM_CASES = {
    "mla": (MLA_ARCH, {}, (2, 16),
            [("barrier", 1, True), ("cais", 2, True), ("cais", 1, False)],
            WORLDS),
    "dense_s1": (DENSE_ARCH, {}, (2, 1),
                 [("barrier", 1, True), ("cais", 1, True)], WORLDS),
    "dense_s3": (DENSE_ARCH, {}, (2, 3),
                 [("barrier", 1, True), ("cais", 1, True)], WORLDS),
    "dense_sp": (DENSE_ARCH, {}, (2, 16),
                 [("cais", 2, True), ("cais", 2, False)], WORLDS),
    # E = 2 on 4 ranks: the experts replicate; a rank's 16 tokens are one
    # device's routing group of 16 (capacity factor 8: no drops)
    "moe_e2": (MOE_ARCH, dict(moe={"num_experts": 2,
                                   "capacity_factor": 8.0}), (1, 64),
               [("barrier", 1, True), ("cais", 1, True)], (4,)),
    # an MoE at S % tp != 0: the replicated layout's MoE graph (every rank
    # routes the whole batch, its experts summed by one all-reduce)
    "moe_ragged": (MOE_ARCH, {}, (1, 31), [("cais", 1, True)], (2,)),
}


@functools.lru_cache(maxsize=None)
def lm_case(label):
    arch, over, shape, _, _ = LM_CASES[label]
    jc, tc = _both(arch, **dict(over))
    params = _np(jax.jit(jax_build_model(jc, JAX_SMOKE).init)(
        jax.random.key(0)))
    toks = _rng(80 + len(label)).integers(0, tc.vocab_size, shape).astype(
        np.int32)
    return jc, tc, params, toks


@functools.lru_cache(maxsize=None)
def jax_lm(label):
    jc, tc, params, toks = lm_case(label)
    t = jnp.asarray(toks)
    loss, grads = jax.jit(jax.value_and_grad(
        jax_build_model(jc, JAX_SMOKE).loss))(params,
                                              {"tokens": t, "labels": t})
    g = bridge.state_dict_from_jax(_np(grads), tc)
    return float(loss), {k: v.numpy() for k, v in g.items()}


# ---------------------------------------------------------------------------
# the spawns
# ---------------------------------------------------------------------------


def _data(n):
    jc, tc, tree, x = split_case()
    _, mtc, mtree, mx, mgy = mla_case()
    data = {"ffn": ffn_case(),
            "attn": {lab: (attn_cfgs(n)[lab][1], attn_case(n, lab))
                     for lab in ("dense", "gqa")},
            "split": (tc, tree, x), "mla": (mtc, mtree, mx, mgy),
            "lm": {lab: (lm_case(lab)[1], lm_case(lab)[2], lm_case(lab)[3],
                         c[3])
                   for lab, c in LM_CASES.items() if n in c[4]}}
    if n == 4:
        data["ffn_2d"] = ffn_case()
    return data


@functools.lru_cache(maxsize=None)
def _spawns():
    """Both spawns started at once in threads, so the ranks run while this
    process computes the JAX references."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(len(WORLDS))
    futures = {n: pool.submit(run_ranks, cells.sublayer_cells, n, _data(n))
               for n in WORLDS}
    pool.shutdown(wait=False)
    return futures


@pytest.fixture(scope="module", autouse=True)
def _start_spawns():
    _spawns()


def ring(n):
    return _spawns()[n].result()


# ---------------------------------------------------------------------------
# sp_ffn, sp_attention, the split block
# ---------------------------------------------------------------------------

FFN_RUNS = [(lay, m, c) for lay in ("sharded", "replicated")
            for m, c in (("barrier", 2), ("cais", 2), ("cais", None))]


def _check_ffn(res, run, key="ffn"):
    lay, _, _ = run
    sharded = lay == "sharded"
    y, (dx, dns, dwu, dwg, dwd) = jax_ffn(lay)
    got = [r[key][run] for r in res]
    outs = [g[0] for g in got]
    dxs = [g[1] for g in got]
    if sharded:
        np.testing.assert_allclose(np.concatenate(outs, 1), y, atol=ATOL,
                                   rtol=0)
        _grad_close(np.concatenate(dxs, 1), dx, "dx")
    else:
        for o, g in zip(outs, dxs):
            np.testing.assert_allclose(o, y, atol=ATOL, rtol=0)
            _grad_close(g, dx, "dx")
    for g in got:                       # the norm scale: whole on each rank
        _grad_close(g[2][0], dns, "scale")
    for i, (want, dim) in enumerate(((dwu, 1), (dwg, 1), (dwd, 0)), 1):
        _grad_close(np.concatenate([g[2][i] for g in got], dim), want,
                    f"w{i}")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("run", FFN_RUNS,
                         ids=[f"{a}-{b}-c{c}" for a, b, c in FFN_RUNS])
def test_sp_ffn_matches_jax(n, run):
    """``sp_ffn.{graph_vs_handfused,planned_chunks}`` (1e-5) and its grads:
    x, the norm scale (summed over the ring where sequence-sharded, whole
    on each rank in the replicated layout), the column-sharded up/gate and
    row-sharded down."""
    _check_ffn(ring(n), run)


@pytest.mark.parametrize("run", FFN_RUNS,
                         ids=[f"{a}-{b}-c{c}" for a, b, c in FFN_RUNS])
def test_sp_ffn_on_the_2d_mesh_matches_jax(run):
    """``sp_ffn`` on tp_in 2 x tp_out 2 of a world of 4 (the hierarchical
    compositions; the shards by the composite index)."""
    _check_ffn(ring(4), run, key="ffn_2d")


ATTN_RUNS = [(lab, lay, m) for lab in ("dense", "gqa")
             for lay in ("sharded", "replicated") for m in cells.MODES]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("run", ATTN_RUNS,
                         ids=["-".join(r) for r in ATTN_RUNS])
def test_sp_attention_matches_jax(n, run):
    """``sp_attention.{graph_vs_handfused,gqa_replicated_kv}`` (1e-5) and
    its grads; replicated wk/wv are summed over the ring in both layouts (a
    rank's core reads only the kv heads its q heads use)."""
    label, lay, _ = run
    sharded = lay == "sharded"
    _, tc = attn_cfgs(n)[label]
    assert (label == "gqa") == (tc.num_kv_heads % n != 0)
    y, (dx, dns, dwq, dwk, dwv, dwo) = jax_attn(n, label, lay)
    got = [r["attn"][run] for r in ring(n)]
    if sharded:
        np.testing.assert_allclose(np.concatenate([g[0] for g in got], 1), y,
                                   atol=ATOL, rtol=0)
        _grad_close(np.concatenate([g[1] for g in got], 1), dx, "dx")
    else:
        for g in got:
            np.testing.assert_allclose(g[0], y, atol=ATOL, rtol=0)
            _grad_close(g[1], dx, "dx")
    kv_dim = 1 if label == "dense" else None
    for i, (want, dim) in enumerate(((dns, None), (dwq, 1), (dwk, kv_dim),
                                     (dwv, kv_dim), (dwo, 0))):
        parts = [g[2][i] for g in got]
        if dim is None:
            for p in parts:
                _grad_close(p, want, f"w{i}")
        else:
            _grad_close(np.concatenate(parts, dim), want, f"w{i}")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", cells.MODES)
def test_split_composition_matches_the_block(n, mode):
    """``x + sp_attention`` then ``+ sp_ffn`` on the ring: JAX's one-device
    block within 1e-5, and the ring's whole-block graph within 1e-6."""
    want = jax_block("attn", "split")[0]
    got = [r["split"][mode] for r in ring(n)]
    split = np.concatenate([g[0] for g in got], 1)
    whole = np.concatenate([g[1] for g in got], 1)
    np.testing.assert_allclose(split, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(split, whole, atol=SPLIT_TOL, rtol=0)


# ---------------------------------------------------------------------------
# MLA: a block and a whole LM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", cells.MODES)
def test_mla_block_matches_jax(n, mode):
    """An MLA block on the ring (the mixer replicated over gathered rows,
    the FFN through ``sp_ffn``): output, dx and every parameter's grad
    against ``jax.vjp`` of JAX's one-device block; the mixer's grads are
    partial on each rank, and their sum over the ring equals JAX's, once
    (not multiplied by the ring size)."""
    _, tc, _, _, _ = mla_case()
    y, dx, dp = jax_block("mla", "mla")
    got = [r["mla"][mode] for r in ring(n)]
    np.testing.assert_allclose(np.concatenate([g[0] for g in got], 1), y,
                               atol=ATOL, rtol=0)
    _grad_close(np.concatenate([g[1] for g in got], 1), dx, "dx")
    for mod, leaves in dp.items():
        for leaf, want in leaves.items():
            k = f"{mod}.{leaf}"
            dim = param_shard_dim("blocks.0." + k, tc, n)
            parts = [g[2][k] for g in got]
            if dim is None:
                for p in parts:
                    _grad_close(p, want, k)
            else:
                _grad_close(np.concatenate(parts, dim), want, k)


LM_RUNS = [(lab, n, run) for lab, c in LM_CASES.items() for n in c[4]
           for run in c[3]]


@pytest.mark.parametrize("label,n,run", LM_RUNS,
                         ids=[f"{lab}-world{n}-{m}-mb{mb}-sp{int(sp)}"
                              for lab, n, (m, mb, sp) in LM_RUNS])
def test_lm_loss_and_grads_match_jax(label, n, run):
    """``LM.loss`` and every grad after ``sync_grads`` against
    ``jax.value_and_grad`` of JAX's one-device loss: minicpm3-4b (MLA
    blocks sub-layer by sub-layer), internlm2-1.8b at S = 1 and S = 3 (the
    replicated layout: nothing outside the graphs is summed) and with
    ``sequence_parallel`` on and off, an E = 2 MoE on 4 ranks (its experts
    replicated, their grads summed over the ring), mixtral-8x7b at S = 31
    on 2 ranks (the replicated layout's MoE graph). The loss within 1e-5
    relative, every rank's the same; each rank's kernel calls (matmul,
    flash, matmul_rmsnorm) equal to ``tp.step_launches``."""
    loss, want = jax_lm(label)
    _, tc, _, toks = lm_case(label)
    res = [r["lm"][(label, *run)] for r in ring(n)]
    assert len({r[0] for r in res}) == 1
    assert abs(res[0][0] - loss) <= 1e-5 * abs(loss)
    for name, g_ref in want.items():
        dim = param_shard_dim(name, tc, n)
        parts = [r[1][name] for r in res]
        if dim is None:
            for p in parts:
                _grad_close(p, g_ref, name)
        else:
            _grad_close(np.concatenate(parts, dim), g_ref, name)
    layout = ("replicated" if toks.shape[1] % n else
              "sharded" if run[2] else "gathered")
    for r in res:
        made, derived = r[2], r[3]
        assert derived["layout"] == layout
        for k in ("matmul", "flash", "matmul_rmsnorm"):
            assert made[k] == derived[k], (k, made, derived)
    if label == "mla":
        assert res[0][2]["matmul_rmsnorm"] == 2 * tc.num_layers
        assert res[0][2]["flash"] == tc.num_layers


@pytest.mark.parametrize("n", WORLDS)
def test_sequence_parallel_off_equals_on(n):
    """``TPConfig(sequence_parallel=False)`` keeps the activation whole
    between periods, each taking its rows and gathering its output; the
    values are the same: loss within 1e-6 relative, grads within
    ``GRAD_RTOL``."""
    for label, on, off in (("dense_sp", ("cais", 2, True),
                            ("cais", 2, False)),
                           ("mla", ("cais", 2, True), ("cais", 1, False))):
        for r in ring(n):
            a, b = r["lm"][(label, *on)], r["lm"][(label, *off)]
            assert abs(a[0] - b[0]) <= 1e-6 * abs(a[0])
            for k in a[1]:
                _grad_close(b[1][k], a[1][k], k)


def test_sublayer_rank_cells_import_no_jax():
    assert not any(r["_jax_imported"] for n in WORLDS for r in ring(n))


# ---------------------------------------------------------------------------
# what still raises; the launcher
# ---------------------------------------------------------------------------


def test_moe_at_ragged_s_raises_by_name():
    """MoE at S % tp != 0 (JAX runs it replicated under GSPMD), which
    raised until the replicated layout had an MoE graph (ROADMAP A11 (b)),
    now runs: ``LM.loss`` of mixtral-8x7b's smoke config at S 31 on a ring
    of 2 (the ``moe_ragged`` case) returns one finite loss on every rank,
    held to JAX by ``test_lm_loss_and_grads_match_jax``."""
    res = [r["lm"][("moe_ragged", "cais", 1, True)] for r in ring(2)]
    assert len({r[0] for r in res}) == 1
    assert np.isfinite(res[0][0])
    assert res[0][3]["layout"] == "replicated"


def test_launcher_mesh_debug_trains_minicpm():
    """``launch.train --arch minicpm3-4b --smoke --mesh debug`` (8 ranks,
    data 2 x model 4, MLA blocks sub-layer by sub-layer): every rank's
    three losses within 1e-5 of ``--mesh none``'s."""
    from repro_torch.launch import train as train_launch

    argv = ["--arch", MLA_ARCH, "--smoke", "--device", "cpu", "--steps", "3",
            "--tp-mode", "cais"]
    one = train_launch.main(argv)
    run = train_launch.main(argv + ["--mesh", "debug"])
    assert len(run.ranks) == 8 and len(one.history) == 3
    for h in run.ranks:
        assert len(h) == 3
        for a, b in zip(h, one.history):
            assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])


# ---------------------------------------------------------------------------
# the repair: matmul_rmsnorm differentiable on every device
# ---------------------------------------------------------------------------


def _standin(a, b, scale, eps, out_dtype):
    """The CUDA kernel's contract on the CPU: the values of the plain
    version, and no ``grad_fn`` (the kernel writes through ctypes)."""
    from repro_torch.kernels import ref

    with torch.no_grad():
        return ref.matmul_rmsnorm_ref(a, b, scale, eps, out_dtype)


def test_mla_grads_survive_a_nondifferentiable_norm_forward(monkeypatch):
    """With matmul_rmsnorm's forward replaced by a stand-in that is not
    differentiable, as the CUDA kernel is not, an MLA block's grads of
    q_norm, kv_norm, wq_a and wkv_a (its KV-latent columns through the
    column slice, the rope columns through the plain product) and of x
    still equal ``jax.vjp``'s: the backward is the VJP of the plain
    version (``ops._MatmulRMSNorm``). The wrapper itself records that
    node, so the test does not hang on the stand-in's seam alone."""
    monkeypatch.setattr(ops, "_matmul_rmsnorm_forward", _standin)
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 8, generator=g).requires_grad_(True)
    out = ops.matmul_rmsnorm(a, torch.randn(8, 4, generator=g),
                             torch.zeros(4))
    assert type(out.grad_fn).__name__ == "_MatmulRMSNormBackward"
    _, tc, tree, x, gy = mla_case()
    blk = cells._block("mla", tc, tree, TPGroup(0, 1, "gloo"))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = block_forward("mla", blk, xt, tc)
    y.backward(torch.from_numpy(gy))
    want_y, want_dx, dp = jax_block("mla", "mla")
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=ATOL, rtol=0)
    _grad_close(xt.grad.numpy(), want_dx, "dx")
    grads = dict(blk.named_parameters())
    for leaf in ("q_norm", "kv_norm", "wq_a", "wkv_a"):
        g = grads[f"mixer.{leaf}"].grad
        assert g is not None and float(g.abs().max()) > 0, leaf
        _grad_close(g.numpy(), dp["mixer"][leaf], leaf)


def test_matmul_rmsnorm_grad_lands_in_its_column_slice():
    """b a column slice of a wider weight: the grad fills that slice of the
    weight's grad and leaves the other columns 0."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(6, 8, generator=g)
    w = torch.randn(8, 12, generator=g).requires_grad_(True)
    scale = (0.1 * torch.randn(5, generator=g)).requires_grad_(True)
    ops.matmul_rmsnorm(a, w[:, :5], scale).square().sum().backward()
    assert float(w.grad[:, :5].abs().max()) > 0
    assert float(w.grad[:, 5:].abs().max()) == 0.0
    assert scale.grad is not None


def test_matmul_raises_where_autograd_records():
    """``ops.matmul`` has no gradient of its own (the graph-built backward
    calls it for every dx and dw), so it refuses an input that requires
    grad where autograd records, on every device, and runs elsewhere."""
    a = torch.randn(4, 8)
    w = torch.randn(8, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.matmul(a, w)
    with torch.no_grad():
        np.testing.assert_allclose(ops.matmul(a, w).numpy(),
                                   (a @ w).detach().numpy(), atol=1e-6)
    assert ops.matmul(a, w.detach()).shape == (4, 3)


def test_loss_chunks_need_not_divide_the_sequence():
    """At a sequence that ``loss_chunk`` does not divide (S = 67, a prime:
    JAX's scan runs 67 one-token chunks), the port's chunks are 64 and 3:
    the same loss as JAX's within 1e-5 relative."""
    jc, tc = _both(DENSE_ARCH)
    params = _np(jax.jit(jax_build_model(jc, JAX_SMOKE).init)(
        jax.random.key(0)))
    toks = _rng(90).integers(0, tc.vocab_size, (2, 67)).astype(np.int32)
    t = jnp.asarray(toks)
    want = float(jax.jit(jax_build_model(jc, JAX_SMOKE).loss)(
        params, {"tokens": t, "labels": t}))
    lm = LM(tc, Runtime(compute_dtype="float32", remat=False, loss_chunk=64),
            device="cpu", seed=None)
    bridge.load_jax_params(lm, params)
    tt = torch.from_numpy(toks)
    got = float(lm.loss({"tokens": tt, "labels": tt}))
    assert abs(got - want) <= 1e-5 * abs(want)
