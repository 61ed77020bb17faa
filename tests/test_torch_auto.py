"""The ``auto`` TP mode (DTensor placements over the one-device code) against
the JAX package on the CPU, in f32, on gloo rings of 2 and 4 ranks at smoke
widths:

- ``LM.loss`` and every grad after ``sync_grads`` on internlm2-1.8b,
  deepseek-7b and gemma3-1b (its one kv head whole on every rank, each rank
  attending with the kv heads of its own query heads; internlm2-1.8b's two
  over 4 ranks likewise, and 12 query heads over 3 kv heads, which a rank's
  query heads span unevenly), against ``jax.value_and_grad`` of JAX's
  one-device loss (JAX's ``auto`` gives the one-device values on a mesh):
  sequence-sharded, with ``sequence_parallel=False``, with remat, at S = 1
  and a ragged S = 3 (the activation whole), on tp_in 2 x tp_out 2 and on
  data 2 x model 2 of 4 ranks; and against the port's ``barrier`` / ``cais``
  on the same ring at ``multidev_checks``' 1e-4 (``model.auto_vs_barrier``);
- ``block_forward`` at S = 1 and S = 3 against ``cais`` at 1e-4
  (``decode.s1_block_parity``, ``decode.ragged_s_parity``) and JAX's block;
- one AdamW step equal to one device's, element-wise;
- the collectives DTensor issues in the sharded layout: one all-gather in
  and one reduce-scatter out a sub-layer in the forward, their adjoints
  and one all-reduce a replicated norm scale in the backward;
- the step with DTensor's collectives staged through the host (the path a
  gloo group takes on the card) bitwise the unstaged one;
- every block kind and entry point outside the slice raising by name
  (ROADMAP A5 (b)) before any collective.

The ranks run in their own processes (``tests/torch_auto_cells.py``, no
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
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402

import torch_auto_cells as cells  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.tp import param_shard_dim  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import LM, build_model  # noqa: E402
from repro_torch.runtime import Runtime, TPConfig  # noqa: E402
from repro_torch.serve import DenseEngine, Engine  # noqa: E402
from repro_torch.sharding import TPGroup  # noqa: E402

WORLDS = (2, 4)
LOSS_RTOL = 1e-5            # f32 loss against JAX
GRAD_PIN = 1e-6             # per tensor: 1e-6 * max(1, max|g|)
PARITY = 1e-4               # multidev_checks.check: auto against barrier
FLAT = [("auto", True, False, "flat"), ("barrier", True, False, "flat")]
RAGGED = [("auto", True, False, "flat"), ("cais", True, False, "flat")]
# label: (arch, config overrides, tokens shape, runs (mode,
# sequence_parallel, remat, mesh) on every world, more runs at world 4)
LM_CASES = {
    "internlm2": ("internlm2-1.8b", {}, (2, 32),
                  FLAT + [("auto", False, False, "flat"),
                          ("auto", True, True, "flat")],
                  [("auto", True, False, "2x2"),
                   ("auto", True, False, "dp2")]),
    "deepseek": ("deepseek-7b", {}, (2, 32), FLAT, []),
    "gemma3": ("gemma3-1b", {}, (2, 32), FLAT, []),
    # 12 query heads over 3 kv heads: a rank's query heads span kv heads
    # unevenly (6 over 2 and 3 over 4 ranks), so each takes one kv copy a
    # query head
    "gqa12x3": ("internlm2-1.8b", dict(num_heads=12, num_kv_heads=3),
                (2, 32), FLAT, []),
    "s1": ("internlm2-1.8b", {}, (2, 1), RAGGED, []),
    "ragged": ("internlm2-1.8b", {}, (2, 3), RAGGED, []),
}
BLOCK_SEQS = (1, 3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_cfg(label):
    arch, over = LM_CASES[label][:2]
    return jax_get_arch(arch).smoke().scaled(**over)


@functools.lru_cache(maxsize=None)
def lm_case(label):
    """(port cfg, numpy params, tokens) of ``label``."""
    arch, over, shape, _, _ = LM_CASES[label]
    params = _np(jax.jit(jax_build_model(jax_cfg(label), JAX_SMOKE).init)(
        jax.random.key(0)))
    toks = np.random.default_rng(90 + len(label)).integers(
        0, 256, shape).astype(np.int32)
    return get_arch(arch).smoke().scaled(**over), params, toks


@functools.lru_cache(maxsize=None)
def jax_lm(label):
    """(loss, {param: grad}) of ``jax.value_and_grad`` of JAX's one-device
    ``LM.loss``."""
    tc, params, toks = lm_case(label)
    t = jnp.asarray(toks)
    loss, grads = jax.jit(jax.value_and_grad(jax_build_model(
        jax_cfg(label), JAX_SMOKE).loss))(
        params, {"tokens": t, "labels": t})
    g = bridge.state_dict_from_jax(_np(grads), tc)
    return float(loss), {k: v.numpy() for k, v in g.items()}


def _block_xs():
    rng = np.random.default_rng(95)
    return [rng.standard_normal((2, S, 64)).astype(np.float32)
            for S in BLOCK_SEQS]


@functools.lru_cache(maxsize=None)
def jax_blocks():
    """JAX's one-device ``block_forward`` of internlm2's block 0 at each
    sequence of ``BLOCK_SEQS``."""
    tc, params, _ = lm_case("internlm2")
    cfg = jax_get_arch("internlm2-1.8b").smoke()
    tree = bridge.unstack_layers(params["stack"], tc)[0]
    out = {}
    for x in _block_xs():
        y, _ = jtr.block_forward(cfg.layer_kinds()[0], tree, jnp.asarray(x),
                                 cfg, JAX_SMOKE)
        out[x.shape[1]] = np.asarray(y)
    return out


def _data(n):
    lm = {lab: (*lm_case(lab), c[3] + (c[4] if n == 4 else []))
          for lab, c in LM_CASES.items()}
    cfg, params, toks = lm_case("internlm2")
    return {"lm": lm, "blocks": (cfg, params, _block_xs()),
            "adamw": (cfg, params, toks), "staged": "internlm2"}


@functools.lru_cache(maxsize=None)
def _spawns():
    """Both spawns started at once in threads, so the ranks run while this
    process computes the JAX references."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(len(WORLDS))
    futures = {n: pool.submit(run_ranks, cells.auto_cells, n, _data(n))
               for n in WORLDS}
    pool.shutdown(wait=False)
    return futures


@pytest.fixture(scope="module", autouse=True)
def _start_spawns():
    _spawns()


def ring(n):
    return _spawns()[n].result()


def _close(got, want, rtol, name=""):
    bound = rtol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= bound, (name, err, bound)


def _whole(res, name, cfg, n):
    """One parameter's grad made whole from the ranks' (rank order = the
    composite index on a 2D mesh; a replica's TP ranks on a data axis)."""
    dim = param_shard_dim(name, cfg, n)
    parts = [r[name] for r in res]
    return parts if dim is None else [np.concatenate(parts, dim)]


LM_RUNS = [(lab, n, run) for lab, c in LM_CASES.items() for n in WORLDS
           for run in c[3] + (c[4] if n == 4 else []) if run[0] == "auto"]


@pytest.mark.parametrize("label,n,run", LM_RUNS, ids=[
    f"{lab}-world{n}-sp{int(sp)}-remat{int(rm)}-{mesh}"
    for lab, n, (_, sp, rm, mesh) in LM_RUNS])
def test_auto_loss_and_grads_match_jax(label, n, run):
    """``LM.loss`` under ``auto`` within 1e-5 relative of JAX's one-device
    loss, the same on every rank, and every grad after ``sync_grads``
    within the reference's 1e-6 pin of ``jax.value_and_grad``'s (a split
    parameter's shards concatenated over the TP ranks, a whole one on
    every rank)."""
    loss, want = jax_lm(label)
    tc = lm_case(label)[0]
    res = [r["lm"][(label, *run)] for r in ring(n)]
    assert len({r[0] for r in res}) == 1
    assert abs(res[0][0] - loss) <= LOSS_RTOL * abs(loss)
    tp = n // 2 if run[3] == "dp2" else n
    for replica in range(n // tp):
        grads = [r[1] for r in res[replica * tp:(replica + 1) * tp]]
        for name, g_ref in want.items():
            for g in _whole(grads, name, tc, tp):
                _close(g, g_ref, GRAD_PIN, name)


PARITY_RUNS = [(lab, n) for lab in LM_CASES for n in WORLDS]


@pytest.mark.parametrize("label,n", PARITY_RUNS,
                         ids=[f"{lab}-world{n}" for lab, n in PARITY_RUNS])
def test_auto_matches_the_explicit_backend(label, n):
    """``model.auto_vs_barrier``: the same ring's ``auto`` and explicit
    (``barrier``; ``cais`` at S = 1 and ragged S) losses and grads within
    1e-4."""
    auto, other = LM_CASES[label][3][:2]
    for r in ring(n):
        a, b = r["lm"][(label, *auto)], r["lm"][(label, *other)]
        assert abs(a[0] - b[0]) <= PARITY * abs(b[0])
        for k in b[1]:
            _close(a[1][k], b[1][k], PARITY, k)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("S", BLOCK_SEQS)
def test_block_forward_matches_cais_and_jax(n, S):
    """``decode.s1_block_parity`` / ``decode.ragged_s_parity``: the block
    in the replicated layout under ``auto`` within 1e-4 of ``cais`` and of
    JAX's one-device block, on every rank."""
    want = jax_blocks()[S]
    for r in ring(n):
        auto, cais = r["blocks"][(S, "auto")], r["blocks"][(S, "cais")]
        np.testing.assert_allclose(auto, cais, atol=PARITY, rtol=0)
        np.testing.assert_allclose(auto, want, atol=PARITY, rtol=0)


@pytest.mark.parametrize("n", WORLDS)
def test_collectives_per_block(n):
    """The census in the sharded layout (internlm2, no remat): forward, one
    all-gather of the normed input and one reduce-scatter of the output a
    sub-layer (two of each a block) and the loss's all-reduce of (sum,
    count); backward, their adjoints (two reduce-scatters and two
    all-gathers a block) and one all-reduce a whole parameter making its
    partial grads whole: the two norm scales, and wk and wv where the kv
    heads do not split (2 over 4 ranks). With ``sequence_parallel=False``
    one all-reduce a sub-layer and nothing else in the forward."""
    cfg = lm_case("internlm2")[0]
    L = cfg.num_layers
    whole = 2 + (2 if cfg.num_kv_heads % n else 0)
    for r in ring(n):
        _, _, fwd, bwd = r["lm"][("internlm2", "auto", True, False, "flat")]
        assert fwd == {"all_gather_into_tensor": 2 * L,
                       "reduce_scatter_tensor": 2 * L, "allreduce_": 1}
        assert bwd == {"all_gather_into_tensor": 2 * L,
                       "reduce_scatter_tensor": 2 * L,
                       "all_reduce": whole * L}
        _, _, fwd, _ = r["lm"][("internlm2", "auto", False, False, "flat")]
        assert fwd == {"all_reduce": 2 * L}


def first_step_bound(g, p, delta, grad_norm, eps=1e-8, clip=1.0):
    """AdamW's first step moves p by lr·(u + wd·p), u = ĝ / (|ĝ| + eps)
    with ĝ the clipped grad: a sign where |ĝ| >> eps, linear in ĝ near eps.
    So an error ``delta`` in g bounds |Δp| per element by lr·|Δu|, |Δu| <= 2
    where |ĝ| <= delta and delta·eps / (|ĝ| − delta + eps)² elsewhere
    (chip_smoke.py's ``param_limit``), plus f32 rounding."""
    scale = min(1.0, clip / grad_norm)
    a, d = np.abs(g) * scale, delta * scale
    du = np.where(a <= d, 2.0,
                  np.minimum(d * eps / (a - d + eps) ** 2, 2.0))
    return cells.LR * du + 1e-3 * cells.LR + 1e-6 * np.abs(p)


@pytest.mark.parametrize("n", WORLDS)
def test_one_adamw_step_equals_one_device(n):
    """One AdamW step under ``auto`` against one device's, element-wise:
    the loss within 1e-6, the grad norm, every gradient, m and v within
    the 1e-6 pin, and every parameter within the first step's bound from
    that pin (:func:`first_step_bound`)."""
    for r in ring(n):
        (loss, norm, got), (one_loss, one_norm, want) = r["adamw"]
        assert abs(loss - one_loss) <= 1e-6 * abs(one_loss)
        assert abs(norm - one_norm) <= GRAD_PIN * one_norm
        for k, (p, g, m, v) in got.items():
            p1, g1, m1, v1 = want[k]
            delta = GRAD_PIN * max(1.0, float(np.abs(g1).max()))
            for a, b in ((g, g1), (m, m1), (v, v1)):
                _close(a, b, GRAD_PIN, k)
            assert np.all(np.abs(p - p1) <= first_step_bound(
                g1, p1, delta, one_norm)), k


@pytest.mark.parametrize("n", WORLDS)
def test_staged_collectives_equal_unstaged(n):
    """The step with DTensor's functional collectives staged through the
    host (as a gloo group runs them on the card) equals the unstaged one
    bitwise, with the same collectives."""
    for r in ring(n):
        staged = r["staged"]
        plain = r["lm"][("internlm2", "auto", True, False, "flat")]
        assert staged[0] == plain[0]
        assert staged[2:] == plain[2:]
        for k, g in plain[1].items():
            assert np.array_equal(staged[1][k], g), k


def test_auto_rank_cells_import_no_jax():
    assert not any(r["_jax_imported"] for n in WORLDS for r in ring(n))


# ---------------------------------------------------------------------------
# what raises under auto (before any collective: no process group here)
# ---------------------------------------------------------------------------

AUTO = Runtime(compute_dtype="float32", tp=TPConfig(mode="auto"))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "minicpm3-4b",
                                  "mamba2-130m", "recurrentgemma-2b",
                                  "paligemma-3b"])
def test_unported_blocks_raise_under_auto(arch):
    """MoE, MLA, the recurrent mixers and the VLM's prefix-LM under
    ``auto`` on a group raise naming ROADMAP A5 (b)."""
    cfg = get_arch(arch).smoke()
    lm = build_model(cfg, AUTO, device="cpu", seed=0,
                     group=TPGroup(0, 2, "gloo"))
    toks = torch.zeros((2, 8), dtype=torch.long)
    batch = {"tokens": toks, "labels": toks}
    if cfg.num_prefix_tokens:
        batch["patch_embed"] = torch.zeros(
            (2, cfg.num_prefix_tokens, cfg.vision_width))
    with pytest.raises(NotImplementedError, match=r"A5 \(b\)"):
        lm.loss(batch)


def test_serving_raises_under_auto():
    """prefill, decode_step, serve_step, both engines and the enc-dec
    model under ``auto`` on a group raise naming ROADMAP A5 (b)."""
    group = TPGroup(0, 2, "gloo")
    cfg = get_arch("internlm2-1.8b").smoke()
    lm = LM(cfg, AUTO, device="cpu", seed=0, group=group)
    toks = torch.zeros((2, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match=r"A5 \(b\)"):
        lm.prefill(toks)
    with pytest.raises(NotImplementedError, match=r"A5 \(b\)"):
        lm.decode_step(toks[:, :1], [], torch.zeros(2, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match=r"A5 \(b\)"):
        lm.serve_step(toks, [], None)
    for engine in (Engine, DenseEngine):
        with pytest.raises(NotImplementedError, match=r"A5 \(b\)"):
            engine(lm, cfg, AUTO, device="cpu")
    with pytest.raises(NotImplementedError, match=r"A5 \(b\)"):
        build_model(get_arch("whisper-tiny").smoke(), AUTO, device="cpu",
                    seed=0, group=group)
