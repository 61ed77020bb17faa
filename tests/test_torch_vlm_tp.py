"""The VLM (paligemma-3b's smoke config) trained on gloo rings of 2 and 4
CPU ranks against JAX on one device, in f32: ``VLM.loss`` and every grad
after ``sync_grads`` against ``jax.value_and_grad`` (loss within 1e-5
relative, grads within ``GRAD_RTOL`` of each tensor's max). The smoke
config's 4 image-prefix rows and S text rows run whole-block through the
period graphs with ``prefix_len = 4``; in the sequence-sharded layout a
rank's rows are its shard of the 4 + S rows:

- "t16" (S 12, 16 rows): at world 2 rank 0's 8 rows straddle the prefix
  boundary; at world 4 rank 0's 4 rows are all prefix (it adds 0 to the
  loss's sum and count);
- "t24" (S 20, 24 rows): rank 0 straddles at both worlds;
- "t17" (S 13): 17 rows split over neither ring (the replicated layout).

Every flash call carries the prefix; each rank's kernel calls equal
``tp.step_launches`` over the 4 + S rows. The ranks run in their own
processes (``tests/torch_vlm_cells.py``, no JAX), one spawn per world size,
both started with the module's first test."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402

import torch_vlm_cells as cells  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.tp import param_shard_dim  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402

GRAD_RTOL = 1e-5            # per tensor: 1e-5 * max(1, max|g|)
ARCH = "paligemma-3b"
WORLDS = (2, 4)
SHARDED = [("barrier", 1, True), ("cais", 2, True), ("cais", 1, False)]
CASES = {"t16": (12, SHARDED), "t24": (20, SHARDED),
         "t17": (13, [("cais", 1, True)])}


@functools.lru_cache(maxsize=None)
def setup():
    jc, tc = jax_get_arch(ARCH).smoke(), get_arch(ARCH).smoke()
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(jc, JAX_SMOKE).init)(jax.random.key(0)))
    return jc, tc, params


@functools.lru_cache(maxsize=None)
def batch(label):
    tc = setup()[1]
    rng = np.random.default_rng(70 + CASES[label][0])
    toks = rng.integers(0, tc.vocab_size, (2, CASES[label][0] + 1)
                        ).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "patch_embed": rng.standard_normal(
                (2, tc.num_prefix_tokens, tc.vision_width)
            ).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def jax_loss(label):
    jc, tc, params = setup()
    loss, grads = jax.jit(jax.value_and_grad(
        jax_build_model(jc, JAX_SMOKE).loss))(
            params, {k: jnp.asarray(v) for k, v in batch(label).items()})
    g = bridge.state_dict_from_jax(jax.tree.map(np.asarray, grads), tc)
    return float(loss), {k: v.numpy() for k, v in g.items()}


@functools.lru_cache(maxsize=None)
def _spawns():
    """Both spawns started at once in threads, so the ranks run while this
    process computes the JAX references."""
    from concurrent.futures import ThreadPoolExecutor

    _, tc, params = setup()
    data = {lab: (tc, params, batch(lab), runs)
            for lab, (_, runs) in CASES.items()}
    pool = ThreadPoolExecutor(len(WORLDS))
    futures = {n: pool.submit(run_ranks, cells.vlm_cells, n, data)
               for n in WORLDS}
    pool.shutdown(wait=False)
    return futures


@pytest.fixture(scope="module", autouse=True)
def _start_spawns():
    _spawns()


def ring(n):
    return _spawns()[n].result()


def _grad_close(got, want, name=""):
    bound = GRAD_RTOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= bound, (name, err, bound)


RUNS = [(lab, n, run) for lab, (_, runs) in CASES.items() for n in WORLDS
        for run in runs]


@pytest.mark.parametrize("label,n,run", RUNS,
                         ids=[f"{lab}-world{n}-{m}-mb{mb}-sp{int(sp)}"
                              for lab, n, (m, mb, sp) in RUNS])
def test_vlm_loss_and_grads_match_jax(label, n, run):
    loss, want = jax_loss(label)
    tc = setup()[1]
    res = [r[(label, *run)] for r in ring(n)]
    assert len({r[0] for r in res}) == 1
    assert abs(res[0][0] - loss) <= 1e-5 * abs(loss)
    assert set(want) == set(res[0][1])          # vision_proj included
    for name, g_ref in want.items():
        dim = param_shard_dim(name, tc, n)
        parts = [r[1][name] for r in res]
        if dim is None:
            for p in parts:
                _grad_close(p, g_ref, name)
        else:
            _grad_close(np.concatenate(parts, dim), g_ref, name)
    P, S = tc.num_prefix_tokens, CASES[label][0]
    T = P + S
    layout = ("replicated" if T % n else
              "sharded" if run[2] else "gathered")
    for r in res:
        made, derived, prefixes = r[2], r[3], r[4]
        assert derived["layout"] == layout
        for k in ("matmul", "flash"):
            assert made[k] == derived[k], (k, made, derived)
        assert made["flash"] >= tc.num_layers
        assert prefixes and set(prefixes) == {P}


def test_shards_cover_the_prefix_boundary():
    """The cases hold what the module says: at world 2 and 4 some rank's
    shard straddles the prefix boundary, and at world 4 "t16"'s rank 0
    holds prefix rows only."""
    P = setup()[1].num_prefix_tokens

    def shards(label, n):
        s = (P + CASES[label][0]) // n
        return [(r * s, (r + 1) * s) for r in range(n)]

    for n in WORLDS:
        assert any(lo < P < hi for lo, hi in shards("t24", n))
    assert any(lo < P < hi for lo, hi in shards("t16", 2))
    assert shards("t16", 4)[0] == (0, P)


def test_vlm_rank_cells_import_no_jax():
    assert not any(r["_jax_imported"] for n in WORLDS for r in ring(n))
