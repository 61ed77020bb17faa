"""The recurrent families trained on gloo rings of 2 and 4 CPU ranks
against JAX on one device, in f32: ``LM.loss`` and every grad after
``LM.sync_grads`` against ``jax.value_and_grad`` (loss within 1e-5
relative, grads within ``GRAD_RTOL`` of each tensor's max), for the smoke
mamba2-130m (SSM mixers), the smoke recurrentgemma-2b (RG-LRU mixers and
sliding-window attention) and recurrentgemma-2b with 2 query heads on 4
ranks (attention whose heads do not split over the ring), each in the
sequence-sharded layout, the ragged one (S % tp != 0, the activation whole
on every rank) and with ``sequence_parallel=False``. Every mixer that is
not TP-applicable runs replicated (``core/tp.py::sp_replicated_mixer``), its
weights whole on every rank (``param_shard_dim`` None) and its partial grads
summed once; each rank's kernel calls equal ``tp.step_launches``. The
ranks run in their own processes (``tests/torch_recurrent_cells.py``, no
JAX), one spawn per world size, both started with the module's first
test."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402

import torch_recurrent_cells as cells  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import tp as tp_mod  # noqa: E402
from repro_torch.core.tp import param_shard_dim  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.transformer import (block_routes,  # noqa: E402
                                            replicated_block_params)
from repro_torch.runtime import Runtime, TPConfig  # noqa: E402
from repro_torch.sharding import TPGroup  # noqa: E402

GRAD_RTOL = 1e-5            # per tensor: 1e-5 * max(1, max|g|)
WORLDS = (2, 4)
SHARDED = [("barrier", 1, True), ("cais", 2, True), ("cais", 1, False)]
RAGGED = [("barrier", 1, True), ("cais", 1, True)]
# label: (arch, overrides, tokens shape, runs, worlds); S 16 splits over
# both rings, S 13 over neither (the ragged, replicated layout)
CASES = {
    "mamba": ("mamba2-130m", {}, (2, 16), SHARDED, WORLDS),
    "mamba_s13": ("mamba2-130m", {}, (2, 13), RAGGED, WORLDS),
    "rgemma": ("recurrentgemma-2b", {}, (2, 16), SHARDED, WORLDS),
    "rgemma_s13": ("recurrentgemma-2b", {}, (2, 13), RAGGED, WORLDS),
    "heads2": ("recurrentgemma-2b", dict(num_heads=2, num_kv_heads=1),
               (2, 16), SHARDED, (4,)),
    "heads2_s13": ("recurrentgemma-2b", dict(num_heads=2, num_kv_heads=1),
                   (2, 13), RAGGED, (4,)),
}


@functools.lru_cache(maxsize=None)
def case(label):
    arch, over, shape, _, _ = CASES[label]
    jc = jax_get_arch(arch).smoke().scaled(**over)
    tc = get_arch(arch).smoke().scaled(**over)
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(jc, JAX_SMOKE).init)(jax.random.key(0)))
    toks = np.random.default_rng(90 + len(label)).integers(
        0, tc.vocab_size, shape).astype(np.int32)
    return jc, tc, params, toks


@functools.lru_cache(maxsize=None)
def jax_loss(label):
    jc, tc, params, toks = case(label)
    t = jnp.asarray(toks)
    loss, grads = jax.jit(jax.value_and_grad(
        jax_build_model(jc, JAX_SMOKE).loss))(params,
                                              {"tokens": t, "labels": t})
    g = bridge.state_dict_from_jax(jax.tree.map(np.asarray, grads), tc)
    return float(loss), {k: v.numpy() for k, v in g.items()}


@functools.lru_cache(maxsize=None)
def _spawns():
    """Both spawns started at once in threads, so the ranks run while this
    process computes the JAX references."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(len(WORLDS))
    futures = {}
    for n in WORLDS:
        data = {lab: (case(lab)[1], case(lab)[2], case(lab)[3], c[3])
                for lab, c in CASES.items() if n in c[4]}
        futures[n] = pool.submit(run_ranks, cells.recurrent_cells, n, data)
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


RUNS = [(lab, n, run) for lab, c in CASES.items() for n in c[4]
        for run in c[3]]


@pytest.mark.parametrize("label,n,run", RUNS,
                         ids=[f"{lab}-world{n}-{m}-mb{mb}-sp{int(sp)}"
                              for lab, n, (m, mb, sp) in RUNS])
def test_lm_loss_and_grads_match_jax(label, n, run):
    loss, want = jax_loss(label)
    _, tc, _, toks = case(label)
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
    attends = sum(k in ("attn", "swa") for k in tc.layer_kinds())
    for r in res:
        made, derived = r[2], r[3]
        assert derived["layout"] == layout
        for k in ("matmul", "flash", "matmul_rmsnorm"):
            assert made[k] == derived[k], (k, made, derived)
        # a flash call per attention layer and chain a forward, wherever it
        # runs (a graph, or replicated); none for SSM or RG-LRU
        assert made["flash"] >= attends


def test_recurrent_rank_cells_import_no_jax():
    assert not any(r["_jax_imported"] for n in WORLDS for r in ring(n))


def test_replicated_mixers_stay_whole():
    """Every mixer that is not TP-applicable is whole on every rank:
    ``param_shard_dim`` None for each of its leaves (attention whose 2 query
    heads do not split over 4 ranks included, where the leaf names would
    match the column/row rule), its block routed "replicated", and its
    norm1 and mixer among the grads ``sync_grads`` sums once."""
    heads2 = get_arch("recurrentgemma-2b").smoke().scaled(
        num_heads=2, num_kv_heads=1)
    mamba = get_arch("mamba2-130m").smoke()
    rt = Runtime(compute_dtype="float32", tp=TPConfig(mode="cais"))
    for cfg, n in ((heads2, 4), (mamba, 4), (heads2, 2)):
        lm = LM(cfg, rt, device="cpu", seed=None,
                group=TPGroup(0, n, "gloo"))
        tpc = tp_mod.TPContext(lm.group, backend="cais")
        for i, blk in enumerate(lm.blocks):
            whole = not tp_mod.tp_applicable(cfg, blk.kind, n)
            for leaf, p in blk.mixer.named_parameters():
                dim = param_shard_dim(f"blocks.{i}.mixer.{leaf}", cfg, n)
                assert (dim is None) == whole or leaf in ("wk", "wv"), \
                    (cfg.name, n, i, leaf)
            full = LM(cfg, rt, device="cpu", seed=None)
            assert [p.shape for p in blk.mixer.parameters()] == \
                [p.shape for p in full.blocks[i].mixer.parameters()] \
                or not whole
            mixer, _ = block_routes(blk.kind, cfg, tpc)
            assert (mixer == "replicated") == whole
            if mixer == "replicated":
                assert replicated_block_params(blk.kind, cfg, tpc)[:2] == \
                    ("norm1.", "mixer.")
    # attention whose heads split keeps its column/row shards
    assert param_shard_dim("blocks.2.mixer.wq", heads2, 2) == 1
    assert param_shard_dim("blocks.2.mixer.wo", heads2, 2) == 0
    assert param_shard_dim("blocks.2.mixer.wq", heads2, 4) is None
    assert param_shard_dim("blocks.2.mixer.wo", heads2, 4) is None
    # a period graph's weights are placed as a TP-applicable attention's,
    # whatever kind the stack's layer 0 is (an RG-LRU layer here)
    assert heads2.layer_kinds()[0] == "rglru"
    places = tp_mod._placements({"b0.wq": None, "b0.wo": None}, heads2,
                                TPGroup(0, 2, "gloo"))
    assert [p[0] for p in places.values()] == [1, 0]
    # a kind the port does not know still raises
    with pytest.raises(NotImplementedError, match="not ported"):
        block_routes("xattn", heads2, tp_mod.TPContext(
            TPGroup(0, 4, "gloo"), backend="cais"))
