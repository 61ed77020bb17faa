"""The port's tensor-parallel training forward against the JAX package on the
CPU: ``LM.loss`` on a gloo ring of 2 and 4 ranks (``barrier`` and ``cais``,
1 and 2 microbatches) on the internlm2-1.8b and deepseek-7b smoke configs
with bridged parameters, within 1e-5 of JAX ``LM.loss`` on one CPU device;
the one-device port's loss likewise; the matmul calls a rank makes equal to
the count derived from the optimized period graphs; and the unported TP
paths raising with their ROADMAP item. The ranks run in their own processes
(``tests/torch_rank_cells.py``, no JAX), spawned once per world size."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402

import torch_rank_cells as cells  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.runtime import SMOKE, Runtime, TPConfig  # noqa: E402
from repro_torch.sharding import TPGroup  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TP_ARCHS = ("internlm2-1.8b", "deepseek-7b")
TOKENS = np.random.default_rng(3).integers(0, 256, (2, 32)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_case(arch):
    """(numpy params, JAX LM.loss on one CPU device) at smoke size, f32."""
    model = jax_build_model(jax_get_arch(arch).smoke(), JAX_SMOKE)
    params = model.init(jax.random.key(0))
    toks = jnp.asarray(TOKENS)
    loss = float(model.loss(params, {"tokens": toks, "labels": toks}))
    return jax.tree.map(np.asarray, params), loss


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ring(request):
    cases = {a: jax_case(a)[0] for a in TP_ARCHS}
    return request.param, run_ranks(cells.loss_cells, request.param, cases,
                                    TOKENS)


RUNS = [(a, m, mb) for a in TP_ARCHS for m in ("barrier", "cais")
        for mb in (1, 2)]


@pytest.mark.parametrize("run", RUNS, ids=["-".join(map(str, r))
                                           for r in RUNS])
def test_tp_loss_matches_jax(ring, run):
    n, res = ring
    losses = [r[run][0] for r in res]
    assert len(set(losses)) == 1            # every rank holds one loss
    np.testing.assert_allclose(losses[0], jax_case(run[0])[1], **TOL)


@pytest.mark.parametrize("run", RUNS, ids=["-".join(map(str, r))
                                           for r in RUNS])
def test_matmul_calls_match_the_graph(ring, run):
    n, res = ring
    for r in res:
        _, made, derived, overlaps = r[run]
        assert made == derived > 0
        assert (overlaps > 0) == (run[2] == 2)   # a split feeds pass 3


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-7b",
                                  "gemma3-1b"])
def test_one_device_loss_matches_jax(arch):
    """World 1 takes the per-block path (window and tied head on
    gemma3-1b)."""
    params, want = jax_case(arch)
    lm = LM(get_arch(arch).smoke(), SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(lm, params)
    toks = torch.from_numpy(TOKENS)
    got = float(lm.loss({"tokens": toks, "labels": toks}))
    np.testing.assert_allclose(got, want, **TOL)


def test_shard_state_dict_reassembles():
    cfg = get_arch("internlm2-1.8b").smoke()
    full = LM(cfg, SMOKE, device="cpu", seed=0).state_dict()
    for n in (2, 4):
        shards = [bridge.shard_state_dict(full, cfg, r, n) for r in range(n)]
        for name, t in full.items():
            parts = [s[name] for s in shards]
            assert all(p.is_contiguous() for p in parts)
            if parts[0].shape == t.shape:
                assert all(torch.equal(p, t) for p in parts)
            else:
                dim = [a != b for a, b in zip(parts[0].shape,
                                              t.shape)].index(True)
                assert torch.equal(torch.cat(parts, dim), t)
        group = TPGroup(n - 1, n, "gloo")
        lm = LM(cfg, SMOKE, device="cpu", seed=0, group=group)
        for name, t in lm.state_dict().items():
            assert torch.equal(t, shards[n - 1][name])


def test_unported_tp_paths_raise():
    cfg = get_arch("internlm2-1.8b").smoke()
    group = TPGroup(0, 2, "gloo")           # no process group: no wire
    toks = torch.from_numpy(TOKENS)
    batch = {"tokens": toks, "labels": toks}
    lm = LM(cfg, SMOKE, device="cpu", seed=0, group=group)
    with pytest.raises(NotImplementedError, match="A5"):
        lm.loss(batch)                      # SMOKE's tp mode is "auto"
    lm.rt = Runtime(compute_dtype="float32", tp=TPConfig(mode="cais"))
    odd = {"tokens": toks[:, :31], "labels": toks[:, :31]}
    with pytest.raises(NotImplementedError, match="A11"):
        lm.loss(odd)
    with pytest.raises(NotImplementedError, match="A13"):
        TPConfig(mode="cais", planner="perfsim")
    with pytest.raises(NotImplementedError, match="A12"):
        lm.serve_step(toks, [], None)


def test_tp_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(get_arch("internlm2-1.8b").smoke(), SMOKE,
           group=TPGroup(0, 2, "gloo"))
