"""The port's model and engine against the JAX package on the CPU, at smoke
size, in f32: paged KV update/lookup (exact), ``LM.serve_step`` through the
parameter bridge (per-row logits and new pools within 1e-5), greedy
``Engine`` tokens (identical, with chunked prefill and a prefix-cache hit),
the device rule, and the import rule of the port."""
import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.runtime import SMOKE as JAX_SMOKE  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import LM, attention  # noqa: E402
from repro_torch.runtime import SMOKE  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)

# gemma3-1b at smoke widths with 8 layers: one full 6-layer period plus two
# trailing layers, so the bridge's period/remainder layer order is exercised
ARCHS = {"gemma3-1b": dict(num_layers=8), "internlm2-1.8b": {}}


def smoke_cfgs(arch):
    over = ARCHS[arch]
    return (jax_get_arch(arch).smoke().scaled(**over),
            get_arch(arch).smoke().scaled(**over))


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(JAX cfg, JAX model, JAX params, port cfg, port LM) sharing weights."""
    jcfg, cfg = smoke_cfgs(arch)
    jmodel = jax_build_model(jcfg, JAX_SMOKE)
    jparams = jmodel.init(jax.random.key(0))
    lm = LM(cfg, SMOKE, device="cpu", seed=None)
    bridge.load_jax_params(lm, jax.tree.map(np.asarray, jparams))
    return jcfg, jmodel, jparams, cfg, lm


def jax_pools(layers, cfg):
    """Per-layer {"k","v"} numpy pools -> repro's stacked pool layout."""
    P = len(cfg.layer_pattern)
    n_full = cfg.num_layers // P
    periods = {f"b{i}": {n: jnp.asarray(np.stack(
        [layers[p * P + i][n] for p in range(n_full)])) for n in ("k", "v")}
        for i in range(P if n_full else 0)}
    rem = [{n: jnp.asarray(t[n]) for n in ("k", "v")}
           for t in layers[n_full * P:]]
    return {"periods": periods, "rem": rem}


def mixed_view(rng):
    """3 rows, S_step 5: a 5-token prefill chunk at positions 3..7 over a
    3-token reused prefix, a decode row at position 9 (past the smoke window
    of 8), and a padding row."""
    bt = np.array([[2, 5, 0, 0], [7, 1, 3, 0], [0, 0, 0, 0]], np.int32)
    pos = np.full((3, 5), -1, np.int32)
    pos[0] = np.arange(3, 8)
    pos[1, 0] = 9
    ctx = np.array([8, 10, 0], np.int32)
    last = np.array([4, 0, 0], np.int32)
    toks = np.where(pos >= 0, rng.integers(1, 256, pos.shape), 0)
    return toks.astype(np.int32), bt, pos, ctx, last


# ---------------------------------------------------------------------------
# paged KV: exact against JAX
# ---------------------------------------------------------------------------


def test_paged_update_and_lookup_exact():
    rng = np.random.default_rng(0)
    NB, BS, Hkv, dh = 8, 4, 2, 8
    kp, vp = (rng.standard_normal((NB, BS, Hkv, dh)).astype(np.float32)
              for _ in range(2))
    _, bt, pos, ctx, _ = mixed_view(rng)
    kn, vn = (rng.standard_normal((3, 5, Hkv, dh)).astype(np.float32)
              for _ in range(2))
    jk, jv = jax_attn.paged_update(*map(jnp.asarray, (kp, vp, kn, vn, bt,
                                                      pos)))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = attention.paged_update(tk, tv, torch.from_numpy(kn),
                                 torch.from_numpy(vn), torch.from_numpy(bt),
                                 torch.from_numpy(pos))
    assert out[0] is tk and out[1] is tv          # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    want = jax_attn.paged_lookup(jk, jv, jnp.asarray(bt), jnp.asarray(ctx))
    got = attention.paged_lookup(tk, tv, torch.from_numpy(bt),
                                 torch.from_numpy(ctx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.int32


# ---------------------------------------------------------------------------
# LM.serve_step through the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_step_matches_jax(arch):
    jcfg, jmodel, jparams, cfg, lm = pair(arch)
    rng = np.random.default_rng(1)
    toks, bt, pos, ctx, last = mixed_view(rng)
    shape = (8, 4, cfg.num_kv_heads, cfg.resolved_head_dim)
    layers = [{n: rng.standard_normal(shape).astype(np.float32)
               for n in ("k", "v")} for _ in range(cfg.num_layers)]
    jview = jax_attn.KVView(*map(jnp.asarray, (bt, pos, ctx, last)))
    jlogits, jnew = jmodel.serve_step(jparams, jnp.asarray(toks),
                                      jax_pools(layers, jcfg), jview)
    pools = [{n: torch.from_numpy(t[n].copy()) for n in t} for t in layers]
    view = attention.KVView(*map(torch.from_numpy, (bt, pos, ctx, last)))
    logits, new = lm.serve_step(torch.from_numpy(toks), pools, view)
    assert logits.shape == (3, 1, cfg.vocab_size)
    np.testing.assert_allclose(logits[:2].numpy(),
                               np.asarray(jlogits)[:2], **TOL)
    want = bridge.unstack_layers(jax.tree.map(np.asarray, jnew), cfg)
    for li, (g, w) in enumerate(zip(new, want)):
        for n in ("k", "v"):
            np.testing.assert_allclose(g[n].numpy(), w[n], **TOL,
                                       err_msg=f"layer {li} {n}")


# ---------------------------------------------------------------------------
# Engine: greedy tokens identical to repro.serve.Engine
# ---------------------------------------------------------------------------


def test_engine_greedy_matches_jax():
    jcfg, jmodel, jparams, cfg, lm = pair("gemma3-1b")
    long = (np.arange(1, 20) % cfg.vocab_size).astype(np.int32)  # 19 % 4 != 0
    short = np.arange(40, 46, dtype=np.int32)
    # A and C share batches (decode rows beside prefill chunks); B waits for
    # a slot and finds A's prompt in the prefix cache
    prompts = [long, short, long]
    kw = dict(max_batch=2, max_active=2, s_max=32, block_size=4,
              prefill_chunk=4)
    jeng = JaxEngine(jmodel, jparams, jcfg, JAX_SMOKE, JaxServeConfig(**kw))
    want = jeng.run([JaxRequest(rid=i, prompt=p, max_new_tokens=4)
                     for i, p in enumerate(prompts)])
    eng = Engine(lm, cfg, SMOKE, ServeConfig(**kw), device="cpu")
    got = eng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                   for i, p in enumerate(prompts)])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == 4 for r in got)
    assert eng.last_report["prefix_hits"] >= 1
    assert eng.last_report["prefix_hits"] == jeng.last_report["prefix_hits"]
    assert eng.steps == eng.last_report["steps"] > 0


# ---------------------------------------------------------------------------
# device rule and import rule
# ---------------------------------------------------------------------------


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = get_arch("gemma3-1b").smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg, SMOKE)
    lm = LM(cfg, SMOKE, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(lm, cfg, SMOKE)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])


def test_not_ported_archs_and_mesh_raise():
    # every arch of repro's registry is ported (arctic-480b last): only a
    # name neither package knows raises
    assert get_arch("arctic-480b").optimizer == "adafactor"
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("llama-9000")
    cfg = get_arch("deepseek-7b").smoke()
    lm = LM(cfg, SMOKE, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        Engine(lm, cfg, SMOKE, mesh=object(), device="cpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad
