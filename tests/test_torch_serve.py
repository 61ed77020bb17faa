"""The port's paged serving bookkeeping, held to the cases of
tests/test_serve.py: block allocator and prefix cache, scheduler admission
and token budget, the frozen ServeConfig, replayable sampling, and the load
generator with the latency report (engine on the CPU, smoke model)."""
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import SMOKE  # noqa: E402
from repro_torch.serve import (BlockAllocator, Engine, LoadSpec,  # noqa: E402
                               Request, Scheduler, ServeConfig,
                               blocks_needed, generate)


def setup(arch):
    cfg = get_arch(arch).smoke()
    return cfg, build_model(cfg, SMOKE, device="cpu", seed=0)


# ---------------------------------------------------------------------------
# allocator units
# ---------------------------------------------------------------------------


def test_blocks_needed():
    assert blocks_needed(5, 4, 4) == 2      # positions 0..7
    assert blocks_needed(8, 1, 4) == 2      # prompt only: 0..7
    assert blocks_needed(1, 1, 4) == 1


def test_allocator_free_list_and_refcounts():
    a = BlockAllocator(4, 8)
    ids = a.alloc(3)
    assert ids is not None and len(set(ids)) == 3
    assert a.num_free() == 1 and a.utilization() == 0.75
    assert a.alloc(2) is None               # over-subscribe -> defer
    a.release(ids)
    assert a.num_free() == 4
    with pytest.raises(AssertionError):
        a.release(ids)                      # double free is a bug


def test_prefix_cache_reuse_and_eviction():
    a = BlockAllocator(4, block_size=4)
    prompt = np.arange(1, 10, dtype=np.int32)          # 9 tokens, 2 full blocks
    ids = a.alloc(3)
    a.register_prefix(prompt, ids)
    # same prompt: both full blocks reused, never the partial third
    got, reuse = a.match_prefix(prompt)
    assert got == ids[:2] and reuse == 8
    a.release(got)
    # a prompt sharing only the first block matches the nested entry
    other = np.concatenate([prompt[:4], np.asarray([99, 98], np.int32)])
    got1, reuse1 = a.match_prefix(other)
    assert got1 == ids[:1] and reuse1 == 4
    a.release(got1)
    assert a.prefix_hits == 2
    # reuse never covers the whole prompt (>= 1 token must be fed)
    got2, reuse2 = a.match_prefix(prompt[:8])
    assert reuse2 == 4 and got2 == ids[:1]
    a.release(got2)
    # cache-held blocks are evicted LRU when allocation needs them
    a.release(ids)
    assert a.num_free() == 2                # partial block + the unallocated
    assert a.utilization() == 0.5           # 2 blocks resident, cache-only
    fresh = a.alloc(3)                      # needs eviction: frees LRU entry
    assert fresh is not None and a.num_free() == 0
    more = a.alloc(1)                       # evicts the last cached entry
    assert more is not None
    assert a.match_prefix(prompt) == ([], 0)    # cache fully evicted


# ---------------------------------------------------------------------------
# scheduler units
# ---------------------------------------------------------------------------


def _sched(num_blocks=8, block_size=4, max_batch=4, prefill_chunk=4,
           token_budget=8, max_active=4):
    return Scheduler(BlockAllocator(num_blocks, block_size),
                     max_batch=max_batch, prefill_chunk=prefill_chunk,
                     token_budget=token_budget, max_active=max_active)


def test_scheduler_admission_reserves_blocks():
    s = _sched(num_blocks=4, max_active=4)
    # each request needs 2 blocks (5 prompt + 3 new = positions 0..6)
    rs = [Request(rid=i, prompt=np.arange(1, 6), max_new_tokens=3)
          for i in range(3)]
    s.submit(rs)
    s.admit(now=0.0)
    assert len(s.active) == 2 and len(s.waiting) == 1   # 4 blocks -> 2 admits
    rows = s.next_batch()
    assert all(r.is_prefill for r in rows) and len(rows) == 2


def test_scheduler_token_budget_chunks_prefill():
    s = _sched(token_budget=6, prefill_chunk=4)
    s.submit([Request(rid=0, prompt=np.arange(1, 11), max_new_tokens=2),
              Request(rid=1, prompt=np.arange(1, 11), max_new_tokens=2)])
    s.admit(0.0)
    rows = s.next_batch()
    # 10-token prompts, chunk 4, budget 6: one full chunk + one clipped
    assert [len(r.tokens) for r in rows] == [4, 2]
    assert not any(r.sample for r in rows)
    assert list(rows[0].positions) == [0, 1, 2, 3]


def test_scheduler_mixed_decode_and_prefill():
    s = _sched(token_budget=4, prefill_chunk=3)
    a = Request(rid=0, prompt=np.arange(1, 4), max_new_tokens=3)
    s.submit([a])
    s.admit(0.0)
    (row,) = s.next_batch()
    assert row.sample                        # chunk reaches prompt end
    s.advance(0, len(row.tokens), 42)
    b = Request(rid=1, prompt=np.arange(1, 4), max_new_tokens=2)
    s.submit([b])
    s.admit(0.0)
    rows = s.next_batch()
    kinds = [(r.rid, r.is_prefill) for r in rows]
    assert kinds == [(0, False), (1, True)]   # decode first, prefill rides
    assert list(rows[0].tokens) == [42]
    assert rows[0].context_len == 4 and list(rows[0].positions) == [3]


def test_scheduler_retires_and_frees_blocks():
    s = _sched(num_blocks=2, max_active=1)
    s.submit([Request(rid=0, prompt=np.arange(1, 4), max_new_tokens=1),
              Request(rid=1, prompt=np.arange(1, 4), max_new_tokens=1)])
    s.admit(0.0)
    (row,) = s.next_batch()
    s.advance(0, len(row.tokens), 5)
    assert s._by_rid.get(0) is None          # retired at budget
    s.admit(0.0)
    assert [q.rid for q in s.waiting] == [] and len(s.active) == 1


# ---------------------------------------------------------------------------
# satellite regressions: config defaults + deterministic sampling
# ---------------------------------------------------------------------------


def test_serve_config_not_shared_mutable_default():
    sig = inspect.signature(Engine.__init__)
    assert sig.parameters["serve_cfg"].default is None
    assert dataclasses.fields(ServeConfig)[0].name == "max_batch"
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(ServeConfig(), "s_max", 1)
    cfg, model = setup("deepseek-7b")
    e1 = Engine(model, cfg, SMOKE, device="cpu")
    e2 = Engine(model, cfg, SMOKE, device="cpu")
    assert e1.sc is not e2.sc


def test_sampling_replayable_across_batch_composition():
    cfg, model = setup("deepseek-7b")
    prompt = (np.arange(1, 10) % cfg.vocab_size).astype(np.int32)
    mk = lambda rid: Request(rid=rid, prompt=prompt.copy(),
                             max_new_tokens=4, temperature=0.7)
    # solo run vs the same request batched with other traffic: the sampling
    # seed depends only on (seed, rid, token_index), so tokens must match
    solo = Engine(model, cfg, SMOKE, ServeConfig(max_batch=4, s_max=32),
                  device="cpu")
    a = solo.run([mk(7)], seed=123)
    others = [Request(rid=i, prompt=np.arange(1, 5 + i), max_new_tokens=2)
              for i in range(3)]
    b = solo.run([mk(7)] + others, seed=123)
    assert a[0].out_tokens == b[0].out_tokens
    assert a[0].seed == 123 and b[0].seed == 123
    c = solo.run([mk(7)], seed=124)       # another seed, another draw
    assert c[0].seed == 124 and len(c[0].out_tokens) == 4


def test_loadgen_deterministic_and_metrics():
    cfg, model = setup("deepseek-7b")
    spec = LoadSpec(kind="burst", num_requests=6, burst_size=3, gap_s=0.05,
                    prompt_len_min=3, prompt_len_max=6, max_new_tokens=3,
                    seed=11)
    a, b = generate(spec, cfg.vocab_size), generate(spec, cfg.vocab_size)
    assert all((x.prompt == y.prompt).all()
               and x.arrival_time == y.arrival_time for x, y in zip(a, b))
    pois = generate(LoadSpec(kind="poisson", num_requests=5, rate=100.0,
                             seed=2), cfg.vocab_size)
    assert pois[0].arrival_time == 0.0
    assert all(x.arrival_time <= y.arrival_time
               for x, y in zip(pois, pois[1:]))
    eng = Engine(model, cfg, SMOKE, ServeConfig(max_batch=4, s_max=32),
                 device="cpu")
    eng.run(a, seed=5)
    rep = eng.last_report
    for k in ("ttft_p50_ms", "ttft_p99_ms", "per_token_p50_ms",
              "per_token_p99_ms", "tokens_per_sec_per_device",
              "kv_block_utilization", "makespan_s"):
        assert k in rep and rep[k] >= 0.0, k
    assert rep["seed"] == 5.0
    assert rep["total_tokens"] == 6 * 3
    assert all(r.t_first_token is not None and len(r.token_times) == 3
               for r in a)
