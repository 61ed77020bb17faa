"""Paged-KV continuous-batching serving engine — the port of
``repro/serve/engine.py``'s ``Engine`` on one device.

A :class:`repro_torch.serve.kv.BlockAllocator` owns fixed-size KV blocks
with prefix reuse, a :class:`repro_torch.serve.scheduler.Scheduler` builds
one mixed prefill+decode batch per iteration (chunked prefill interleaved
with decode under a token budget), and every iteration runs one
``LM.serve_step`` on the model's device. Batches are padded to
(``max_batch``, S-bucket): decode-only steps are S=1, mixed steps
S=``prefill_chunk``.

Sampling is replayable: greedy at temperature 0; otherwise each token is
drawn with a ``torch.Generator`` seeded from (seed, rid, token_index) alone,
so a request's tokens do not depend on what it was batched with.

Not in this slice: the dense static-batch engine, archs outside the paged
path, and tensor-parallel serving over a mesh (ROADMAP A4-A7); the engine
raises for each.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import KVView
from repro_torch.runtime import Runtime, resolve_device
from repro_torch.serve.kv import BlockAllocator, blocks_needed
from repro_torch.serve.scheduler import Row, Scheduler


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    # load-gen / metrics surface (seconds, relative to run start)
    arrival_time: float = 0.0
    t_first_token: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    seed: Optional[int] = None          # sampling seed recorded by run()


@dataclass(frozen=True)
class ServeConfig:
    """Frozen so a config can never become cross-engine shared mutable
    state. 0 means "derive a default"."""
    max_batch: int = 8
    s_max: int = 256
    block_size: int = 8                 # KV tokens per pool block
    num_blocks: int = 0                 # 0: max_active tables + slack
    prefill_chunk: int = 8              # prompt tokens per prefill row
    token_budget: int = 0               # 0: max_batch * prefill_chunk
    max_active: int = 0                 # 0: max_batch
    prefix_cache: bool = True


def _sample_token(logits_row: np.ndarray, seed: int, rid: int,
                  token_index: int, temperature: float) -> int:
    """One token from one row's logits. Greedy at temperature 0; otherwise
    the generator's seed depends only on (seed, rid, token_index)."""
    if temperature <= 0.0:
        return int(np.argmax(logits_row))
    mixed = np.random.SeedSequence([seed, rid, token_index]).generate_state(
        1, np.uint64)[0]
    g = torch.Generator().manual_seed(int(mixed >> np.uint64(1)))
    probs = torch.softmax(torch.from_numpy(logits_row).double() / temperature,
                          dim=-1)
    return int(torch.multinomial(probs, 1, generator=g))


def paged_supported(model, cfg: Optional[ArchConfig]) -> bool:
    """Can this (model, arch) serve through the paged path? Requires
    attention-only mixers, a dense FFN and a model with ``serve_step``."""
    if cfg is None or not hasattr(model, "serve_step") or cfg.moe is not None:
        return False
    return all(k in ("attn", "swa") for k in cfg.layer_kinds())


class Engine:
    """Paged-KV continuous-batching engine on one device (CUDA unless the
    caller passes ``device="cpu"``; the model must lie there)."""

    def __init__(self, model, cfg: ArchConfig, rt: Runtime,
                 serve_cfg: Optional[ServeConfig] = None, *, mesh=None,
                 device=None):
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                "serving over a mesh (tensor parallelism) is not ported yet "
                "(ROADMAP A4-A7); the port serves on one device")
        if not paged_supported(model, cfg):
            raise NotImplementedError(
                f"arch {cfg.name!r} is outside the paged path; the dense "
                "engine and other mixers are not ported yet")
        if model.device.type != self.device.type:
            raise ValueError(f"model lies on {model.device}, engine runs on "
                             f"{self.device}")
        self.model = model
        self.cfg = cfg
        self.rt = rt
        self.sc = serve_cfg if serve_cfg is not None else ServeConfig()
        self.last_report: Dict[str, float] = {}
        self.steps = 0                  # serve_step calls in the last run
        sc = self.sc
        self.max_active = sc.max_active or sc.max_batch
        self.table_width = max(-(-sc.s_max // sc.block_size), 1)
        self.num_blocks = sc.num_blocks or (
            self.max_active * self.table_width + self.table_width)
        self.token_budget = sc.token_budget or (
            sc.max_batch * sc.prefill_chunk)

    # ----- batching -----
    def _assemble(self, rows: List[Row], s_pad: int):
        B = self.sc.max_batch
        toks = np.zeros((B, s_pad), np.int32)
        pos = np.full((B, s_pad), -1, np.int32)   # -1: no KV write, masked q
        bt = np.zeros((B, self.table_width), np.int32)
        ctx = np.zeros((B,), np.int32)            # 0: padding row, all masked
        last = np.zeros((B,), np.int32)
        for i, row in enumerate(rows):
            s = len(row.tokens)
            toks[i, :s] = row.tokens
            pos[i, :s] = row.positions
            bt[i, :len(row.block_table)] = row.block_table
            ctx[i] = row.context_len
            last[i] = s - 1
        dev = lambda a: torch.from_numpy(a).to(self.device)
        view = KVView(block_tables=dev(bt), positions=dev(pos),
                      context_lens=dev(ctx), last=dev(last))
        return dev(toks), view

    # ----- main loop -----
    def run(self, requests: List[Request],
            seed: Optional[int] = None) -> List[Request]:
        seed = 0 if seed is None else int(seed)
        sc = self.sc
        for r in requests:
            r.seed = seed
            need = blocks_needed(len(r.prompt), r.max_new_tokens,
                                 sc.block_size)
            if need > self.table_width:
                raise ValueError(
                    f"request {r.rid}: prompt+max_new needs {need} blocks, "
                    f"table holds {self.table_width} (raise s_max)")
        alloc = BlockAllocator(self.num_blocks, sc.block_size,
                               prefix_cache=sc.prefix_cache)
        sched = Scheduler(alloc, max_batch=sc.max_batch,
                          prefill_chunk=sc.prefill_chunk,
                          token_budget=self.token_budget,
                          max_active=self.max_active)
        sched.submit(requests)
        by_rid = {r.rid: r for r in requests}
        pools = self.model.init_pools(self.num_blocks, sc.block_size)
        self.steps = 0
        t0 = time.monotonic()
        while sched.has_work():
            now = time.monotonic() - t0
            sched.admit(now)
            rows = sched.next_batch()
            if not rows:
                nxt = min(r.arrival_time for r in sched.waiting)
                time.sleep(min(max(nxt - now, 0.0), 0.05) + 1e-4)
                continue
            s_pad = 1 if all(not r.is_prefill for r in rows) \
                else sc.prefill_chunk
            toks, view = self._assemble(rows, s_pad)
            logits, pools = self.model.serve_step(toks, pools, view)
            self.steps += 1
            logits = logits[:, 0].cpu().numpy()
            t_now = time.monotonic() - t0
            for i, row in enumerate(rows):
                if not row.sample:
                    sched.advance(row.rid, len(row.tokens), None)
                    continue
                req = by_rid[row.rid]
                tok = _sample_token(logits[i], seed, row.rid,
                                    row.token_index, req.temperature)
                if req.t_first_token is None:
                    req.t_first_token = t_now
                req.token_times.append(t_now)
                sched.advance(row.rid, len(row.tokens), tok)
        makespan = time.monotonic() - t0
        from repro_torch.serve.loadgen import latency_report
        self.last_report = latency_report(
            requests, makespan, n_devices=1,
            kv_utilization=alloc.peak_used / alloc.num_blocks, seed=seed)
        self.last_report["prefix_hits"] = float(alloc.prefix_hits)
        self.last_report["steps"] = float(self.steps)
        return requests
