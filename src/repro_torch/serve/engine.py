"""Serving engines of ``repro/serve/engine.py``: the paged-KV
continuous-batching ``Engine`` and the static-batch ``DenseEngine``, which
``Engine`` falls back to for archs outside the paged path (MLA), as JAX's
does.

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

Tensor parallelism: the ``Engine`` serves on the model's own TP ring
(``LM(..., group=...)``, the counterpart of JAX's ``mesh=``). Every rank runs
the same scheduler on the same requests, with the clock it admits by agreed
over the ring, so the ranks assemble the same batches, get the same logits
and sample the same tokens. ``mesh=`` itself still refuses anything but
``None`` (a data-parallel or 2D mesh is ROADMAP A14), and ``DenseEngine``
on a ring raises: MLA is not whole-block TP-applicable, and ``prefill`` /
``decode_step`` on a ring are ROADMAP A11/A12. Not ported either: the
prefix/extras inputs of the enc-dec and VLM families.
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


def _engine_device(model, mesh, device) -> torch.device:
    """The device an engine runs on; raises for a mesh, or for a model that
    lies elsewhere."""
    device = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError(
            "serving over a mesh is not ported (a data-parallel or 2D mesh "
            "is ROADMAP A14); tensor-parallel serving runs on the model's own "
            "ring, LM(..., group=...)")
    if model.device.type != device.type:
        raise ValueError(f"model lies on {model.device}, engine runs on "
                         f"{device}")
    return device


def _ring_clock(group, now: float, device: torch.device) -> float:
    """One clock for every rank of the model's ring (the mean of the ranks'
    readings, summed on the model's device, as NCCL needs), so that
    admission by arrival time cannot differ between ranks; ``now`` itself
    off a ring."""
    if group is None or group.size <= 1:
        return now
    t = torch.tensor([now], dtype=torch.float64, device=device)
    return float(group.all_reduce(t)[0]) / group.size


class Engine:
    """Paged-KV continuous-batching engine on one device or on the model's
    TP ring (CUDA unless the caller passes ``device="cpu"``; the model must
    lie there). Falls back to :class:`DenseEngine` for archs outside the
    paged path."""

    def __init__(self, model, cfg: ArchConfig, rt: Runtime,
                 serve_cfg: Optional[ServeConfig] = None, *, mesh=None,
                 device=None):
        self.device = _engine_device(model, mesh, device)
        self.model = model
        self.group = getattr(model, "group", None)
        self.cfg = cfg
        self.rt = rt
        self.sc = serve_cfg if serve_cfg is not None else ServeConfig()
        self.last_report: Dict[str, float] = {}
        self.steps = 0                  # model calls in the last run
        self.paged = paged_supported(model, cfg)
        self._dense: Optional[DenseEngine] = None
        if not self.paged:
            self._dense = DenseEngine(model, cfg, rt, self.sc,
                                      device=self.device)
            return
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
        if self._dense is not None:
            self._dense.run(requests, seed)
            self.steps = self._dense.steps
            self.last_report = self._dense.last_report
            return requests
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
            now = _ring_clock(self.group, time.monotonic() - t0,
                              self.device)
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
            requests, makespan, n_devices=getattr(self.model, "tp", 1),
            kv_utilization=alloc.peak_used / alloc.num_blocks, seed=seed)
        self.last_report["prefix_hits"] = float(alloc.prefix_hits)
        self.last_report["steps"] = float(self.steps)
        return requests


class DenseEngine:
    """The static-batch engine on one device: dense ``(B, s_max)`` caches,
    one batch per same-length prompt group (left-padded, as JAX's), one
    ``LM.prefill`` and then ``LM.decode_step`` calls until every request of
    the batch has its tokens. ``steps`` counts the prefill and decode calls
    of the last run. A model on a TP ring raises: ``prefill`` and
    ``decode_step`` on a ring are ROADMAP A11/A12."""

    def __init__(self, model, cfg: ArchConfig, rt: Runtime,
                 serve_cfg: Optional[ServeConfig] = None, *, mesh=None,
                 device=None):
        self.device = _engine_device(model, mesh, device)
        if getattr(model, "tp", 1) > 1:
            raise NotImplementedError(
                f"{cfg.name}: the dense engine on a TP ring needs prefill "
                "and decode_step on a ring, which are not ported yet "
                "(ROADMAP A11, A12)")
        self.model = model
        self.cfg = cfg
        self.rt = rt
        self.sc = serve_cfg if serve_cfg is not None else ServeConfig()
        self.last_report: Dict[str, float] = {}
        self.steps = 0

    def _pack(self, requests: List[Request]):
        """Right-align prompts into one (B, S) batch (pad token 0)."""
        S = max(len(r.prompt) for r in requests)
        toks = np.zeros((len(requests), S), np.int32)
        for i, r in enumerate(requests):
            toks[i, S - len(r.prompt):] = r.prompt        # left-pad
        return torch.from_numpy(toks).to(self.device), S

    def run(self, requests: List[Request],
            seed: Optional[int] = None) -> List[Request]:
        seed = 0 if seed is None else int(seed)
        for r in requests:
            r.seed = seed
            need = len(r.prompt) + r.max_new_tokens - 1
            if need > self.sc.s_max:
                raise ValueError(
                    f"request {r.rid}: prompt+max_new needs {need} cache "
                    f"slots, the cache holds {self.sc.s_max} (raise s_max)")
        # group by prompt length: one prefill per group keeps positions
        # exact. A static batch cannot start until every member has arrived.
        by_len: Dict[int, List[Request]] = {}
        for r in requests:
            by_len.setdefault(len(r.prompt), []).append(r)
        self.steps = 0
        t0 = time.monotonic()
        for _, group in sorted(by_len.items()):
            for i in range(0, len(group), self.sc.max_batch):
                chunk = group[i:i + self.sc.max_batch]
                wait = max(r.arrival_time for r in chunk) \
                    - (time.monotonic() - t0)
                if wait > 0:
                    time.sleep(wait)
                self._run_batch(chunk, seed, t0)
        makespan = time.monotonic() - t0
        from repro_torch.serve.loadgen import latency_report
        self.last_report = latency_report(requests, makespan, n_devices=1,
                                          seed=seed)
        self.last_report["steps"] = float(self.steps)
        return requests

    def _run_batch(self, requests: List[Request], seed: int, t0: float):
        toks, S = self._pack(requests)
        logits, caches = self.model.prefill(toks, s_max=self.sc.s_max)
        self.steps += 1
        idx = torch.full((len(requests),), S, dtype=torch.int32,
                         device=self.device)
        tok = self._sample(logits, requests, seed)
        for t in range(max(r.max_new_tokens for r in requests)):
            t_now = time.monotonic() - t0
            for i, r in enumerate(requests):
                if not r.done and len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(int(tok[i]))
                    if r.t_first_token is None:
                        r.t_first_token = t_now
                    r.token_times.append(t_now)
                    if len(r.out_tokens) >= r.max_new_tokens:
                        r.done = True
            if all(r.done for r in requests):
                break
            token = torch.from_numpy(tok[:, None]).to(self.device)
            logits, caches = self.model.decode_step(token, caches, idx + t)
            self.steps += 1
            tok = self._sample(logits, requests, seed)
        for r in requests:
            r.done = True

    @staticmethod
    def _sample(logits: torch.Tensor, requests: List[Request],
                seed: int) -> np.ndarray:
        rows = logits[:, -1].cpu().numpy()
        return np.asarray([_sample_token(rows[i], seed, r.rid,
                                         len(r.out_tokens), r.temperature)
                           for i, r in enumerate(requests)], np.int32)
