"""Continuous-batching scheduler over the paged KV cache. A copy of
``repro/serve/scheduler.py`` (numpy only).

Every engine iteration asks the scheduler for ONE mixed batch
(:meth:`Scheduler.next_batch`): all running decodes advance by one token
and whatever prefill work fits the remaining token budget rides along as
chunked-prefill rows — decode rows stay S=1, prefill rows feed up to
``prefill_chunk`` prompt tokens at their true positions. Both row kinds run
through the same ``LM.serve_step``. Requests retire the moment their last token is sampled and
their blocks return to the allocator (minus any the prefix cache keeps),
freeing admission capacity for the next iteration — the loop in
docs/serving.md.

Admission policy: a request is admitted only when (a) it has arrived,
(b) the active set is below ``max_active``, and (c) the allocator can
reserve its WORST-CASE block count up front (:func:`repro_torch.serve.kv.
blocks_needed`, minus prefix-reused blocks) — so a running request can
never be starved of blocks mid-decode and there is no preemption path.
The scheduler is pure host-side bookkeeping: the engine owns device
arrays, sampling, and timing, and feeds sampled tokens back through
:meth:`feedback`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve.kv import BlockAllocator, blocks_needed

__all__ = ["Row", "Scheduler"]


@dataclass
class Row:
    """One request's slice of a mixed batch, in host (numpy) form."""
    rid: int
    tokens: np.ndarray        # (s,) int32 tokens fed this step
    positions: np.ndarray     # (s,) int32 KV positions they are written to
    context_len: int          # KV entries visible AFTER this step's writes
    block_table: List[int]
    sample: bool              # sample from this row's last-position logits?
    token_index: int          # which output token a sample would produce
    is_prefill: bool


@dataclass
class _Seq:
    req: object               # engine Request (duck-typed)
    block_ids: List[int]
    reuse_len: int            # prompt tokens already in the pool (prefix hit)
    written: int              # KV positions written so far
    tokens: np.ndarray        # prompt; sampled tokens are appended


class Scheduler:
    def __init__(self, alloc: BlockAllocator, *, max_batch: int,
                 prefill_chunk: int, token_budget: int, max_active: int):
        self.alloc = alloc
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        self.token_budget = token_budget
        self.max_active = max_active
        self.waiting: List[object] = []
        self.active: List[_Seq] = []
        self._by_rid: Dict[int, _Seq] = {}

    # ----- lifecycle -----
    def submit(self, requests: List[object]) -> None:
        self.waiting.extend(requests)

    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def admit(self, now: float) -> None:
        """Move arrived requests into the active set while capacity holds.
        FIFO: a request that cannot be admitted blocks later ones (no
        starvation of large requests)."""
        while self.waiting and len(self.active) < self.max_active:
            r = self.waiting[0]
            if getattr(r, "arrival_time", 0.0) > now:
                break
            prompt = np.asarray(r.prompt, np.int32)
            reused, reuse_len = self.alloc.match_prefix(prompt)
            need = blocks_needed(len(prompt), r.max_new_tokens,
                                 self.alloc.block_size) - len(reused)
            fresh = self.alloc.alloc(need) if need > 0 else []
            if fresh is None:
                self.alloc.release(reused)     # retry next iteration
                break
            seq = _Seq(req=r, block_ids=reused + fresh, reuse_len=reuse_len,
                       written=reuse_len, tokens=prompt)
            self.active.append(seq)
            self._by_rid[r.rid] = seq
            self.waiting.pop(0)

    # ----- batch construction -----
    def next_batch(self) -> List[Row]:
        """Decode rows for every running sequence first (1 token each),
        then chunked-prefill rows while the token budget lasts."""
        rows: List[Row] = []
        budget = self.token_budget
        for seq in self.active:
            if len(rows) >= self.max_batch or budget <= 0:
                break
            plen = len(np.asarray(seq.req.prompt))
            if seq.written < plen:
                continue                        # still prefilling
            t = seq.tokens[seq.written:seq.written + 1]
            rows.append(Row(
                rid=seq.req.rid, tokens=np.asarray(t, np.int32),
                positions=np.asarray([seq.written], np.int32),
                context_len=seq.written + 1, block_table=seq.block_ids,
                sample=True, token_index=len(seq.req.out_tokens),
                is_prefill=False))
            budget -= 1
        for seq in self.active:
            if len(rows) >= self.max_batch or budget <= 0:
                break
            plen = len(np.asarray(seq.req.prompt))
            if seq.written >= plen:
                continue
            c = min(self.prefill_chunk, plen - seq.written, budget)
            t = seq.tokens[seq.written:seq.written + c]
            rows.append(Row(
                rid=seq.req.rid, tokens=np.asarray(t, np.int32),
                positions=np.arange(seq.written, seq.written + c, dtype=np.int32),
                context_len=seq.written + c, block_table=seq.block_ids,
                sample=seq.written + c == plen, token_index=0,
                is_prefill=True))
            budget -= c
        return rows

    # ----- results -----
    def advance(self, rid: int, fed: int, sampled: Optional[int]) -> None:
        """Advance one row's state after its step ran: ``fed`` is the number
        of tokens the executed row carried, ``sampled`` the token drawn from
        its last-position logits (None for a mid-prompt prefill chunk).
        Retires the request when its token budget is spent."""
        seq = self._by_rid[rid]
        r = seq.req
        plen = len(np.asarray(r.prompt))
        before = seq.written
        seq.written += fed
        if before < plen <= seq.written:
            # prompt fully in the pool: publish its full blocks now, so
            # later arrivals sharing the prefix reuse them while this
            # request is still decoding
            self.alloc.register_prefix(np.asarray(r.prompt, np.int32),
                                       seq.block_ids)
        if sampled is not None:
            r.out_tokens.append(int(sampled))
            seq.tokens = np.concatenate(
                [seq.tokens, np.asarray([sampled], np.int32)])
            if len(r.out_tokens) >= r.max_new_tokens:
                self._retire(seq)

    def _retire(self, seq: _Seq) -> None:
        r = seq.req
        r.done = True
        # prefix entries (registered at prefill completion) keep their own
        # refs; this only drops the request's ownership
        self.alloc.release(seq.block_ids)
        self.active.remove(seq)
        del self._by_rid[r.rid]
