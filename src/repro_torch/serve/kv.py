"""Paged KV-cache bookkeeping: block allocator, refcounts, prefix cache.
A copy of ``repro/serve/kv.py`` (numpy only).

The device side of paged attention lives in :mod:`repro_torch.models.attention`
(``init_kv_pool`` / ``paged_update`` / ``paged_lookup`` and the ``KVView``
seam the model reads and writes through). This module is the host side:
which pool blocks belong to which request. A :class:`BlockAllocator` hands
out fixed-size blocks from a free list, refcounts them so prefix-shared
blocks are freed exactly once, and keeps an LRU prefix cache mapping
token-prefix bytes to block lists so a new request whose prompt starts with
an already-prefilled prefix skips recomputing (and re-storing) those
blocks. Layout and policy are documented in docs/serving.md.

Invariants:
- a block's refcount = (#requests whose block table contains it) +
  (#prefix-cache entries that contain it); it returns to the free list only
  at zero.
- prefix reuse covers only FULL blocks and at most ``len(prompt) - 1``
  tokens (block-aligned), so every admitted request feeds at least one
  prompt token and shared blocks are never written again — no
  copy-on-write is needed.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.models.attention import KVView  # re-export: the narrow seam

__all__ = ["BlockAllocator", "KVView", "blocks_needed"]


def blocks_needed(prompt_len: int, max_new_tokens: int, block_size: int
                  ) -> int:
    """Worst-case blocks for one request: every KV position it can ever
    write. The final sampled token is never fed back, so the last written
    position is ``prompt_len + max_new_tokens - 2`` (prompt positions are
    ``0..prompt_len-1``; decode writes ``prompt_len..``)."""
    positions = prompt_len + max(max_new_tokens - 1, 0)
    return max(-(-positions // block_size), 1)


class BlockAllocator:
    """Free-list block allocator with refcounts and an LRU prefix cache."""

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_cache: bool = True):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("need at least one block of size >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # pop() takes from the tail: reversed range hands out low ids first
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks
        self._cache: "OrderedDict[bytes, List[int]]" = OrderedDict()
        self.prefix_cache_enabled = prefix_cache
        self.prefix_hits = 0
        self.peak_used = 0

    # ----- accounting -----
    def num_free(self) -> int:
        return len(self._free)

    def utilization(self) -> float:
        return 1.0 - len(self._free) / self.num_blocks

    def _incref(self, ids: List[int]) -> None:
        for b in ids:
            self._ref[b] += 1

    def _decref(self, ids: List[int]) -> None:
        for b in ids:
            self._ref[b] -= 1
            assert self._ref[b] >= 0, f"double free of block {b}"
            if self._ref[b] == 0:
                self._free.append(b)

    # ----- allocation -----
    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks at refcount 1, or None if the pool cannot satisfy
        the request even after evicting cache-only prefix entries (LRU
        first). Returning None (instead of raising) lets the scheduler
        simply defer admission until running requests retire."""
        while n > len(self._free) and self._cache:
            key, ids = self._cache.popitem(last=False)   # LRU
            self._decref(ids)
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._incref(out)
        self.peak_used = max(self.peak_used, self.num_blocks - len(self._free))
        return out

    def release(self, ids: List[int]) -> None:
        """Drop one request's ownership; blocks still referenced by the
        prefix cache (or another request) stay resident."""
        self._decref(ids)

    # ----- prefix cache -----
    def _key(self, tokens: np.ndarray, k: int) -> bytes:
        return np.asarray(tokens[:k * self.block_size], np.int32).tobytes()

    def match_prefix(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """Longest cached block-aligned proper prefix of ``tokens``.
        Returns (block ids — increfed on behalf of the caller, reused token
        count). Reuse is capped at ``len(tokens) - 1`` so the request still
        feeds >= 1 token (the logits seed the first sampled token)."""
        if not self.prefix_cache_enabled:
            return [], 0
        k_max = (len(tokens) - 1) // self.block_size
        for k in range(k_max, 0, -1):
            ids = self._cache.get(self._key(tokens, k))
            if ids is not None:
                self._cache.move_to_end(self._key(tokens, k))
                self._incref(ids)
                self.prefix_hits += 1
                return list(ids), k * self.block_size
        return [], 0

    def register_prefix(self, tokens: np.ndarray, ids: List[int]) -> None:
        """Publish a fully-prefilled prompt's blocks: one cache entry per
        full-block prefix length (nested, so future prompts sharing fewer
        blocks still match). Each entry holds its own reference."""
        if not self.prefix_cache_enabled:
            return
        for k in range(1, len(tokens) // self.block_size + 1):
            key = self._key(tokens, k)
            if key not in self._cache:
                self._cache[key] = list(ids[:k])
                self._incref(ids[:k])
            else:
                self._cache.move_to_end(key)
