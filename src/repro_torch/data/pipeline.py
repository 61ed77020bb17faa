"""Deterministic synthetic token pipeline: a copy of
``repro/data/pipeline.py``, which is numpy only, so the port draws the same
tokens for the same (seed, step).

Batches are generated from a PRNG keyed on (seed, step): any step's batch is
reproducible without replaying the stream. Each process may materialize only
its slice of the global batch (``host_slice``): on a mesh with a data axis
of ``dp`` replicas, replica ``d`` takes rows ``[d·B/dp, (d+1)·B/dp)``
(:func:`replica_slice`), as JAX's ``BATCH_AXES`` sharding gives them. An
enc-dec arch's batch also holds ``src_embed`` (B, max_source_len, d_model)
and a VLM's ``patch_embed`` (B, num_prefix_tokens, vision_width), standard
normal f32 from their own generators keyed on (seed, step), JAX's arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # synthetic "documents": zipf-ish token marginals + shift labels
    zipf_alpha: float = 1.1


def _tokens_for_step(cfg: ArchConfig, batch: int, seq: int, seed: int,
                     step: int, zipf_alpha: float) -> np.ndarray:
    rng = np.random.default_rng(np.random.PCG64(seed * 1_000_003 + step))
    # zipf marginal bounded to vocab
    ranks = rng.zipf(zipf_alpha, size=(batch, seq + 1)).astype(np.int64)
    return (ranks % cfg.vocab_size).astype(np.int32)


def make_batch(cfg: ArchConfig, shape: ShapeConfig, step: int,
               data: Optional[DataConfig] = None,
               host_slice: Optional[slice] = None) -> Dict[str, np.ndarray]:
    """One global (or host-sliced) training batch for (arch, shape, step)."""
    data = data if data is not None else DataConfig()
    b, s = shape.global_batch, shape.seq_len
    toks = _tokens_for_step(cfg, b, s, data.seed, step, data.zipf_alpha)
    if host_slice is not None:
        toks = toks[host_slice]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    n = toks.shape[0]
    # ``seed ^ 0xE0C + step`` is ``seed ^ (0xE0C + step)``, as in JAX
    if cfg.is_enc_dec:
        rng = np.random.default_rng(np.random.PCG64(data.seed ^ 0xE0C + step))
        batch["src_embed"] = rng.standard_normal(
            (n, cfg.encoder.max_source_len, cfg.d_model)).astype(np.float32)
    if cfg.num_prefix_tokens:
        rng = np.random.default_rng(np.random.PCG64(data.seed ^ 0x1A6 + step))
        batch["patch_embed"] = rng.standard_normal(
            (n, cfg.num_prefix_tokens, cfg.vision_width)).astype(np.float32)
    return batch


def replica_slice(global_batch: int, index: int, dp: int) -> slice:
    """The rows of a global batch of ``global_batch`` that data replica
    ``index`` of ``dp`` takes."""
    if global_batch % dp:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over {dp} data replicas")
    b = global_batch // dp
    return slice(index * b, (index + 1) * b)


def replica_rows(batch: Dict[str, np.ndarray], index: int, dp: int
                 ) -> Dict[str, np.ndarray]:
    """Data replica ``index``'s rows of every array of a global batch."""
    sl = replica_slice(next(iter(batch.values())).shape[0], index, dp)
    return {k: v[sl] for k, v in batch.items()}


def iterate(cfg: ArchConfig, shape: ShapeConfig, start_step: int = 0,
            data: Optional[DataConfig] = None,
            host_slice: Optional[slice] = None
            ) -> Iterator[Dict[str, np.ndarray]]:
    data = data if data is not None else DataConfig()
    step = start_step
    while True:
        yield make_batch(cfg, shape, step, data, host_slice)
        step += 1
