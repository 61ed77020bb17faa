"""Runtime (non-architecture) knobs: the compute and parameter dtypes, the
tensor-parallel config, the loss chunk; plus the device rule every entry
point follows.

Counterpart of ``repro/runtime.py`` without its deprecated flat-name shims.
``remat`` is here (activation checkpointing per period, read by training);
the cache layout and ZeRO knobs arrive with the slices that read them. ``runtime_for`` is the counterpart of
``repro/launch/specs.py::runtime_for``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import torch

from repro_torch.configs.base import ArchConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class TPConfig:
    """Every tensor-parallel decision in one place (``Runtime.tp``); the
    fields and defaults of ``repro.runtime.TPConfig``.

    ``mode`` is a :mod:`repro_torch.core.backends` registry name (``auto``,
    the compiler-scheduled reference, is DTensor in torch: the one-device
    code on DTensors placed as the TP shards, for dense attention blocks in
    training; other blocks and serving raise under it on a group larger
    than one, ROADMAP A5 (b));
    ``chunks=None`` lets the cais backend plan the ring chunking per
    collective; ``microbatches`` is the period-graph batch split (int, or
    ``"auto"``); ``planner`` drives the split and pass 3 (``"greedy"``, or
    ``"perfsim"``: the schedule planner of :mod:`repro_torch.plan`);
    ``sequence_parallel=False``
    keeps the activation whole on every rank between periods (the same
    values; ``models.transformer.LAYOUTS``); ``graph_backward`` is read by
    the training slice (ROADMAP A8)."""

    mode: str = "auto"                  # any repro_torch.core.backends name
    sequence_parallel: bool = True      # SP-TP layout (paper's primary)
    chunks: Optional[int] = None        # ring chunks; None = planner-chosen
    bidirectional: bool = True          # asymmetric/bidirectional overlap
    microbatches: Union[int, str] = 1   # period-graph batch split
    planner: str = "greedy"             # pass-3 planner
    graph_backward: bool = True         # period grads via the graph VJP


@dataclass(frozen=True)
class Runtime:
    # numerics: params are stored in param_dtype and cast to compute_dtype
    # at their use sites
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # distribution: all tensor-parallel knobs
    tp: TPConfig = field(default_factory=TPConfig)
    # activation checkpointing per period and around the remainder tail
    remat: bool = True
    # the cross-entropy runs over sequence chunks of this length (bounds the
    # (B, chunk, vocab) logits)
    loss_chunk: int = 512

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]


SMOKE = Runtime(compute_dtype="float32", remat=False, loss_chunk=64)


def runtime_for(cfg: ArchConfig) -> Runtime:
    """Per-arch production defaults: bf16 compute; f32 params unless the
    model is too large to keep them (> 6e10 parameters)."""
    param_dtype = "bfloat16" if cfg.param_count() > 6e10 else "float32"
    return Runtime(compute_dtype="bfloat16", param_dtype=param_dtype)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Asking for CUDA where there is none raises; nothing moves
    to the CPU unless the caller says ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
