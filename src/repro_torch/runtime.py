"""Runtime (non-architecture) knobs: the compute and parameter dtypes; plus
the device rule every entry point follows.

Counterpart of ``repro/runtime.py`` without its deprecated flat-name shims.
The tensor-parallel config (``TPConfig``) arrives with the TP slice that
reads it (ROADMAP A4-A7); the memory and optimizer knobs (remat, loss
chunking, cache layout, ZeRO) with the slices that read them.
``runtime_for`` is the counterpart of ``repro/launch/specs.py::runtime_for``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class Runtime:
    # numerics: params are stored in param_dtype and cast to compute_dtype
    # at their use sites
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]


SMOKE = Runtime(compute_dtype="float32")


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
