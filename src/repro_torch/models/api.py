"""Model factory: ArchConfig -> model. Counterpart of
``repro/models/api.py``; the port builds the decoder-only ``LM`` only."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import LM
from repro_torch.runtime import Runtime


def build_model(cfg: ArchConfig, rt: Runtime = Runtime(), *, device=None,
                seed: Optional[int] = 0, group=None) -> LM:
    """The ``LM`` of ``cfg``; ``group`` a TP ring or a mesh
    (:class:`repro_torch.sharding.Mesh`), as JAX's ``mesh=``."""
    return LM(cfg, rt, device=device, seed=seed, group=group)
