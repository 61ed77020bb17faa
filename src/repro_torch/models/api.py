"""Model factory: ArchConfig -> model. Counterpart of
``repro/models/api.py``: the enc-dec model, the VLM or the decoder-only
``LM``."""
from __future__ import annotations

from typing import Optional, Union

from repro_torch.configs.base import ArchConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import LM
from repro_torch.models.vlm import VLM
from repro_torch.runtime import Runtime


def build_model(cfg: ArchConfig, rt: Runtime = Runtime(), *, device=None,
                seed: Optional[int] = 0, group=None
                ) -> Union[EncDecLM, VLM, LM]:
    """The model of ``cfg``; ``group`` a TP ring or a mesh
    (:class:`repro_torch.sharding.Mesh`), as JAX's ``mesh=`` (the enc-dec
    model raises on one)."""
    if cfg.is_enc_dec:
        return EncDecLM(cfg, rt, device=device, seed=seed, group=group)
    if cfg.num_prefix_tokens > 0:
        return VLM(cfg, rt, device=device, seed=seed, group=group)
    return LM(cfg, rt, device=device, seed=seed, group=group)
