"""Arch registry of the port: the dense attention-only archs the paged
serving path runs. The other archs of ``repro``'s registry are named here so
that asking for one says it is not ported yet."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.deepseek_7b import DEEPSEEK_7B
from repro_torch.configs.gemma3_1b import GEMMA3_1B
from repro_torch.configs.internlm2_1_8b import INTERNLM2_1_8B

ARCHS = {a.name: a for a in (DEEPSEEK_7B, INTERNLM2_1_8B, GEMMA3_1B)}

# in repro's registry, waiting for their model families (ROADMAP A10, A15)
NOT_PORTED = ("paligemma-3b", "mamba2-130m", "whisper-tiny", "minicpm3-4b",
              "recurrentgemma-2b", "mixtral-8x7b", "arctic-480b")


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; the port serves "
            f"{sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
