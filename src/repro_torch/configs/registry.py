"""Arch registry of the port: every arch of ``repro``'s registry. The dense
attention archs, minicpm3-4b (MLA), mamba2-130m (the Mamba-2 SSD mixer),
recurrentgemma-2b (RG-LRU + local attention), whisper-tiny (enc-dec),
paligemma-3b (prefix-LM VLM), and the MoE archs mixtral-8x7b and
arctic-480b (128 experts with a dense residual, trained with
adafactor)."""
from __future__ import annotations

from repro_torch.configs.arctic_480b import ARCTIC_480B
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.deepseek_7b import DEEPSEEK_7B
from repro_torch.configs.gemma3_1b import GEMMA3_1B
from repro_torch.configs.internlm2_1_8b import INTERNLM2_1_8B
from repro_torch.configs.mamba2_130m import MAMBA2_130M
from repro_torch.configs.minicpm3_4b import MINICPM3_4B
from repro_torch.configs.mixtral_8x7b import MIXTRAL_8X7B
from repro_torch.configs.paligemma_3b import PALIGEMMA_3B
from repro_torch.configs.recurrentgemma_2b import RECURRENTGEMMA_2B
from repro_torch.configs.whisper_tiny import WHISPER_TINY

ARCHS = {a.name: a for a in (DEEPSEEK_7B, INTERNLM2_1_8B, GEMMA3_1B,
                             MINICPM3_4B, MIXTRAL_8X7B, MAMBA2_130M,
                             RECURRENTGEMMA_2B, WHISPER_TINY, PALIGEMMA_3B,
                             ARCTIC_480B)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
