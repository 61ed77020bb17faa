from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["ARCHS", "ArchConfig", "get_arch"]
