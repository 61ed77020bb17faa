from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME, ArchConfig,
                                      ShapeConfig)
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["ARCHS", "ArchConfig", "SHAPES", "SHAPES_BY_NAME", "ShapeConfig",
           "get_arch"]
