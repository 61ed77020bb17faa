from repro_torch.models.api import build_model
from repro_torch.models.transformer import LM

__all__ = ["LM", "build_model"]
