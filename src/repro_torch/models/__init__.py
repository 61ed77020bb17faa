from repro_torch.models.api import build_model
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import LM
from repro_torch.models.vlm import VLM

__all__ = ["EncDecLM", "LM", "VLM", "build_model"]
