from repro_torch.data.pipeline import DataConfig, iterate, make_batch

__all__ = ["DataConfig", "iterate", "make_batch"]
