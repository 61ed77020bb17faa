from repro_torch.checkpoint.store import (AsyncSaver, latest_step,
                                          load_state, restore, save)

__all__ = ["AsyncSaver", "save", "restore", "latest_step", "load_state"]
