from repro_torch.optim.compression import (
    compressed_psum,
    init_error_feedback,
    wire_bytes_saved,
)
from repro_torch.optim.optimizers import (
    Leaf,
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    constant_schedule,
    cosine_schedule,
    global_norm,
    make_optimizer,
)

__all__ = [
    "Leaf", "Optimizer", "adafactor", "adamw", "make_optimizer", "cosine_schedule",
    "constant_schedule", "clip_by_global_norm", "global_norm",
    "compressed_psum", "init_error_feedback", "wire_bytes_saved",
]
