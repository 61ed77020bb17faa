from repro_torch.train.step import (init_state, make_decode_step,
                                    make_prefill_step, make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["init_state", "make_train_step", "make_prefill_step",
           "make_decode_step", "Trainer", "TrainerConfig"]
