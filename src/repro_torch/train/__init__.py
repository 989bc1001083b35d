"""Train steps (``repro.train`` in the reference)."""
from repro_torch.train.trainer import (
    TrainConfig, init_opt_state, make_hotswap_train_step, make_train_step,
    value_and_grad,
)

__all__ = ["TrainConfig", "init_opt_state", "make_hotswap_train_step",
           "make_train_step", "value_and_grad"]
