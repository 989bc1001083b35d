"""Optimizer and gradient compression (``repro.optim`` in the reference):
AdamW with an f32 master copy of half-precision parameters, and bf16 / int8
compression of gradients with error feedback."""
from repro_torch.optim.adamw import (
    AdamWConfig, apply_updates, global_norm, init_state, warmup_cosine,
)

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_state",
           "warmup_cosine"]
