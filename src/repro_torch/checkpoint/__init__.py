"""Atomic, asynchronous checkpoints (``repro.checkpoint`` in the
reference)."""
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
