"""Deterministic training data (``repro.data`` in the reference)."""
from repro_torch.data.pipeline import (
    DataConfig, Pipeline, Prefetcher, to_device, write_token_file,
)

__all__ = ["DataConfig", "Pipeline", "Prefetcher", "to_device",
           "write_token_file"]
