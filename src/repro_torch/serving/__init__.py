"""Serving: continuous batching + sampled shadow profiling of live traffic."""
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.shadow import DriftEvent, ShadowConfig, ShadowProfiler

__all__ = ["Engine", "Request", "ShadowConfig", "ShadowProfiler",
           "DriftEvent"]
