"""Model facade: binds an ArchConfig to init / loss / forward / prefill."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.common import (
    count_params, init_tree, resolve_device, torch_dtype,
)


class Model:
    """A thin, stateless namespace of pure functions bound to ``cfg``.
    Parameters are a plain nested dict of tensors with the layer stack on a
    leading (L, ...) axis — the reference package's layout, so its
    parameters carry over through ``models.convert.params_from_jax``."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    # ---- parameters -------------------------------------------------------
    def param_defs(self):
        return transformer.model_param_defs(self.cfg)

    def init(self, seed: int = 0, *, device=None) -> Dict[str, Any]:
        """Random parameters from ``seed``, made on ``device`` (``None`` =
        the CUDA device; raises if there is none)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_tree(self.param_defs(), gen, torch_dtype(self.cfg.dtype),
                         device)

    def n_params(self) -> int:
        return count_params(self.param_defs())

    # ---- execution --------------------------------------------------------
    def loss(self, params, batch):
        return transformer.loss_fn(params, batch, self.cfg)

    def forward(self, params, batch):
        return transformer.forward(params, batch, self.cfg)

    def prefill(self, params, batch):
        return transformer.prefill(params, batch, self.cfg)

    def init_cache(self, batch_size: int, seq_len: int):
        return transformer.init_cache(self.cfg, batch_size, seq_len)

    def decode_step(self, params, cache, tokens, embeds=None):
        return transformer.decode_step(params, cache, tokens, self.cfg,
                                       embeds=embeds)
