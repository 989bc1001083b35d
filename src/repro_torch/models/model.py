"""Model facade: binds an ArchConfig to init / loss / forward / prefill /
decode."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.common import (
    abstract_tree, axes_tree, count_params, init_tree, resolve_device,
    torch_dtype,
)


class Model:
    """A thin, stateless namespace of pure functions bound to ``cfg``.
    Parameters are a plain nested dict (and, for leading dense layers, list)
    of tensors with each layer stack on a leading (L, ...) axis — the
    reference package's layout, so its parameters carry over through
    ``models.convert.params_from_jax``."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self._mod = encdec if cfg.family == "encdec" else transformer

    # ---- parameters -------------------------------------------------------
    def param_defs(self):
        return self._mod.model_param_defs(self.cfg)

    def init(self, seed: int = 0, *, device=None) -> Dict[str, Any]:
        """Random parameters from ``seed``, made on ``device`` (``None`` =
        the CUDA device; raises if there is none)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_tree(self.param_defs(), gen, torch_dtype(self.cfg.dtype),
                         device)

    def abstract_params(self):
        """The parameters as ``meta`` tensors in ``cfg.dtype``: shapes and
        dtypes with no storage."""
        return abstract_tree(self.param_defs(), torch_dtype(self.cfg.dtype))

    def param_axes(self):
        """Each parameter's logical axis names (``distributed.sharding``)."""
        return axes_tree(self.param_defs())

    def n_params(self) -> int:
        return count_params(self.param_defs())

    def n_active_params(self) -> int:
        """Active parameters per token (MoE discount) for 6ND roofline."""
        cfg = self.cfg
        total = self.n_params()
        if cfg.moe is None:
            return total
        mc = cfg.moe
        n_stack = cfg.n_layers - mc.first_k_dense
        per_expert = 3 * cfg.d_model * mc.d_expert  # swiglu wi(2x) + wo
        inactive = n_stack * (mc.n_experts - mc.top_k) * per_expert
        return total - inactive

    # ---- execution --------------------------------------------------------
    def loss(self, params, batch):
        return self._mod.loss_fn(params, batch, self.cfg)

    def forward(self, params, batch):
        return self._mod.forward(params, batch, self.cfg)

    def prefill(self, params, batch):
        """Last-token logits (B, vocab) of a full prompt."""
        return self._mod.forward(params, batch, self.cfg,
                                 last_only=True)[:, 0]

    def init_cache(self, batch_size: int, seq_len: int, *, device=None):
        """The decode cache for ``batch_size`` slots of ``seq_len`` tokens,
        on ``device`` (``None`` = the CUDA device; raises if there is
        none)."""
        return self._mod.init_cache(self.cfg, batch_size, seq_len,
                                    device=device)

    def decode_step(self, params, cache, tokens, embeds=None):
        """One token for every slot: ``(logits (B, vocab), new cache)``."""
        if self.cfg.family == "encdec":
            return encdec.decode_step(params, cache, tokens, self.cfg)
        return transformer.decode_step(params, cache, tokens, self.cfg,
                                       embeds=embeds)
