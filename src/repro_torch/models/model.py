"""Model facade: binds an ArchConfig to init / loss / forward / prefill /
decode."""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as _shd
from repro_torch.models import encdec, transformer
from repro_torch.models.common import (
    abstract_tree, axes_tree, count_params, init_tree, resolve_device,
    torch_dtype,
)


def _sharded_family(cfg: ArchConfig) -> bool:
    """The families whose programs run on sharded parameters: dense GQA
    and MoE (olmoe-1b-7b) without M-RoPE."""
    return (cfg.family in ("dense", "moe") and cfg.attn_type == "gqa"
            and cfg.rope_type != "mrope")


def on_mesh(cfg: ArchConfig, *trees):
    """The context a model's program runs in. On DTensor parameters (or
    inputs) the program runs on the shards; the families not ported to a
    mesh of more than one rank raise ``NotImplementedError`` there."""
    mesh = next((x.device_mesh for x in _iter_dtensors(trees)), None)
    if mesh is not None and mesh.size() > 1 and not _sharded_family(cfg):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}, {cfg.attn_type} attention, "
            f"{cfg.rope_type} positions) on a mesh of {mesh.size()} ranks "
            f"{dict(_shd.mesh_shape(mesh))}: sharded parameters are ported "
            "for the dense and MoE GQA families only")
    return contextlib.nullcontext()


def _iter_dtensors(trees):
    from torch.utils import _pytree as pytree
    return (x for x in pytree.tree_leaves(trees) if _shd._is_dtensor(x))


class Model:
    """A thin, stateless namespace of pure functions bound to ``cfg``.
    Parameters are a plain nested dict (and, for leading dense layers, list)
    of tensors with each layer stack on a leading (L, ...) axis — the
    reference package's layout, so its parameters carry over through
    ``models.convert.params_from_jax``. They may be DTensors laid out on a
    mesh (``place_params``): the program then runs on the shards
    (``on_mesh``)."""

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

    def place_params(self, params, mesh, rules=None):
        """``params`` laid out on ``mesh`` under ``rules``
        (``DEFAULT_PARAM_RULES`` by default: FSDP x TP; serving takes
        ``SERVE_PARAM_RULES``): every leaf a DTensor of this rank's
        shard."""
        return _shd.place_params(params, self.param_defs(), mesh,
                                 _shd.DEFAULT_PARAM_RULES if rules is None
                                 else rules)

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
        with on_mesh(self.cfg, params, batch):
            return self._mod.loss_fn(params, batch, self.cfg)

    def forward(self, params, batch):
        with on_mesh(self.cfg, params, batch):
            return self._mod.forward(params, batch, self.cfg)

    def prefill(self, params, batch):
        """Last-token logits (B, vocab) of a full prompt."""
        with on_mesh(self.cfg, params, batch):
            return self._mod.forward(params, batch, self.cfg,
                                     last_only=True)[:, 0]

    def init_cache(self, batch_size: int, seq_len: int, *, device=None):
        """The decode cache for ``batch_size`` slots of ``seq_len`` tokens,
        on ``device`` (``None`` = the CUDA device; raises if there is
        none)."""
        return self._mod.init_cache(self.cfg, batch_size, seq_len,
                                    device=device)

    def place_cache(self, cache, mesh):
        """A decode cache laid out on ``mesh`` by the activation rules
        (``DEFAULT_ACT_RULES``): the key / value caches over ``kv_heads``,
        as the attention's keys and values are."""
        rules = _shd.DEFAULT_ACT_RULES

        def walk(axes, t):
            if isinstance(t, dict):
                return {k: walk(axes[k], v) for k, v in t.items()}
            if isinstance(t, list):
                return [walk(a, v) for a, v in zip(axes, t)]
            return _shd.place(t, _shd.NamedSharding(
                mesh, _shd._resolve(mesh, rules, axes, tuple(t.shape))))
        return walk(transformer.cache_axes(cache), cache)

    def decode_step(self, params, cache, tokens, embeds=None):
        """One token for every slot: ``(logits (B, vocab), new cache)``."""
        with on_mesh(self.cfg, params, cache, tokens):
            if self.cfg.family == "encdec":
                return encdec.decode_step(params, cache, tokens, self.cfg)
            return transformer.decode_step(params, cache, tokens, self.cfg,
                                           embeds=embeds)
