"""Abstract input factories for dry-runs: ``meta`` tensors (shape and dtype,
no storage) carrying their resolved sharding.

``input_specs`` gives a stand-in for every model input of an (arch x shape)
cell; ``params_specs`` / ``opt_state_specs`` / ``cache_specs`` do the same
for weights, optimizer state and decode caches, with ``NamedSharding``s
resolved through the logical-axis rules (FSDP x TP x EP; the divisibility
guard downgrades kv-head sharding to context-parallel cache sharding). A
stand-in's sharding is ``sharding_of(t)`` (``None`` without a mesh); the
mesh may be an ``AbstractMesh``, so no process group is needed.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.distributed import sharding as shd
from repro_torch.models import Model
from repro_torch.models.common import ParamDef, map_defs, torch_dtype
from repro_torch.models.transformer import CACHE_AXES_BY_KEY


def abstract(shape, dtype, sharding: Optional[shd.NamedSharding] = None):
    """A ``meta`` tensor of ``shape`` and ``dtype`` carrying ``sharding``."""
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    t.sharding = sharding
    return t


def sharding_of(t) -> Optional[shd.NamedSharding]:
    return getattr(t, "sharding", None)


def per_device_bytes(t) -> int:
    """The bytes one device holds of ``t`` under its sharding: its size over
    the product of the mesh axes its spec names."""
    n = t.numel() * t.element_size()
    sh = sharding_of(t)
    if sh is None:
        return n
    sizes = shd.mesh_shape(sh.mesh)
    div = 1
    for axis in sh.spec:
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None:
                div *= sizes[a]
    return n // div


def tree_bytes_per_device(tree) -> int:
    return sum(per_device_bytes(t) for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _act(shape, dtype, mesh, logical):
    if mesh is None:
        return abstract(shape, dtype)
    spec = shd._resolve(mesh, shd._ctx().act_rules, logical, shape)
    return abstract(shape, dtype, shd.NamedSharding(mesh, spec))


def input_specs(cfg: ArchConfig, shape: InputShape, mesh,
                with_labels: bool = True) -> Dict[str, Any]:
    """Batch stand-ins for a train/prefill cell."""
    B, S = shape.global_batch, shape.seq_len
    bf16, i32 = torch.bfloat16, torch.int32
    batch: Dict[str, Any] = {}
    if cfg.input_mode == "embeds":
        batch["embeds"] = _act((B, S, cfg.d_model), bf16, mesh,
                               ("batch", "seq", "embed"))
        if cfg.rope_type == "mrope":
            batch["positions"] = _act((3, B, S), i32, mesh,
                                      (None, "batch", "seq"))
    else:
        batch["tokens"] = _act((B, S), i32, mesh, ("batch", "seq"))
    if cfg.family == "encdec":
        batch["src_embeds"] = _act((B, S, cfg.d_model), bf16, mesh,
                                   ("batch", "seq", "embed"))
        batch["tokens"] = _act((B, S), i32, mesh, ("batch", "seq"))
    if with_labels:
        batch["labels"] = _act((B, S), i32, mesh, ("batch", "seq"))
    return batch


def decode_token_specs(cfg: ArchConfig, shape: InputShape, mesh):
    B = shape.global_batch
    toks = _act((B,), torch.int32, mesh, ("batch",))
    if cfg.input_mode == "embeds":
        emb = _act((B, 1, cfg.d_model), torch.bfloat16, mesh,
                   ("batch", None, "embed"))
        return toks, emb
    return toks, None


def params_specs(model: Model, mesh):
    """Abstract params with FSDP x TP shardings."""
    dt = torch_dtype(model.cfg.dtype)

    def one(pd: ParamDef):
        if mesh is None:
            return abstract(pd.shape, dt)
        return abstract(pd.shape, dt,
                        shd.param_sharding(pd.shape, pd.axes, mesh))

    return map_defs(one, model.param_defs())


def _zero1_spec(pd: ParamDef, mesh) -> shd.NamedSharding:
    """TP sharding + 'data' on the first remaining divisible dim: optimizer
    state fully sharded even when params are replicated over data
    (ZeRO-1)."""
    base = shd._resolve(mesh, shd.SERVE_PARAM_RULES, pd.axes, pd.shape)
    spec = list(base) + [None] * (len(pd.shape) - len(base))
    dsize = shd.mesh_shape(mesh).get("data", 1)
    for i, (dim, cur) in enumerate(zip(pd.shape, spec)):
        if cur is None and dsize > 1 and dim % dsize == 0:
            spec[i] = "data"
            break
    return shd.NamedSharding(mesh, shd.P(*spec))


def opt_state_specs(model: Model, mesh, state_dtype: str = "float32",
                    zero1: bool = False):
    """AdamW state stand-ins with param-aligned shardings (FSDP mode) or
    fully data-sharded state over TP-only params (ZeRO-1 mode); the layout
    of ``optim.adamw.init_state``."""
    sd = torch_dtype(state_dtype)
    half = torch_dtype(model.cfg.dtype) in (torch.bfloat16, torch.float16)

    def mk(pd: ParamDef, dt):
        if mesh is None:
            return abstract(pd.shape, dt)
        if zero1:
            return abstract(pd.shape, dt, _zero1_spec(pd, mesh))
        return abstract(pd.shape, dt,
                        shd.param_sharding(pd.shape, pd.axes, mesh))

    defs = model.param_defs()
    return {
        "step": abstract((), torch.int32,
                         None if mesh is None else shd.replicated(mesh)),
        "m": map_defs(lambda pd: mk(pd, sd), defs),
        "v": map_defs(lambda pd: mk(pd, sd), defs),
        "master": map_defs(
            lambda pd: mk(pd, torch.float32) if half else None, defs),
    }


def cache_specs(model: Model, shape: InputShape, mesh):
    """Abstract decode cache (``Model.init_cache`` on the ``meta`` device)
    with context-parallel-aware shardings."""
    B, S = shape.global_batch, shape.seq_len
    tmpl = model.init_cache(B, S, device="meta")
    flat, spec_tree = pytree.tree_flatten_with_path(tmpl)
    out = []
    for path, t in flat:
        key = None
        for p in reversed(path):
            name = getattr(p, "key", None)
            if isinstance(name, str) and name in CACHE_AXES_BY_KEY:
                key = name
                break
        if mesh is None or key is None:
            out.append(abstract(t.shape, t.dtype))
            continue
        axes = CACHE_AXES_BY_KEY[key]
        # stacked layer caches carry a leading (L,) dim
        if t.dim() == len(axes) + 1:
            axes = ("layers",) + axes
        spec = shd._resolve(mesh, {**shd._ctx().act_rules, "layers": None},
                            axes, tuple(t.shape))
        out.append(abstract(t.shape, t.dtype, shd.NamedSharding(mesh, spec)))
    return pytree.tree_unflatten(out, spec_tree)

