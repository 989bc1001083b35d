"""Carry parameters over from the reference package.

The port keeps the reference's parameter layout (same keys, layer stack on a
leading (L, ...) axis), so conversion is a change of container: every numpy
leaf becomes a tensor of the config's dtype on the requested device, and the
tree is checked against the port's own parameter definitions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.common import ParamDef, resolve_device, torch_dtype


_NATIVE = ("float32", "float64", "float16", "int32", "int64", "bool")


def _to_tensor(arr, dtype, device):
    arr = np.asarray(arr)
    if arr.dtype.name not in _NATIVE:
        # extension float types (bfloat16 as numpy sees it): widen exactly
        arr = arr.astype(np.float32)
    # own, writable copy: the source may be a read-only view of a jax buffer
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def params_from_jax(tree, cfg: ArchConfig, device=None):
    """Turn the reference package's parameter pytree, given as numpy arrays
    (e.g. ``jax.tree_util.tree_map(np.asarray, params)``), into the port's
    parameters. Raises on a missing key, an extra key or a shape that does
    not match ``model_param_defs(cfg)``."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def walk(defs, node, path):
        if isinstance(defs, ParamDef):
            shape = tuple(np.shape(node))
            if shape != tuple(defs.shape):
                raise ValueError(f"{path}: shape {shape} does not match "
                                 f"{tuple(defs.shape)}")
            return _to_tensor(node, dtype, device)
        if not isinstance(node, dict) or set(node) != set(defs):
            have = sorted(node) if isinstance(node, dict) else type(node)
            raise ValueError(f"{path or '<root>'}: expected keys "
                             f"{sorted(defs)}, got {have}")
        return {k: walk(defs[k], node[k], f"{path}/{k}" if path else k)
                for k in defs}

    return walk(transformer.model_param_defs(cfg), tree, "")
