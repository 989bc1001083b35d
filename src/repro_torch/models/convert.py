"""Carry parameters over from the reference package.

The port keeps the reference's parameter layout (same keys, layer stacks on
a leading (L, ...) axis, leading dense layers as a list), so conversion is a
change of container: every numpy leaf becomes a tensor of the config's dtype
on the requested device, and the tree is checked against the port's own
parameter definitions (the decoder's or the encoder-decoder's).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamDef, resolve_device, torch_dtype
from repro_torch.models.model import Model


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
    parameters. Raises on a missing key, an extra key, a list of another
    length or a shape that does not match ``Model(cfg).param_defs()``."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def walk(defs, node, path):
        where = path or "<root>"
        if isinstance(defs, ParamDef):
            shape = tuple(np.shape(node))
            if shape != tuple(defs.shape):
                raise ValueError(f"{where}: shape {shape} does not match "
                                 f"{tuple(defs.shape)}")
            return _to_tensor(node, dtype, device)
        if isinstance(defs, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(defs):
                have = (len(node) if isinstance(node, (list, tuple))
                        else type(node).__name__)
                raise ValueError(f"{where}: expected a list of {len(defs)}, "
                                 f"got {have}")
            return [walk(d, n, f"{path}[{i}]")
                    for i, (d, n) in enumerate(zip(defs, node))]
        if not isinstance(node, dict) or set(node) != set(defs):
            have = sorted(node) if isinstance(node, dict) else type(node)
            raise ValueError(f"{where}: expected keys "
                             f"{sorted(defs)}, got {have}")
        return {k: walk(defs[k], node[k], f"{path}/{k}" if path else k)
                for k in defs}

    return walk(Model(cfg).param_defs(), tree, "")
