"""Mesh construction over ``torch.distributed``: one rank per device.

Single pod: (data=16, model=16) = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices; the leading ``pod``
axis is pure data parallelism across pods.

Every function builds a ``DeviceMesh`` over the ranks of the default process
group (started by the caller: ``torchrun`` or ``launch.train --coordinator``;
a process that has none gets a group of one rank). A mesh takes the first
ranks it needs, and asking for more devices than there are ranks raises:
a mesh is never shrunk quietly. The device type is ``cuda`` unless the
caller passes ``device="cpu"`` (gloo; the tests).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def _device_type(device) -> str:
    return torch.device(device).type if device is not None else "cuda"


def ensure_process_group(device=None) -> int:
    """The world size, after starting a process group of one rank (an
    in-memory store, no network) when none is running."""
    import torch.distributed as dist
    if not dist.is_initialized():
        kind = _device_type(device)
        if kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' for a gloo mesh")
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def device_mesh(shape: Sequence[int], axes: Sequence[str], device=None,
                who: str = "device_mesh"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks; ``ValueError`` when there are fewer."""
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    world = ensure_process_group(device)
    if n > world:
        raise ValueError(f"{who}: {n} devices requested, {world} visible")
    import torch.distributed as dist
    kind = _device_type(device)
    if kind == "cuda" and dist.get_backend() == "gloo":
        from repro_torch.distributed.sharding import (
            route_gloo_cuda_collectives)
        route_gloo_cuda_collectives()
    return DeviceMesh(kind, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return device_mesh(shape, axes, device, "make_production_mesh")


def make_host_mesh(model_parallel: int = 1, device=None):
    """A (data, model) mesh over every rank (tests / one-host runs)."""
    n = ensure_process_group(device)
    mp = model_parallel
    while mp > 1 and n % mp:
        mp //= 2
    return device_mesh((n // mp, mp), ("data", "model"), device,
                       "make_host_mesh")


def make_probe_mesh(n_devices: Optional[int] = None, axis: str = "probe",
                    device=None):
    """1-D mesh for mesh-parallel profiling: the leading candidate axis of a
    (K, num_sites, 4) format-table batch is split over ``axis``, so a
    W-candidate ladder evaluates W / n candidates on each rank
    (``api.truncate_sweep(mesh=...)`` / ``search.autosearch(mesh=...)``).
    ``n_devices`` takes the first ranks; default is every rank."""
    n = ensure_process_group(device) if n_devices is None else n_devices
    return device_mesh((n,), (axis,), device, "make_probe_mesh")


def make_profile_mesh(probe: int, data: int = 1, *,
                      axes: Tuple[str, str] = ("probe", "data"), device=None):
    """2-D (probe, data) mesh: candidate-parallel x data-parallel profiling.
    ``probe * data`` must not exceed the number of ranks."""
    return device_mesh((probe, data), tuple(axes), device,
                       "make_profile_mesh")
