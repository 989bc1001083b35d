"""Logical-axis sharding rules (FSDP x TP x EP x (pod)DP) on a DeviceMesh.

Models annotate activations with *logical* axis names via ``constrain``;
parameters carry logical axes in their ``ParamDef``. A rules table maps
logical names onto mesh axes. When no mesh is active every annotation is a
no-op that issues no aten call.

Conventions (the reference's):
  activations:  batch -> (pod?, data), heads/kv/mlp/experts -> model,
                embed/seq -> replicated (seq -> model for long-context KV
                caches: context parallelism)
  parameters:   embed -> data (FSDP), heads/mlp/vocab/experts -> model,
                layer stack dim -> replicated
Divisibility guard: an annotation on a dim not divisible by its mesh axis is
dropped (kv_heads=2 on a 4-way model axis falls back to replicated).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (one rank per
device, ``launch.mesh``), or anything whose ``shape`` maps axis names to
sizes (``AbstractMesh``): the resolution reads the shape alone, so specs for
a 256-device mesh resolve in one process with no process group. A spec is
``P``, a tuple of mesh-axis names (or tuples of them, or ``None``) per tensor
dimension, as JAX's ``PartitionSpec``; on a DeviceMesh it resolves to DTensor
placements (``Shard(d)`` / ``Replicate()``).

The port runs one program per rank. Where the reference's GSPMD keeps a
program's semantics global, the port gathers sharded inputs and runs the
global program on every rank (``gather_tree``); the candidate axis of a
swept table batch is what it divides between ranks (``probe_axis_size``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils import _pytree as pytree

Axis = Union[None, str, Tuple[str, ...]]

# logical name -> mesh axis (or tuple) for ACTIVATIONS
DEFAULT_ACT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "cache_seq": "model",   # context-parallel KV cache for decode
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "qk": None,
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "state": None,
}

# logical name -> mesh axis for PARAMETERS (training: FSDP x TP)
DEFAULT_PARAM_RULES = {
    "layers": None,
    "embed": "data",        # FSDP
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "qk": None,
    "state": None,
    "conv": None,
}

# serving: TP-only -- no per-layer FSDP all-gathers on the decode critical
# path (used when the params fit a single model-parallel shard group)
SERVE_PARAM_RULES = {**DEFAULT_PARAM_RULES, "embed": None}


class P(tuple):
    """A partition spec: per tensor dimension a mesh axis name, a tuple of
    names, or ``None`` (replicated); trailing dimensions not named are
    replicated."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


class AbstractMesh:
    """A mesh's shape alone: axis name -> size, in axis order. Specs
    resolve against it without devices or a process group (the dry-run's
    256- and 512-device meshes)."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a DeviceMesh, an ``AbstractMesh`` or anything
    whose ``shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    shape = getattr(mesh, "shape", None)
    if not hasattr(shape, "keys"):
        raise TypeError(f"not a mesh: {type(mesh).__name__} (want a "
                        "DeviceMesh, launch.mesh, or a shape of named axes)")
    return dict(shape)


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


def is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``spec`` over ``mesh``: JAX's ``NamedSharding``."""
    mesh: Any
    spec: P = P()

    def placements(self, ndim: Optional[int] = None) -> list:
        """The DTensor placements of this spec, one per mesh axis: the
        tensor dimension an axis shards (``Shard(d)``), else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        by_axis = {}
        for d, axis in enumerate(self.spec):
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is not None:
                    by_axis[a] = d
        if ndim is not None and len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more dimensions than "
                             f"a rank-{ndim} tensor")
        return [Shard(by_axis[a]) if a in by_axis else Replicate()
                for a in mesh_shape(self.mesh)]


@dataclasses.dataclass
class ShardingContext:
    mesh: Any = None
    act_rules: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_ACT_RULES))
    param_rules: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_PARAM_RULES))


_state = threading.local()


def _ctx() -> ShardingContext:
    if not hasattr(_state, "ctx"):
        _state.ctx = ShardingContext()
    return _state.ctx


def current_mesh():
    """The mesh of the innermost ``use_mesh``, or ``None``."""
    return _ctx().mesh


@contextlib.contextmanager
def use_mesh(mesh, act_rules: Optional[dict] = None,
             param_rules: Optional[dict] = None):
    old = getattr(_state, "ctx", None)
    _state.ctx = ShardingContext(
        mesh=mesh,
        act_rules=dict(act_rules or DEFAULT_ACT_RULES),
        param_rules=dict(param_rules or DEFAULT_PARAM_RULES),
    )
    try:
        yield _state.ctx
    finally:
        if old is None:
            del _state.ctx
        else:
            _state.ctx = old


def _mesh_axis_size(shape: Dict[str, int], axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return shape[axis] if axis in shape else 0
    return math.prod(shape[a] for a in axis if a in shape)


def _resolve(mesh, rules: dict, logical: Tuple[Optional[str], ...],
             shape: Tuple[int, ...]) -> P:
    """The spec of a tensor of ``shape`` whose dimensions carry the logical
    names ``logical``: each name's mesh axis by ``rules``, unless the axis
    is not in the mesh, is used by an earlier dimension, has size 1, or does
    not divide the dimension (the divisibility guard)."""
    axes = mesh_shape(mesh)
    spec = []
    used = set()
    for name, dim in zip(logical, shape):
        axis = rules.get(name) if name is not None else None
        if axis is not None:
            if isinstance(axis, tuple):
                axis = tuple(a for a in axis if a in axes and a not in used)
                axis = axis or None
            elif axis not in axes or axis in used:
                axis = None
        if axis is not None:
            size = _mesh_axis_size(axes, axis)
            if size <= 1 or dim % size != 0:
                axis = None  # divisibility guard
        if axis is not None:
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                used.add(a)
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        spec.append(axis)
    while spec and spec[-1] is None:
        spec.pop()
    return P(*spec)


def _is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *logical: Optional[str]):
    """Apply a logical-axis sharding constraint to an activation. No-op
    (no aten call) without an active mesh or on a mesh of one device; a
    DTensor is redistributed to the resolved placements, a plain tensor
    (the global value, as every rank holds it) is left as it is."""
    ctx = _ctx()
    if ctx.mesh is None or mesh_size(ctx.mesh) == 1:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"rank mismatch: {logical} vs {tuple(x.shape)}")
    if not _is_dtensor(x):
        return x
    spec = _resolve(ctx.mesh, ctx.act_rules, logical, tuple(x.shape))
    return redistribute(x, NamedSharding(x.device_mesh, spec))


def param_sharding(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
                   mesh) -> NamedSharding:
    spec = _resolve(mesh, _ctx().param_rules, logical, shape)
    return NamedSharding(mesh, spec)


def param_pspec(shape, logical, mesh) -> P:
    return _resolve(_ctx().mesh or mesh, _ctx().param_rules, logical, shape)


# ---------------------------------------------------------------------------
# profiling-stack shardings (mesh-parallel truncate / mem-mode / autosearch)
# ---------------------------------------------------------------------------
# The sharded profiling path partitions work along two axes:
#   * the CANDIDATE axis -- the leading K axis of a (K, num_sites, 4) format
#     table batch. Each candidate policy is independent: the ranks along
#     ``probe_axis`` evaluate K / n candidates each, and the rows are
#     gathered back in order.
#   * the DATA axis -- the profiled inputs' batch. The port keeps such a
#     program's semantics global: sharded inputs are gathered and every rank
#     runs the whole program (``gather_tree``); reports of per-shard runs of
#     a per-example program reduce with ``RaptorReport.allreduce``.
# The (num_sites, 4) table rows themselves are always replicated.

def replicated(mesh) -> NamedSharding:
    """Fully-replicated sharding (format tables, small operands)."""
    return NamedSharding(mesh, P())


def probe_sharding(mesh, axis: str = "probe") -> NamedSharding:
    """Shard the leading candidate axis of a table batch over ``axis``;
    replicated when the mesh has no such axis."""
    if axis not in mesh_shape(mesh):
        return replicated(mesh)
    return NamedSharding(mesh, P(axis))


def batch_sharding(mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (batch) dim of profiled inputs over ``axis``."""
    if axis not in mesh_shape(mesh):
        return replicated(mesh)
    return NamedSharding(mesh, P(axis))


def probe_axis_size(mesh, axis: str = "probe") -> int:
    """Number of shards the candidate axis is split into (1 = unsharded)."""
    if mesh is None:
        return 1
    return int(mesh_shape(mesh).get(axis, 1))


def pad_to_shards(n: int, mesh, axis: str = "probe") -> int:
    """Round a candidate-batch width up so the leading axis divides evenly
    across the mesh's ``axis``."""
    size = probe_axis_size(mesh, axis)
    return -(-n // size) * size


def drop_padded_rows(tree, n_real: int):
    """Slice identity-padded rows off the leading (candidate) axis of every
    leaf of a batched result, so padded and unpadded paths stay
    bit-identical."""
    return pytree.tree_map(lambda a: a[:n_real], tree)


def _is_sharding_leaf(x) -> bool:
    return x is None or isinstance(x, (P, NamedSharding))


def flatten_arg_shardings(mesh, in_shardings, args, kwargs
                          ) -> Optional[list]:
    """Resolve a user-facing ``in_shardings`` to one sharding per input
    leaf of ``(args, kwargs)``, in ``pytree.tree_leaves`` order.

    ``in_shardings`` follows jit's convention: a single ``NamedSharding`` /
    ``P`` / ``None`` broadcasts to every POSITIONAL leaf, or a pytree prefix
    of the positional-args tuple whose entries broadcast over their
    argument's subtree (``[None, batch_sharding(mesh)]`` shards the whole
    second argument however deep it is). Keyword-argument leaves always
    replicate. ``None`` and ``P`` entries resolve against ``mesh`` (``None``
    -> replicated). Returns ``None`` when there is nothing to shard."""
    if mesh is None and in_shardings is None:
        return None

    def resolve(s):
        if s is None:
            return NamedSharding(mesh, P()) if mesh is not None else None
        if isinstance(s, P):
            if mesh is None:
                raise ValueError("P in_shardings need a mesh= to resolve "
                                 "against")
            return NamedSharding(mesh, s)
        return s

    n_kw = len(pytree.tree_leaves(kwargs))
    if _is_sharding_leaf(in_shardings):
        n_args = len(pytree.tree_leaves(tuple(args)))
        return [resolve(in_shardings)] * n_args + [resolve(None)] * n_kw

    prefix = (tuple(in_shardings) if isinstance(in_shardings, list)
              else in_shardings)
    flat: list = []

    # the prefix's leaves each take the corresponding subtree of args
    # (flatten-up-to semantics): one entry per argument, broadcast over it
    def spread(s, arg_subtree):
        flat.extend([resolve(s)] * len(pytree.tree_leaves(arg_subtree)))
        return s

    try:
        pytree.tree_map(spread, prefix, tuple(args),
                        is_leaf=_is_sharding_leaf)
    except (ValueError, TypeError, RuntimeError) as e:
        raise ValueError(
            "in_shardings must be a single sharding/P/None or a pytree "
            f"prefix of the positional-args tuple: {e}") from e
    flat.extend([resolve(None)] * n_kw)
    return flat


# ---------------------------------------------------------------------------
# placement on a DeviceMesh
# ---------------------------------------------------------------------------

def place(x, sharding: Optional[NamedSharding]):
    """``x`` (the global value) laid out per ``sharding``: a DTensor with
    the spec's placements on the sharding's DeviceMesh. ``None``, a mesh of
    one device, or a fully replicated spec leaves ``x`` as it is."""
    if sharding is None or not isinstance(x, torch.Tensor):
        return x
    if _is_dtensor(x):
        return redistribute(x, sharding)
    if mesh_size(sharding.mesh) == 1 and not any(sharding.spec):
        return x
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sharding.mesh,
                             sharding.placements(x.ndim))


def place_tree(tree, shardings):
    """``place`` over a tree: ``shardings`` has the tree's structure or is
    a prefix of it (each sharding covers its subtree; ``None`` leaves a
    subtree as it is)."""
    return pytree.tree_map(
        lambda sh, sub: pytree.tree_map(lambda x: place(x, sh), sub),
        shardings, tree, is_leaf=_is_sharding_leaf)


def redistribute(x, sharding: NamedSharding):
    """A DTensor moved to ``sharding``'s placements (no-op when it holds
    them)."""
    placements = sharding.placements(x.ndim)
    if (x.device_mesh == sharding.mesh
            and list(x.placements) == placements):
        return x
    return x.redistribute(sharding.mesh, placements)


def gather(x):
    """The global value of ``x``: a DTensor's full tensor (a collective
    over its mesh), anything else as it is."""
    return x.full_tensor() if _is_dtensor(x) else x


def gather_tree(tree):
    return pytree.tree_map(gather, tree)


# ---------------------------------------------------------------------------
# collectives over one mesh axis
# ---------------------------------------------------------------------------

def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s axis ``axis`` (a DeviceMesh)."""
    if not is_device_mesh(mesh):
        raise ValueError(f"{mesh!r} is not a DeviceMesh: collectives need "
                         "one rank per device (launch.mesh)")
    if axis not in mesh_shape(mesh):
        raise ValueError(f"mesh has no axis {axis!r}: {mesh_shape(mesh)}")
    return mesh.get_group(axis)


def _staged(group, x: torch.Tensor):
    """``x`` on the device the group's backend reduces on (the CPU for
    gloo), contiguous."""
    import torch.distributed as dist
    if dist.get_backend(group) == "gloo" and x.device.type != "cpu":
        return x.detach().to("cpu").contiguous()
    return x.detach().clone().contiguous()


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The elementwise SUM or MAX of ``x`` over ``group``, on ``x``'s
    device; ``x`` itself is not changed."""
    import torch.distributed as dist
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    buf = _staged(group, torch.as_tensor(x))
    dist.all_reduce(buf, op=ops[op], group=group)
    return buf.to(torch.as_tensor(x).device)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` (each ``(k, ...)``) concatenated along the first
    axis in rank order, on ``x``'s device."""
    import torch.distributed as dist
    buf = _staged(group, x)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts).to(x.device)
