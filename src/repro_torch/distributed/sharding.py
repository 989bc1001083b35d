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

The port runs one program per rank. Parameters placed by ``place_params``
(FSDP x TP under ``DEFAULT_PARAM_RULES``, TP alone under
``SERVE_PARAM_RULES``) stay DTensor shards: the model runs on them, and
DTensor keeps the program's semantics global, as GSPMD's partitioned
program does (``truncate`` rounds each site's global value,
``core.interpreter``). The profilers that report per location
(``memtrace``, ``profile_trajectory``, ``profile_counts``) gather sharded
inputs and run the global program on every rank (``gather_tree``); the
candidate axis of a swept table batch is what a sweep divides between ranks
(``probe_axis_size``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
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


class _Collective(threading.local):
    depth = 0


_collective = _Collective()
# called when the outermost ``collective()`` region of a thread ends (the
# interpreter's walk: the region's autograd node is no site's)
after_collective: list = []


@contextlib.contextmanager
def collective():
    """A region of DTensor data movement (``redistribute``, ``place``,
    ``gather``): the ops it issues on local tensors are no op of the
    program, so a walk (``core.interpreter``) runs them without a site or a
    position."""
    _collective.depth += 1
    try:
        yield
    finally:
        _collective.depth -= 1
        if not _collective.depth:
            for hook in after_collective:
                hook()


def in_collective() -> bool:
    return _collective.depth > 0


def dtensors_possible() -> bool:
    """Whether a DTensor can exist in this process: a DeviceMesh, and so a
    DTensor, needs a process group."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


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


_DTENSOR = None


def _dtensor_type():
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return _DTENSOR


def _is_dtensor(x) -> bool:
    return isinstance(x, torch.Tensor) and isinstance(x, _dtensor_type())


def any_dtensor(tree) -> bool:
    """Whether a leaf of ``tree`` is a DTensor."""
    return any(_is_dtensor(x) for x in pytree.tree_leaves(tree))


def settled(x):
    """A DTensor with every ``Partial`` placement reduced (to
    ``Replicate``): the global value, summed (or maxed) where the ranks held
    partial terms; a DTensor without one, or anything else, as it is."""
    if not _is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    with collective():
        return x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])


def replicate_like(ref, t):
    """``t``, a tensor every rank computes whole (from shapes alone:
    positions, masks, a loop's starting carry), as a replicated DTensor on
    the mesh of the DTensor ``ref``, so the program may combine the two;
    ``t`` as it is when ``ref`` is no DTensor or ``t`` is one already."""
    if not _is_dtensor(ref) or not isinstance(t, torch.Tensor) \
            or _is_dtensor(t):
        return t
    return replicate_on(ref.device_mesh, t)


def replicate_on(mesh, t):
    """``t`` (every rank's whole value) as a replicated DTensor on
    ``mesh``; ``t`` as it is when ``mesh`` is ``None``."""
    if mesh is None:
        return t
    from torch.distributed.tensor import Replicate
    with collective():
        return _dtensor_type().from_local(t, mesh,
                                          [Replicate()] * mesh.ndim,
                                          run_check=False)


def global_value(x):
    """``(value, wrap)``: the whole of ``x`` as a plain tensor on every rank
    (a DTensor replicated first: a small integer plan, such as the MoE's
    dispatch, is computed whole on every rank), and the function that lays
    a plain tensor made from it out as a replicated DTensor on ``x``'s mesh
    again; ``(x, identity)`` for a plain tensor."""
    if not _is_dtensor(x):
        return x, lambda t: t
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    with collective():
        whole = x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        if whole.stride() != x.stride():
            # the unsharded value's layout, so the plan's ops (a reshape
            # copies a strided tensor, views a dense one) are its ops
            whole = torch.empty_strided(
                x.shape, x.stride(), dtype=whole.dtype,
                device=whole.device).copy_(whole)
    return whole, lambda t: replicate_like(x, t)


def is_partial(x) -> bool:
    """Whether ``x`` is a DTensor holding ``Partial`` terms."""
    return _is_dtensor(x) and any(p.is_partial() for p in x.placements)


def masked_zero_(x, mask):
    """``x.masked_fill_(mask, 0)`` of a ``Partial(sum)`` DTensor: each rank
    zeroes its term's elements, whose sum is the zeroed global value.
    DTensor refuses the in-place fill of partial terms (an autograd
    formula's: ``maximum``'s backward zeroes the cotangent of the smaller
    operand in place)."""
    from torch.distributed.tensor import Replicate
    if any(p.is_partial() and p.reduce_op != "sum" for p in x.placements):
        raise NotImplementedError(f"zeroing {x.placements} in place")
    want = [Replicate() if p.is_partial() else p for p in x.placements]
    with collective():
        if _is_dtensor(mask):
            mask = mask.redistribute(x.device_mesh, want)._local_tensor
        x._local_tensor.masked_fill_(mask, 0)
    return x


DATA_AXES = ("pod", "data")


def whole_over_data(tree):
    """FSDP's gather before use: each DTensor leaf of ``tree`` made whole
    over the data-parallel axes (``pod``, ``data``) that split it, its
    model-axis shards kept. Its cotangent, a partial sum on each data rank,
    is reduce-scattered back onto the shards. Without it DTensor multiplies
    a batch-split activation by a weight split over the contracted
    ``embed`` axis by moving the activation and summing the products'
    partial terms: activations (the logits among them) cross the mesh
    instead of weights."""
    def whole(t):
        if not _is_dtensor(t):
            return t
        from torch.distributed.tensor import Replicate
        names = t.device_mesh.mesh_dim_names or ()
        want = [Replicate() if p.is_shard() and n in DATA_AXES else p
                for p, n in zip(t.placements, names)]
        if want == list(t.placements):
            return t
        with collective():
            return t.redistribute(t.device_mesh, want)
    return pytree.tree_map(whole, tree)


def lookup(table, idx):
    """``table[idx]``, an index lookup (the token embedding), with ``idx``
    made a DTensor on ``table``'s mesh. Without a gradient, a table sharded
    over its rows (the vocabulary) is read by ``embedding``, each rank its
    own rows, the ranks' terms summed: DTensor's ``index`` would gather the
    whole table first (1.2 GB a decode tick for glm4-9b's). Where a
    gradient is wanted (torch 2.11's DTensor cannot differentiate a lookup
    into a sharded table: its ``index_put`` strategy builds an
    unnormalised ``Shard(-1)``), each rank looks its own indices up in the
    whole table, gathered first as FSDP gathers a parameter before its use
    (``_whole_lookup``). Each is one op of the primitive ``gather``, as
    ``index`` is."""
    idx = replicate_like(table, idx)
    if not _is_dtensor(table):
        return table[idx]
    grad = torch.is_grad_enabled() and table.requires_grad
    if not grad and any(p.is_shard(0) for p in table.placements):
        # DTensor gathers a table sharded over its rows for ``index``; its
        # ``embedding`` (the same primitive, one op) looks each rank's
        # rows up and sums the ranks' terms. It masks those terms wrongly
        # for indices split over another axis (a batch over ``data``), so
        # the (small) indices are made whole first and the result is cut
        # as they were
        from torch.distributed.tensor import Replicate
        mesh, split = table.device_mesh, list(idx.placements)
        if any(p.is_shard() for p in split):
            with collective():
                idx = idx.redistribute(mesh, [Replicate()] * mesh.ndim)
        out = settled(torch.nn.functional.embedding(idx, table))
        if any(p.is_shard() for p in split):
            with collective():
                out = out.redistribute(mesh, split)
        return out
    if grad:
        return _whole_lookup(table, idx)
    return table[idx]


def _whole_lookup(table, idx):
    """``table[idx]`` on the whole table, gathered, for this rank's piece of
    the indices: the result laid out as the indices are (a batch split over
    the data axis stays split), a lookup whose backward torch 2.11's
    DTensor cannot run on shards. The table's cotangent, a partial sum on
    each rank that looked up a piece of the indices, is reduced onto its
    shards."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = table.device_mesh
    whole = [Replicate()] * mesh.ndim
    split = [p.is_shard() for p in idx.placements]
    with collective():
        t = table.redistribute(mesh, whole).to_local(grad_placements=[
            Partial() if s else Replicate() for s in split])
        i = idx.to_local()
    out = t[i]
    with collective():
        # its backward brings the cotangent to these placements first
        return _dtensor_type().from_local(out, mesh, list(idx.placements),
                                          run_check=False)


class _Relayout(torch.autograd.Function):
    """A redistributed shard in the layout of the global tensor it was cut
    from: a slice of a buffer with the global tensor's shape and strides
    (a redistribution leaves it dense, and the ops an einsum issues depend
    on which dimensions can be viewed together). Its cotangent passes
    through as it is."""

    @staticmethod
    def forward(ctx, local, mesh, placements, shape, stride):
        buf = torch.empty_strided(tuple(shape), tuple(stride),
                                  dtype=local.dtype, device=local.device)
        idx = [slice(None)] * local.ndim
        for md, p in enumerate(placements):
            if p.is_shard():
                n = local.shape[p.dim]
                c = mesh.get_local_rank(md)
                idx[p.dim] = slice(c * n, (c + 1) * n)
        piece = buf[tuple(idx)]
        piece.copy_(local)
        return piece

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None, None


_META_OPS: dict = {}


def _meta_ops(name: str, fn, *xs, shapes=None) -> tuple:
    """The aten ops ``fn(*xs)`` issues, from a run on meta tensors of
    ``xs``' shapes (or ``shapes``), strides and dtypes (a DTensor's are its
    global value's), cached under ``name``: they depend on which dimensions
    can be viewed together. The run is no part of the program: it enters
    frames of its own (``core.interpreter.aside``) and a walk gives its ops
    no site."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.core.interpreter import aside
    shapes = shapes or [tuple(x.shape) for x in xs]
    key = (name,) + tuple((s, tuple(x.stride()), x.dtype)
                          for s, x in zip(shapes, xs))
    ops = _META_OPS.get(key)
    if ops is None:
        seen = []

        class _Record(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                seen.append(func)
                return func(*args, **(kwargs or {}))
        with collective(), aside():
            metas = [torch.empty_strided(s, tuple(x.stride()),
                                         dtype=x.dtype, device="meta")
                     for s, x in zip(shapes, xs)]
            with _Record():
                fn(*metas)
        ops = _META_OPS[key] = tuple(seen)
    return ops


def _einsum_ops(spec: str, *xs) -> tuple:
    """The aten ops ``torch.einsum(spec, *xs)`` issues."""
    return _meta_ops(spec, functools.partial(torch.einsum, spec), *xs)


def local_einsum(spec: str, a, b):
    """``torch.einsum(spec, a, b)`` of DTensor operands run on each rank's
    shards. A mesh axis may split a batch label (one both operands and the
    result carry: the batch, the heads); each rank's einsum is then its
    piece of the result, and each operand's cotangent its piece of that.
    An operand split that way already moves nothing, a replicated one is
    cut locally, one split over another batch label that splits into
    pieces of one is moved onto a label that does not (an all-to-all),
    partial terms are reduced onto the split (a reduce-scatter, or an
    all-reduce where no label splits evenly into pieces of more than one).
    ``None`` where a mesh axis splits a contracted label, or where the
    shards' einsum would issue other ops than the global one (a dimension
    of one, or another layout, lets a reshape view what it copies):
    ``einsum_layout`` lays those out."""
    from torch.distributed.tensor import Replicate, Shard
    a = replicate_like(b, a)
    b = replicate_like(a, b)
    if a.device_mesh != b.device_mesh:
        return None
    mesh = a.device_mesh
    ins, out = spec.split("->")
    ops = ((a, ins.split(",")[0]), (b, ins.split(",")[1]))

    def splits(c, n):
        """Whether ``c`` is a batch label both operands split evenly into
        ``n`` pieces of more than one."""
        if c not in out or any(c not in lx for _, lx in ops):
            return False
        sizes = {x.shape[lx.index(c)] for x, lx in ops}
        size = sizes.pop()
        return not sizes and size % n == 0 and size > n

    labels = []                 # the label each mesh axis splits, or None
    for md in range(mesh.ndim):
        n = mesh.size(md)
        split = [lx[x.placements[md].dim] for x, lx in ops
                 if x.placements[md].is_shard()]
        if any(c not in out for c in split):
            return None         # a contracted label
        if split and splits(split[0], n):
            labels.append(split[0])
        elif split or any(x.placements[md].is_partial() for x, _ in ops):
            # another batch label, the operands moved onto it (a batch of
            # one a rank reshapes otherwise)
            labels.append(next((c for c in out if splits(c, n)), None))
            if split and labels[-1] is None:
                return None
        else:
            labels.append(None)
    if len({c for c in labels if c}) < len([c for c in labels if c]):
        return None

    def piece(x, lx):
        """(this rank's piece of ``x``, the redistribution that made it
        (its placements, and the global shape and strides) or ``None``)"""
        want = [Shard(lx.index(c)) if c else Replicate() for c in labels]
        with collective():
            if list(x.placements) == want:
                return x.to_local(), None
            moved = (want, x.shape, x.stride())
            return x.redistribute(mesh, want).to_local(), moved
    got = [piece(x, lx) for x, lx in ops]
    pieces = [p for p, _ in got]
    want = _einsum_ops(spec, a, b)
    if _einsum_ops(spec, *pieces) != want:
        # a redistributed piece is dense; in the global layout instead
        with collective():
            pieces = [p if m is None else _Relayout.apply(p, mesh, *m)
                      for p, m in got]
        if _einsum_ops(spec, *pieces) != want:
            return None
    o = torch.einsum(spec, *pieces)
    with collective():
        return _dtensor_type().from_local(
            o, mesh, [Shard(out.index(c)) if c else Replicate()
                      for c in labels], run_check=False)


# ``on_shards`` calls by (name, "shards" | "global"): whether each ran on
# the ranks' pieces or, its ops differing there, on the DTensors
ON_SHARDS: collections.Counter = collections.Counter()


def on_shards(name: str, fn, operands, labels: str, out: str,
              repeats=None):
    """``fn(*operands)`` of DTensor operands run on each rank's shards, for
    a function that computes each index of its outputs' labels from the
    same index of its operands' (a recurrence over time, per head or per
    channel: RWKV-6's and Mamba's scans). ``labels`` names each operand's
    dimensions, one letter each and comma-separated (``"bshd,hd"``),
    ``out`` each output's; ``fn`` returns a tuple.

    A mesh axis splits the label the first operand sharded over it is split
    on, if every output carries that label and the axis divides it; the
    operands are then cut into this rank's pieces of it (a replicated one
    locally, ``Partial`` terms reduced first), and the outputs are those
    pieces' results, laid out on it. The program's ops are the same, run on
    plain tensors: under DTensor's dispatch a Python loop of thousands of
    small steps costs seconds. Where the pieces' run would issue other ops
    than the global one (a run on meta tensors of both, cached under
    ``name``; a dimension of one lets a reshape view what it copies), or
    no operand is a DTensor, ``fn`` runs on the operands as they are.
    ``repeats=(label, n)`` names the label along which ``fn`` repeats one
    body every ``n`` entries (a scan's chunks): the meta runs take two such
    bodies of it, not thousands of steps."""
    ref = next((x for x in operands if _is_dtensor(x)), None)
    if ref is None:
        return fn(*operands)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = ref.device_mesh
    operands = [settled(replicate_like(ref, x)) for x in operands]
    ins, outs = labels.split(","), out.split(",")
    size = {c: n for x, lx in zip(operands, ins) for c, n in zip(lx, x.shape)}
    chosen = []                 # the label each mesh axis splits, or None
    for md in range(mesh.ndim):
        n = mesh.size(md)
        split = [lx[x.placements[md].dim] for x, lx in zip(operands, ins)
                 if x.placements[md].is_shard()]
        c = split[0] if split else None
        if c is not None and (c in chosen or size[c] % n
                              or any(c not in lo for lo in outs)):
            c = None
        chosen.append(c)

    def piece(x, lx):
        want = [Shard(lx.index(c)) if c and c in lx else Replicate()
                for c in chosen]
        with collective():
            if list(x.placements) != want:
                x = x.redistribute(mesh, want)
            # an operand without a split label is read whole by every
            # rank, for its own pieces: its cotangent is a partial sum
            return x.to_local(grad_placements=[
                Partial() if c and c not in lx else p
                for c, p in zip(chosen, want)])
    pieces = [piece(x, lx) for x, lx in zip(operands, ins)]

    def cut(xs):
        if repeats is None:
            return None
        c, n = repeats
        return [tuple(min(k, 2 * n) if d == c else k
                      for d, k in zip(lx, x.shape))
                for x, lx in zip(xs, ins)]
    if (_meta_ops(name, fn, *pieces, shapes=cut(pieces))
            != _meta_ops(name, fn, *operands, shapes=cut(operands))):
        ON_SHARDS[name, "global"] += 1
        return fn(*operands)
    ON_SHARDS[name, "shards"] += 1
    res = fn(*pieces)
    with collective():
        return tuple(_dtensor_type().from_local(
            o, mesh, [Shard(lo.index(c)) if c else Replicate()
                      for c in chosen], run_check=False)
            for o, lo in zip(res, outs))


# which split of a contraction's operands a mesh axis keeps, first to last
_DOT_ROLES = ("c", "b", "fl", "fr")


def dot_on_shards(dot, lhs, rhs, dimension_numbers, out_dtype):
    """A two-operand contraction of DTensor operands run on each rank's
    pieces: ``dot(l, r, dtype)`` computes this rank's product of its pieces
    in ``dtype`` (lax's ``dimension_numbers``; the result's axes are the
    batch axes, then the lhs's free axes, then the rhs's).

    Each mesh axis splits what the operands split there: a contracted
    dimension (a row-parallel product: the ranks' products are f32 partial
    sums, reduced before the one rounding to ``out_dtype``), else a batch
    dimension, else a free one of the lhs (the batch rows), else one of the
    rhs (a column-parallel product: this rank's products are its shard of
    the result, rounded where they are made). The other operand is laid out
    to match: a replicated one cut locally, ``Partial`` terms reduced
    first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    lhs = settled(replicate_like(rhs, lhs))
    rhs = settled(replicate_like(lhs, rhs))
    mesh = lhs.device_mesh
    (lc, rc), (lb, rb) = dimension_numbers
    lf = [d for d in range(lhs.ndim) if d not in lc and d not in lb]
    rf = [d for d in range(rhs.ndim) if d not in rc and d not in rb]

    def role(p, contract, batch, free, side):
        if not p.is_shard():
            return None
        if p.dim in contract:
            return ("c", contract.index(p.dim))
        if p.dim in batch:
            return ("b", batch.index(p.dim))
        return ("f" + side, free.index(p.dim))
    want_l, want_r, out = [], [], []
    for pl, pr in zip(lhs.placements, rhs.placements):
        roles = [r for r in (role(pl, lc, lb, lf, "l"),
                             role(pr, rc, rb, rf, "r")) if r is not None]
        kind, i = min(roles, key=lambda r: _DOT_ROLES.index(r[0]),
                      default=(None, 0))
        want_l.append(Shard(lc[i]) if kind == "c" else Shard(lb[i])
                      if kind == "b" else Shard(lf[i]) if kind == "fl"
                      else Replicate())
        want_r.append(Shard(rc[i]) if kind == "c" else Shard(rb[i])
                      if kind == "b" else Shard(rf[i]) if kind == "fr"
                      else Replicate())
        out.append(Partial() if kind == "c" else Shard(i) if kind == "b"
                   else Shard(len(lb) + i) if kind == "fl"
                   else Shard(len(lb) + len(lf) + i) if kind == "fr"
                   else Replicate())
    with collective():
        a = (lhs if list(lhs.placements) == want_l
             else lhs.redistribute(mesh, want_l)).to_local()
        b = (rhs if list(rhs.placements) == want_r
             else rhs.redistribute(mesh, want_r)).to_local()
    partial = any(p.is_partial() for p in out)
    o = dot(a, b, torch.float32 if partial else out_dtype)
    with collective():
        o = _dtensor_type().from_local(o, mesh, out, run_check=False)
    if not partial:
        return o
    return map_local(lambda t: t.to(out_dtype), settled(o))


def einsum_layout(spec: str, a, b):
    """``(a, b, lay_out)`` for ``torch.einsum(spec, a, b)`` of DTensor
    operands that ``local_einsum`` does not take. DTensor (torch 2.11's)
    cannot run an einsum on operands sharded over its batch labels (a
    batched einsum over sharded heads flattens batch and heads, and
    DTensor refuses to flatten dimensions whose inner one is sharded), so
    such operands are gathered first (explicitly, as a
    ``constrain`` would) and ``lay_out`` lays the result out over the model
    axis again as DTensor's own einsum would have; other operands are as
    they are. The einsum's ops are DTensor's either way: the unsharded
    run's, op for op."""
    def keep(out):
        return out
    ins, out = spec.split("->")
    shards = {}
    for x, labels in zip((a, b), ins.split(",")):
        if _is_dtensor(x):
            for md, p in enumerate(x.placements):
                if p.is_shard() and labels[p.dim] in out:
                    shards[md] = out.index(labels[p.dim])
    if not shards:
        return a, b, keep
    from torch.distributed.tensor import Replicate, Shard

    def whole(x):
        if not _is_dtensor(x):
            return x
        with collective():
            return x.redistribute(x.device_mesh,
                                  [Replicate()] * x.device_mesh.ndim)

    def lay_out(y):
        placements = [Shard(shards[md]) if md in shards else Replicate()
                      for md in range(y.device_mesh.ndim)]
        with collective():
            return y.redistribute(y.device_mesh, placements)
    return whole(a), whole(b), lay_out


def _whole_groups(x, dim: int, groups: int):
    from torch.distributed.tensor import Replicate
    dim %= x.ndim
    want = [Replicate() if p.is_shard(dim) and groups % n else p
            for p, n in zip(x.placements, x.device_mesh.shape)]
    if want == list(x.placements):
        return x
    with collective():
        return x.redistribute(x.device_mesh, want)


class _WholeGroupsGrad(torch.autograd.Function):
    """The identity, whose cotangent is laid out as ``_whole_groups``
    lays out its input."""

    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.args = dim, groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole_groups(g, *ctx.args), None, None


def whole_groups(x, dim: int, groups: int):
    """``x`` laid out so that dimension ``dim`` splits into ``groups``
    groups on each rank (the heads of a flattened ``heads * head_dim``),
    and so is its cotangent: a mesh axis that shards ``dim`` into a number
    of pieces that does not divide ``groups`` is replicated, as DTensor
    refuses to unflatten an uneven split (hymba's 25 heads on a model axis
    of two). The weight stays split; its product is gathered, as GSPMD's
    reshape gathers it. Anything else as it is."""
    if not _is_dtensor(x):
        return x
    x = _whole_groups(x, dim, groups)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    with collective():
        return _WholeGroupsGrad.apply(x, dim, groups)


def local_parts(x):
    """``(local shard, placements)`` of a DTensor, ``(x, None)`` for
    anything else. A ``Partial`` DTensor raises: its local tensor is a term
    of the value, not a piece of it (``settled`` first)."""
    if not _is_dtensor(x):
        return x, None
    if any(p.is_partial() for p in x.placements):
        raise ValueError(f"a Partial DTensor ({x.placements}) has no local "
                         "piece of its value: settle it first")
    return x._local_tensor, tuple(x.placements)


def map_local(fn, x):
    """``fn`` applied elementwise to the global value of ``x``: on a
    DTensor, ``fn`` of its local shard (``Partial`` terms reduced first),
    rewrapped with the same placements, which are the bits of ``fn`` of the
    whole tensor; ``fn(x)`` for anything else."""
    if not _is_dtensor(x):
        return fn(x)
    x = settled(x)
    local, placements = local_parts(x)
    out = fn(local)
    return x if out is local else like(x, out)


def pointwise(fn, x):
    """``fn``, an elementwise function, of ``x``: on a DTensor, ``fn`` of
    its local shard (``Partial`` terms reduced first), laid out as ``x``
    and differentiable through both, where DTensor (torch 2.11's, the
    card's) has no sharding strategy for one of ``fn``'s ops (``ne``);
    ``fn(x)`` for anything else. The program's ops are ``fn``'s either
    way."""
    if not _is_dtensor(x):
        return fn(x)
    x = settled(x)
    with collective():
        local = x.to_local()
    out = fn(local)
    with collective():
        return _dtensor_type().from_local(
            out, x.device_mesh, x.placements, run_check=False,
            shape=x.shape, stride=x.stride())


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


def place_batch(batch: dict, mesh, axis: str = "data") -> dict:
    """A model's batch (every rank's copy of the global one) laid out over
    ``axis``, each leaf over its batch dimension: the first, but for
    M-RoPE's ``positions`` (3, B, S), whose second it is."""
    def spec(k):
        if axis not in mesh_shape(mesh):
            return P()
        return P(None, axis) if k == "positions" else P(axis)
    return {k: place(v, NamedSharding(mesh, spec(k)))
            for k, v in batch.items()}


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
    """``x`` (the global value, which every rank holds) laid out per
    ``sharding``: a DTensor with the spec's placements on the sharding's
    DeviceMesh, each rank keeping its piece. ``None``, a mesh of
    one device, or a fully replicated spec leaves ``x`` as it is."""
    if sharding is None or not isinstance(x, torch.Tensor):
        return x
    if _is_dtensor(x):
        return redistribute(x, sharding)
    if mesh_size(sharding.mesh) == 1 and not any(sharding.spec):
        return x
    from torch.distributed.tensor import Replicate, distribute_tensor
    # a dimension of one over an axis of one rank is whole: DTensor refuses
    # to reshape away a dimension it holds sharded (a batch of one)
    sizes = list(mesh_shape(sharding.mesh).values())
    placements = [Replicate() if p.is_shard() and x.shape[p.dim] == 1
                  and n == 1 else p
                  for p, n in zip(sharding.placements(x.ndim), sizes)]
    # every rank holds the global value: each keeps its own piece, with no
    # scatter from a source rank
    with collective():
        return distribute_tensor(x, sharding.mesh, placements,
                                 src_data_rank=None)


def param_shardings(defs, mesh, rules: Optional[dict] = None):
    """The ``NamedSharding`` of every ``ParamDef`` of ``defs`` on ``mesh``
    under ``rules`` (the context's parameter rules by default): the
    reference's ``param_sharding(pd.shape, pd.axes, mesh)``."""
    from repro_torch.models.common import map_defs
    rules = _ctx().param_rules if rules is None else rules
    return map_defs(lambda pd: NamedSharding(
        mesh, _resolve(mesh, rules, pd.axes, pd.shape)), defs)


def place_params(params, defs, mesh, rules: Optional[dict] = None):
    """``params`` (every rank's copy of the global values) laid out on
    ``mesh`` as ``defs`` and ``rules`` say: each leaf a DTensor holding
    this rank's shard. The mesh's device type must be the parameters'."""
    kinds = {x.device.type for x in pytree.tree_leaves(params)
             if isinstance(x, torch.Tensor)}
    kind = getattr(mesh, "device_type", None)
    if kinds and kinds != {kind}:
        raise ValueError(f"parameters on {sorted(kinds)} and a mesh of "
                         f"{kind!r}: place them on a mesh of their device")
    return place_tree(params, param_shardings(defs, mesh, rules))


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
    with collective():
        return x.redistribute(sharding.mesh, placements)


def redistribute_as(x, ref):
    """The DTensor ``x`` laid out as the DTensor ``ref`` (its mesh and
    placements; ``Partial`` terms reduced as they go)."""
    if x.device_mesh == ref.device_mesh and x.placements == ref.placements:
        return x
    with collective():
        return x.redistribute(ref.device_mesh, ref.placements)


def layout_like(tree, ref):
    """Every DTensor leaf of ``tree`` laid out as the DTensor leaf of
    ``ref`` in its place (``Partial`` terms reduced as they go): a decode
    step's new cache in its input's layout, tick after tick."""
    return pytree.tree_map(
        lambda x, r: redistribute_as(x, r)
        if _is_dtensor(x) and _is_dtensor(r) else x, tree, ref)


def place_as(x, ref):
    """``x`` (the global value, on every rank) laid out as the DTensor
    ``ref``: its mesh and placements, each rank keeping its piece."""
    from torch.distributed.tensor import distribute_tensor
    with collective():
        return distribute_tensor(x, ref.device_mesh, ref.placements,
                                 src_data_rank=None)


def like(ref, local):
    """The DTensor of ``ref``'s global shape, mesh and placements whose
    local shard on this rank is ``local``."""
    with collective():
        return _dtensor_type().from_local(
            local, ref.device_mesh, ref.placements, run_check=False,
            shape=ref.shape, stride=ref.stride())


def gather(x):
    """The global value of ``x``: a DTensor's full tensor (a collective
    over its mesh), anything else as it is."""
    if not _is_dtensor(x):
        return x
    with collective():
        return x.full_tensor()


def gather_tree(tree):
    return pytree.tree_map(gather, tree)


_GLOO_CUDA = None


def _gloo_group(group_name: str):
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = _resolve_process_group(group_name)
    if dist.get_backend(group) != "gloo":
        raise RuntimeError("the gloo collective route got a group of "
                           f"backend {dist.get_backend(group)!r}")
    return group


def gloo_all_gather(x, group_size: int, group_name: str):
    """``_c10d_functional.all_gather_into_tensor`` on a gloo group: the
    ranks' ``x`` stacked along the first axis, by
    ``all_gather_into_tensor`` (gloo's ``_allgather_base``)."""
    import torch.distributed as dist
    group = _gloo_group(group_name)
    out = x.new_empty((x.shape[0] * group_size,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def gloo_all_to_all(x, output_split_sizes, input_split_sizes,
                    group_name: str):
    """``_c10d_functional.all_to_all_single`` on a gloo group, as DTensor
    does it for a CPU mesh: every rank's ``x`` gathered, this rank's rows
    of each taken. The splits must be even (DTensor's shard-to-shard
    moves of evenly divided dimensions); others raise."""
    import torch.distributed as dist
    group = _gloo_group(group_name)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    rows = x.shape[0] // n
    if (x.shape[0] % n or any(s != rows for s in input_split_sizes)
            or any(s != rows for s in output_split_sizes)):
        raise NotImplementedError(
            f"all-to-all of uneven splits {list(input_split_sizes)} -> "
            f"{list(output_split_sizes)} on gloo")
    every = gloo_all_gather(x, n, group_name)
    return torch.cat([every[r * x.shape[0] + me * rows:
                            r * x.shape[0] + (me + 1) * rows]
                      for r in range(n)])


def route_gloo_cuda_collectives():
    """Route DTensor's all-gather and all-to-all of CUDA tensors on a gloo
    group through collectives gloo runs on CUDA tensors.

    DTensor gathers a shard with the functional collective
    ``_c10d_functional.all_gather_into_tensor``, which reaches gloo's
    coalesced all-gather: that one reads CUDA memory from the host and
    crashes the process. gloo's ``_allgather_base``, which
    ``all_gather_into_tensor`` calls, stages CUDA tensors itself, as do its
    all-reduce and reduce-scatter, which DTensor's functional forms already
    reach. A shard-to-shard move (``all_to_all_single``) goes through the
    same all-gather, as DTensor moves a CPU mesh's. Registered once per
    process, for the CUDA dispatch key, by ``launch.mesh`` when it builds a
    CUDA mesh over a gloo group (two ranks on one card: NCCL refuses that).
    A group of another backend raises."""
    global _GLOO_CUDA
    if _GLOO_CUDA is not None:
        return
    import warnings
    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "overriding a kernel"
        lib.impl("all_gather_into_tensor", gloo_all_gather, "CUDA")
        lib.impl("all_to_all_single", gloo_all_to_all, "CUDA")
    _GLOO_CUDA = lib


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
