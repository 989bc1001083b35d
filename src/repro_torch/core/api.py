"""Public RAPTOR API of the PyTorch port (op-mode).

    from repro_torch.core import api as raptor

    policy = raptor.TruncationPolicy.scoped("layer/mlp", "e5m7")
    lossy_loss = raptor.truncate(model.loss, policy)          # op-mode
    handle = raptor.truncate_sweep(model.loss, site_policy)(params, batch)
    loss = handle(handle.table(policy))                       # table-driven

Both wrappers cache per input signature (input pytree structure, shape /
dtype / device of every leaf, policy identity, impl): the policy is matched
against the program once per distinct signature (``wrapper.n_traces`` counts
those walks), and every further call re-uses the decisions.

``truncate_sweep`` keys its cache on quantize *sites* rather than policy
identity, and the formats become a runtime ``(num_sites, 4)`` int32 table on
the device. One enumeration per input signature serves every candidate
policy — a new policy is a new table value, never a new enumeration and
never a kernel build.

Mem-mode and the counters:

    out, report = raptor.memtrace(model.loss, policy)(params, batch)
    print(report.summary())                 # per-location flag heatmap
    counts = raptor.profile_counts(model.loss, policy)(params, batch)

``memtrace`` runs the program on a truncated and a full-precision lane and
returns the truncated outputs with a :class:`RaptorReport`;
``profile_counts`` runs it once, untruncated, and returns a
:class:`CountReport`. Both cache per input signature like ``truncate``.

Trajectories:

    out, traj = raptor.profile_trajectory(app.run_observables, policy,
                                          n_steps=app.n_steps + 1)(state)
    print(traj.summary(1e-3))               # per-scope onset/blame table

``profile_trajectory`` is ``memtrace`` with per-step ring buffers: one row
per trip of the program's outermost loops (``repro_torch.profile``).

Meshes (``launch.mesh``: a ``DeviceMesh``, one rank per device):

    mesh = make_probe_mesh()                         # every rank
    handle = raptor.truncate_sweep(model.loss, site_policy,
                                   mesh=mesh)(params, batch)
    losses = handle.batch(handle.tables(ladder))     # K / n rows a rank

``truncate_sweep(mesh=, batch_axis=)`` divides the K candidate rows of
``handle.batch`` between the ranks of the mesh's ``batch_axis`` and gathers
them back in order: bit for bit the unsharded handle's rows. For every
transform, ``in_shardings`` (jit's convention, ``distributed.sharding``)
says how the inputs are laid out: DTensor inputs are gathered and every
rank runs the global program, so outputs and reports are the single-device
ones bit for bit (GSPMD's global semantics; the port does not partition a
program's compute). Per-shard runs of a per-example program reduce with
``RaptorReport.allreduce`` / ``TrajectoryReport.allreduce``. The caches
key on the mesh and the shardings.
"""
from __future__ import annotations

import functools
import warnings
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import counters, interpreter, memmode
from repro_torch.distributed import sharding as _shd
from repro_torch.core.formats import FPFormat, parse_format  # re-export
from repro_torch.core.interpreter import scope, loop_body  # re-export
from repro_torch.core.policy import (  # re-export
    TruncationPolicy, TruncationRule, magnitude_below, magnitude_above,
)


def _leaf_key(x):
    """Cache-key component for one input leaf: shape + dtype + device type
    for tensors; python scalars key on their type (they promote differently
    from tensors of the same dtype)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), x.device.type)
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return (tuple(x.shape), str(x.dtype), "host")
    return ((), type(x).__name__, "host")


def _signature_key(in_tree, leaves, suffix: tuple) -> tuple:
    """The shared trace-cache key scheme: input pytree structure + per-leaf
    signature + transform identity, used by both ``truncate`` and
    ``truncate_sweep`` so leaf semantics can never diverge between them."""
    return (str(in_tree), tuple(_leaf_key(l) for l in leaves)) + suffix


def _mesh_key(mesh, in_shardings, *extra) -> tuple:
    """Hashable cache-key component for a (mesh, shardings) pair: the
    shardings' tree structure and leaves. Anything but a mesh raises."""
    if mesh is None and in_shardings is None and not any(extra):
        return (None,)
    if mesh is not None:
        _shd.mesh_shape(mesh)           # a TypeError for anything else
    leaves, tree = pytree.tree_flatten(in_shardings,
                                       is_leaf=_shd._is_sharding_leaf)
    return (mesh, str(tree), tuple(leaves)) + extra


def _checked_inputs(mesh, in_shardings, args, kwargs):
    """``(args, kwargs)`` as laid out, ``in_shardings`` checked against
    them (jit's prefix convention): DTensor leaves stay shards, and the
    program runs on them (``truncate``, ``truncate_sweep``)."""
    if mesh is not None or in_shardings is not None:
        _shd.flatten_arg_shardings(mesh, in_shardings, args, kwargs)
    return args, kwargs


def _global_inputs(mesh, in_shardings, args, kwargs):
    """``(args, kwargs)`` as the global program reads them: ``in_shardings``
    checked against the inputs, DTensor leaves gathered to their full
    tensors (the profilers, whose reports are per location of the global
    program)."""
    args, kwargs = _checked_inputs(mesh, in_shardings, args, kwargs)
    if not _shd.any_dtensor((tuple(args), kwargs)):
        return args, kwargs
    return _shd.gather_tree((tuple(args), kwargs))


def _per_signature(wrapped, cache: bool, suffix: tuple, args, kwargs, make):
    """What a transform keeps for one input signature: ``make()`` on the
    first call of the signature (counted in ``wrapped.n_traces``), the
    cached value after."""
    key = None
    if cache:
        leaves, in_tree = pytree.tree_flatten((args, kwargs))
        key = _signature_key(in_tree, leaves, suffix)
        hit = wrapped._cache.get(key)
        if hit is not None:
            return hit
    wrapped.n_traces += 1
    value = make()
    if cache:
        wrapped._cache[key] = value
    return value


def _attach_cache(wrapped):
    wrapped._cache = {}
    wrapped.n_traces = 0          # times the policy was matched to a program
    wrapped.cache_clear = wrapped._cache.clear
    wrapped.cache_size = lambda: len(wrapped._cache)
    return wrapped


def truncate(fn: Callable, policy: TruncationPolicy, *, impl: str = "auto",
             cache: bool = True, mesh=None, in_shardings=None,
             native_fp8: bool = False) -> Callable:
    """Return ``fn`` with op-mode truncation applied under ``policy``.

    The wrapper is an ordinary function of tensors. Called on tensors that
    lie on the card, every matched result is rounded by the static CUDA
    quantizer; on CPU tensors by its plain version. Per input signature the
    policy is matched once (``wrapper.n_traces``); later calls re-use the
    per-site decisions.

    **Gradients.** A backward pass run *inside* ``fn`` (``fn`` calls
    ``torch.autograd.grad``, as ``train.value_and_grad`` does) is walked
    too: each backward op is rounded under the scope of the forward op it
    differentiates (the reference's ``truncate(jax.value_and_grad(loss))``),
    and a ``remat`` region's recompute under the region's scopes. A
    ``.backward()`` called on the wrapper's output *outside* it is not
    walked: the rounding is invisible to autograd (straight-through).

    ``native_fp8``: execute ``quantize_dot_inputs`` dot sites whose rule
    format maps onto float8_e4m3fn (e4m3 without IEEE infinities, no mask,
    a plain two-operand ``mm`` / ``bmm`` with a floating output) on fp8
    storage with f32 accumulation (``kernels.fp8_dot``: the port's fp8 dot
    kernel for CUDA tensors, its plain version for CPU tensors); every
    other site keeps the emulated input quantize.

    ``mesh`` / ``in_shardings``: the inputs' layout on a DeviceMesh (the
    module docstring); every rank runs the global program."""
    suffix = (policy.cache_key(), impl, native_fp8,
              _mesh_key(mesh, in_shardings))

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        args, kwargs = _checked_inputs(mesh, in_shardings, args, kwargs)
        plan = _per_signature(wrapped, cache, suffix, args, kwargs, dict)
        return interpreter.run_quantized(fn, args, kwargs, policy, impl, plan,
                                         native_fp8=native_fp8)

    return _attach_cache(wrapped)


def _first_device(leaves, device):
    if device is not None:
        return torch.device(device)
    for l in leaves:
        if isinstance(l, torch.Tensor):
            return l.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "truncate_sweep: no tensor input to take the device from and no "
            "CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


class SweepHandle:
    """One input signature's site layout bound to its inputs. Every
    candidate policy runs through the same program and the same kernel —
    only the ``(num_sites, 4)`` int32 format table changes.

    * ``handle(table)`` — evaluate one candidate table (a numpy array, or an
      int32 tensor already on the device, which costs no copy).
    * ``handle.batch(tables)`` — evaluate a ``(K, num_sites, 4)`` stack of
      candidates one after the other (outputs gain a leading K axis).
    * ``handle.table(policy)`` — lower a :class:`TruncationPolicy` to its
      table (unmatched sites get the identity row).

    Under a sharded sweep (``truncate_sweep(..., mesh=...)``) ``batch``
    divides the K rows between the ranks of the mesh's probe axis; a K the
    axis does not divide is padded with identity rows, and the rows are
    gathered back in order and the padding sliced off, so the result is
    the unsharded handle's bit for bit.
    """

    def __init__(self, fn, index, args, kwargs, impl, device, mesh=None,
                 batch_axis: str = "probe"):
        self._fn, self._index = fn, index
        self._args, self._kwargs = args, kwargs
        self._impl, self._device = impl, device
        self._mesh, self._batch_axis = mesh, batch_axis
        self._shard_multiple = _shd.probe_axis_size(mesh, batch_axis)

    @property
    def sites(self):
        return self._index.sites

    @property
    def index(self):
        """The :class:`~repro_torch.core.interpreter.SiteIndex` of this
        input signature (``table_for``, ``identity_table``)."""
        return self._index

    @property
    def num_sites(self) -> int:
        return len(self._index)

    @property
    def device(self) -> torch.device:
        """The device the program runs on and its tables live on."""
        return self._device

    @property
    def site_executions(self) -> int:
        """Quantizer calls one evaluation makes (a site in a body that runs
        N times counts N)."""
        return self._index.executions

    def table(self, policy: TruncationPolicy) -> np.ndarray:
        return self._index.table_for(policy)

    def tables(self, policies) -> np.ndarray:
        """Stack several candidate policies into a (K, num_sites, 4) batch."""
        return np.stack([self._index.table_for(p) for p in policies])

    def identity_table(self) -> np.ndarray:
        return self._index.identity_table()

    def device_table(self, table) -> torch.Tensor:
        """``table`` as the int32 tensor on the program's device that the
        evaluation reads (no copy when it already is one)."""
        return torch.as_tensor(table, device=self._device).to(torch.int32)

    def __call__(self, table):
        return interpreter.run_sites(
            self._fn, self._args, self._kwargs, self.device_table(table),
            self._index, self._impl)

    def batch(self, tables):
        tables = self.device_table(tables)
        n = self._shard_multiple
        if n == 1:
            return self._rows(tables)
        k = tables.shape[0]
        pad = -k % n
        if pad:
            identity = self.device_table(self.identity_table())
            tables = torch.cat([tables, identity.expand(pad, -1, -1)])
        per = tables.shape[0] // n
        r = self._mesh.get_local_rank(self._batch_axis)
        group = _shd.axis_group(self._mesh, self._batch_axis)
        rows = pytree.tree_map(lambda t: _shd.all_gather_rows(t, group),
                               self._rows(tables[r * per:(r + 1) * per]))
        return _shd.drop_padded_rows(rows, k)

    def _rows(self, tables):
        outs = [self(tables[k]) for k in range(tables.shape[0])]
        return pytree.tree_map(lambda *xs: torch.stack(
            [torch.as_tensor(x) for x in xs]), *outs)


def truncate_sweep(fn: Callable, site_policy: TruncationPolicy, *,
                   impl: str = "auto", cache: bool = True, mesh=None,
                   batch_axis: str = "probe", in_shardings=None,
                   device=None) -> Callable:
    """Runtime-parameterized op-mode: enumerate once, sweep policies for free.

    ``site_policy`` fixes *where* quantization may happen — every op output
    it matches becomes an indexed quantize site (its formats are irrelevant;
    use e.g. ``TruncationPolicy.everywhere("e5m2")`` for "any float op", or
    one rule per search scope). Calling the returned wrapper with concrete
    inputs yields a :class:`SweepHandle` bound to those inputs; any
    candidate policy whose matched set is a subset of the site policy's
    lowers to a format table and evaluates WITHOUT a new enumeration.
    ``wrapper.n_traces`` counts enumerations (one per input signature).

    The table lives on the device of the first tensor input (or
    ``device=``); an evaluation makes no host synchronisation per site.

    Gradients as in :func:`truncate`: the sites of a backward pass run
    inside ``fn`` are enumerated under their forward ops' scopes (in a
    frame ``<forward path>/#grad<position>``) and rounded by the table;
    ``.backward()`` outside the handle is straight-through.

    ``mesh`` makes the sweep candidate-parallel: ``handle.batch`` divides
    the leading K (candidate) axis between the ``mesh``'s ``batch_axis``
    ranks, the table rows replicated, and gathers the rows back, bit for
    bit the unsharded handle's (K is identity-padded to the shard multiple
    and sliced back). ``in_shardings``: the inputs' layout, gathered to the
    global program's inputs as for :func:`truncate`."""
    suffix = (site_policy.cache_key(), impl,
              _mesh_key(mesh, in_shardings, batch_axis))

    def wrapped(*args, **kwargs) -> SweepHandle:
        args, kwargs = _checked_inputs(mesh, in_shardings, args, kwargs)
        leaves, in_tree = pytree.tree_flatten((args, kwargs))
        key = _signature_key(in_tree, leaves, suffix)
        index = wrapped._cache.get(key) if cache else None
        if index is None:
            wrapped.n_traces += 1
            index = interpreter.enumerate_sites(fn, args, kwargs, site_policy)
            if cache:
                wrapped._cache[key] = index
        return SweepHandle(fn, index, args, kwargs, impl,
                           _first_device(leaves, device), mesh, batch_axis)

    return _attach_cache(wrapped)


def _legacy_threshold_shim(name: str, legacy, threshold: float) -> float:
    """One deprecation cycle for the historical positional ``threshold``:
    ``memtrace(fn, policy, 1e-4)`` keeps working but warns; the canonical
    spelling is keyword-only (``threshold=1e-4``)."""
    if legacy is None:
        return threshold
    warnings.warn(
        f"{name}(fn, policy, threshold) with a positional threshold is "
        f"deprecated; pass threshold= as a keyword",
        DeprecationWarning, stacklevel=3)
    return float(legacy)


def memtrace(fn: Callable, policy: TruncationPolicy, _threshold=None,
             *, threshold: float = 1e-3, impl: str = "auto",
             cache: bool = True, mesh=None, in_shardings=None) -> Callable:
    """mem-mode: returns a wrapper whose call gives ``(outputs,
    RaptorReport)``. The outputs are the truncated lane's (bit for bit what
    ``truncate`` gives under a policy without dot-input rules); the report
    carries, per source location, the elements whose deviation from the
    full-precision shadow lane exceeds ``threshold``, the largest deviation
    and the elements seen, on the program's device.

    Per input signature the policy is matched once and the location table
    kept (``wrapper.n_traces``).

    A backward pass inside ``fn`` (``memtrace(train.value_and_grad(loss),
    policy)``) is profiled too: each backward op is rounded as ``truncate``
    rounds it, under its forward op's scope, and runs on the shadow lane on
    the shadows of its inputs (tensors autograd saved keep theirs). Its
    location is ``"transpose(jvp())/{scope} {prim} @ {file}:{line}"`` with
    the forward op's line, and an op a ``remat`` region recomputes is at
    ``"transpose(jvp())/rematted_computation/{scope} ..."``, as the
    reference names them (its forward ops are at ``jvp()/{scope}``, the
    port's keep the plain scope).

    ``mesh`` / ``in_shardings``: the inputs' layout on a DeviceMesh. The
    report stays EXACT: sharded (DTensor) inputs are gathered and every
    rank runs the global program, so flags, op counts and ``max_rel`` are
    the single-device report's bit for bit, a cross-shard mean included.
    Reports of per-shard runs of a per-example program reduce with
    ``RaptorReport.allreduce(axis_name)`` (collectives) or
    ``RaptorReport.merge_all`` (host-side)."""
    threshold = _legacy_threshold_shim("memtrace", _threshold, threshold)
    suffix = ("memtrace", policy.cache_key(), threshold, impl,
              _mesh_key(mesh, in_shardings))

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        args, kwargs = _global_inputs(mesh, in_shardings, args, kwargs)
        table = _per_signature(wrapped, cache, suffix, args, kwargs,
                               memmode.LocationTable)
        return memmode.run_shadowed(fn, args, kwargs, policy, threshold,
                                    impl, table)

    return _attach_cache(wrapped)


def profile_trajectory(fn: Callable, policy: TruncationPolicy,
                       _threshold=None, *, threshold: float = 1e-3,
                       n_steps: int = 128, sites=None, impl: str = "auto",
                       cache: bool = True, mesh=None,
                       in_shardings=None) -> Callable:
    """Temporal mem-mode: returns a wrapper whose call gives ``(outputs,
    TrajectoryReport)``, the report holding an ``(n_steps, n_loc)``
    per-step deviation trajectory on top of ``memtrace``'s whole-run totals
    (see ``repro_torch.profile.trajectory``).

    ``n_steps`` sizes the ring buffer: one row per trip of the program's
    outermost loops (a ``loop_body``, or a ``scope(..., loop=True)`` entry,
    that lies in no other loop trip: the app step loop, a scanned layer
    stack). Size it to ``MiniApp.n_steps + 1`` for an exact trajectory;
    longer runs wrap. Inner loops accumulate into their enclosing step's
    row, ops after the last step land in the row after it, and a
    straight-line program lands entirely in row 0. With a backward pass
    inside ``fn`` each outermost trip's backward ops (and its ``remat``
    recompute) are one more step, in the order the backward pass runs them
    (the last layer's first), as the reference's transposed scan steps: a
    stack of L layers gives 2 L steps.

    ``sites`` restricts the per-step trajectory to matching truncated sites
    (substring patterns over location descriptions): only matching sites
    get a trajectory column; whole-run totals still cover every site and
    ``TrajectoryReport.columns`` records the column -> location mapping.
    ``None`` keeps every site. A location description ends in the source
    ``file:line`` of the program, which differs between this package and the
    reference, so only scope and primitive patterns carry across.

    Cached per input signature exactly like ``memtrace``
    (``wrapper.n_traces``); the run makes no host synchronisation.
    ``mesh`` / ``in_shardings`` as for :func:`memtrace`: the global program
    on every rank, the trajectory the single-device one."""
    threshold = _legacy_threshold_shim("profile_trajectory", _threshold,
                                       threshold)
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    sites = tuple(sites) if sites is not None else None
    suffix = ("trajectory", policy.cache_key(), threshold, impl, n_steps,
              sites, _mesh_key(mesh, in_shardings))

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        args, kwargs = _global_inputs(mesh, in_shardings, args, kwargs)
        table = _per_signature(wrapped, cache, suffix, args, kwargs,
                               memmode.LocationTable)
        return memmode.run_shadowed(fn, args, kwargs, policy, threshold,
                                    impl, table, traj_len=n_steps,
                                    traj_sites=sites)

    return _attach_cache(wrapped)


def profile_counts(fn: Callable, policy: TruncationPolicy, *,
                   cache: bool = True, mesh=None,
                   in_shardings=None) -> Callable:
    """Operation and byte counting (the paper's runtime counters): returns a
    wrapper whose call runs ``fn`` once, untruncated, and gives a
    :class:`CountReport` of truncated vs full-precision FLOPs and bytes per
    format and scope. Cached per input signature: a repeated call returns
    the cached report without running (``wrapper.n_traces`` counts runs).
    The count is of what ran, so a program whose work depends on values
    the signature does not hold (a loop bounded by a Python int, a branch
    on data) is counted as its first call ran; ``cache=False`` counts every
    call. ``mesh`` / ``in_shardings`` are accepted as the reference's are
    and only key the cache: the counts are the global program's, which
    every rank runs.

    A backward pass inside ``fn`` (``profile_counts(train.value_and_grad(
    loss), policy)``) is counted too, each backward op under its forward
    op's scope and named as the reference's transpose names it (``add`` is
    ``add_any``). A count rounds nothing, so the backward ops are autograd's
    own derivative formulas, not the reference's (``core.counters``)."""
    suffix = ("counts", policy.cache_key(), _mesh_key(mesh, in_shardings))

    def wrapped(*args, **kwargs):
        args, kwargs = _global_inputs(mesh, in_shardings, args, kwargs)
        return _per_signature(
            wrapped, cache, suffix, args, kwargs,
            lambda: counters.count_ops(fn, args, kwargs, policy))

    return _attach_cache(wrapped)
