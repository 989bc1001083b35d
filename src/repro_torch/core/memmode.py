"""Mem-mode: shadow-value tracking — the numerical debugger (paper §3.5/§6.3).

Every value flows through the computation as a pair ``(truncated, shadow)``.
The shadow lane replays the identical op sequence at full carrier precision —
"as if the entire application had been run in full precision up to that
point". After each truncated op the elementwise deviation is measured with
the hybrid symmetric metric

    |low - shadow| / max(|shadow|, |low|, _ABS_FLOOR)

which degrades to an absolute-error comparison (in units of ``_ABS_FLOOR``)
when the shadow value is zero or denormal. The metric is bounded by 2 for
finite lanes; ``inf`` is reserved for genuine lane disagreement on
finiteness (one lane overflowed or went NaN). Elements above the user
threshold are *flagged* and accumulated per source location: the paper's
heatmap of code locations that do not react well to truncation.

**How the pair is carried.** The reference package walks a traced program
and keeps two environments. The port runs eagerly under a dispatch mode
(``_ShadowMode``, op-mode's walk of ``core/interpreter.py``): the program
sees only the truncated tensors, and the shadow of each truncated tensor
lives in a weak side table keyed by that tensor. So ``.item()`` and a Python
``if`` read the truncated lane — the truncated program decides control flow,
as in the reference — and a shadow dies with its tensor, which keeps memory
at about twice the plain program's. A tensor with no entry is its own
shadow: an op whose inputs all have no separate shadow runs once (bit-equal
to running it twice); any other op runs again on the shadows.

Where eager PyTorch differs from a traced program, the walk keeps the
reference's semantics:

  * an op tagged ``nondeterministic_seeded`` (``rand_like``, ``bernoulli``)
    that runs on both lanes draws the same numbers in both: the shadow call
    starts from the generator state the truncated call started from, and the
    generator is left where the truncated call left it;
  * an in-place op on a tensor that is its own shadow first gets a separate
    shadow (a copy of its base, so views taken earlier see it too), and is
    then applied once to each lane;
  * a matched output is always rounded, even under a ``quantize_dot_inputs``
    rule (the reference's mem-mode quantizes no dot inputs), and a fused
    kernel's row is never routed into its epilogue: its output takes the
    separate quantize pass, as in the reference.

**A backward pass** inside the profiled function (``value_and_grad`` of a
loss) is walked as op-mode walks it (``interpreter._Grads``): every backward
op runs on both lanes under its forward op's scope, the seed gradient has
no separate shadow, the engine's sums of a tensor's cotangents are ops of
the walk, a derivative formula's ops (``interpreter._FORMULAS``) run on both
lanes under ``_PairMode``, and a tensor autograd saves keeps its shadow
(``run_shadowed`` packs it as a detached alias the walk pairs; inside a
``remat`` region the recompute, forward code under the walk, makes them).
A backward op's location carries its forward op's line, which the engine's
thread cannot read off its own stack (``LocationTable``).

Counts are int64 on the program's device; the reference's are int32 unless
x64 is on, which a full-width model outgrows. Nothing here synchronises
with the host: the report stays on the device until it is read.

**Trajectory mode** (``traj_len > 0``, see ``repro_torch.profile.trajectory``)
also records *when* each site's error appears: one row per trajectory step,
a ring of ``traj_len`` rows, one column per location (or per location that
a ``traj_sites`` substring pattern selects). A step is one trip of an
OUTERMOST loop: a ``loop_body`` or ``scope(..., loop=True)`` entry that lies
in no other loop trip (``interpreter.on_step``), which is what one trip of a
depth-0 ``scan`` or ``while`` is to the reference. Each site execution adds
its largest deviation, its |error| sum, its |shadow| sum and its element
count to the row of the step it runs in; at the end of the run each step's
row folds into the ring at ``step % traj_len``, in step order, and ops after
the last step (a final norm, the logits) land in the row after it. A
backward pass adds a step for each outermost trip it differentiates, in the
order it runs them (``_Tally.in_trip``), as each trip of the reference's
transposed scan is one. The step
counter is a host integer (the loops are Python loops); every statistic
stays on the device, and the run makes no host synchronisation.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.core.interpreter import (_PolicyMode, _fresh_root, _tls,
                                          _maybe_quantize, on_step)
from repro_torch.core.policy import TruncationPolicy

# Hybrid deviation floor: below this magnitude (on BOTH lanes) deviations are
# measured absolutely in units of the floor instead of relatively, so an
# exactly-zero or denormal shadow value can never manufacture an inf/nan
# "relative" error.
_ABS_FLOOR = 1e-6

NO_LOCATIONS = "<no truncated locations>"


def deviation(lowf, shf):
    """Elementwise hybrid symmetric deviation between the truncated and
    shadow lanes (both float32): bounded by 2 for finite inputs, exactly 0
    for bitwise-equal lanes (including inf==inf), and inf only when the
    lanes disagree on finiteness or the shadow itself is NaN."""
    rel = (lowf - shf).abs_()
    denom = shf.abs()
    torch.maximum(denom, lowf.abs(), out=denom)
    rel.div_(denom.clamp_min_(_ABS_FLOOR))
    del denom
    rel.masked_fill_(lowf == shf, 0.0)
    # inf-vs-finite gives inf/inf = nan, nan in either lane propagates:
    # both are maximal disagreement, not missing data
    return rel.masked_fill_(rel.isnan(), math.inf)


def abs_error(lowf, shf):
    """Elementwise |low - shadow| as the trajectory sums it: exactly 0 for
    bitwise-equal lanes (including inf==inf) and inf where it is NaN."""
    err = (lowf - shf).abs_()
    err.masked_fill_(lowf == shf, 0.0)
    return err.masked_fill_(err.isnan(), math.inf)


def _as(x, dtype, device):
    return torch.as_tensor(x, device=device).to(dtype)


def _axis_group(mesh, axis_name: str):
    """The process group of ``axis_name`` on ``mesh`` (default: the mesh
    of the innermost ``sharding.use_mesh``)."""
    from repro_torch.distributed import sharding
    mesh = mesh if mesh is not None else sharding.current_mesh()
    if mesh is None:
        raise ValueError(
            "allreduce needs a DeviceMesh: pass mesh= or call it inside "
            "distributed.sharding.use_mesh(mesh)")
    return sharding.axis_group(mesh, axis_name)


@dataclasses.dataclass
class RaptorReport:
    """Per-location numerical deviation statistics: ``flags`` (int64, the
    elements over the threshold), ``max_rel`` (float32, the largest
    deviation) and ``op_counts`` (int64, the truncated elements seen), one
    entry per location of ``locations``, on the program's device."""

    locations: Tuple[str, ...]
    flags: Any = None
    max_rel: Any = None
    op_counts: Any = None

    def top(self, k: int = 10) -> List[Tuple[str, int, float]]:
        flags = torch.as_tensor(self.flags).tolist()
        max_rel = torch.as_tensor(self.max_rel).tolist()
        order = sorted(range(len(self.locations)), key=lambda i: -int(flags[i]))
        return [(self.locations[i], int(flags[i]), float(max_rel[i]))
                for i in order[:k]]

    def summary(self, k: int = 10) -> str:
        lines = [f"  {'flags':>12} {'max_rel_err':>12}  location"]
        for loc, f, m in self.top(k):
            lines.append(f"  {f:>12d} {m:>12.3e}  {loc}")
        return "\n".join(lines)

    # Exactness contract under data parallelism: ``flags`` and ``op_counts``
    # are sums of per-element predicates, so the global report is the
    # elementwise SUM of per-shard reports; ``max_rel`` is a MAX.

    def allreduce(self, axis_name: str, mesh=None) -> "RaptorReport":
        """Reduction of per-rank reports over the mesh axis ``axis_name``
        (``mesh``, or the mesh of the innermost ``sharding.use_mesh``):
        ``all_reduce`` SUM of flags and op counts, MAX of ``max_rel``. Every
        rank of the axis must call it.

        Each rank computes its own shard's semantics, so the reduced report
        equals the global one exactly when each shard's run is a slice of
        the global program (per-example models, contractions along
        unsharded dims). Programs with cross-batch reductions (a global
        mean, a loss) use ``memtrace(mesh=..., in_shardings=...)``, which
        keeps the program global."""
        group = _axis_group(mesh, axis_name)
        from repro_torch.distributed.sharding import all_reduce
        return RaptorReport(
            self.locations,
            all_reduce(_as(self.flags, torch.int64, None), group, "sum"),
            all_reduce(_as(self.max_rel, torch.float32, None), group, "max"),
            all_reduce(_as(self.op_counts, torch.int64, None), group, "sum"))

    def merge(self, other: "RaptorReport") -> "RaptorReport":
        """Host-side pairwise reduction (e.g. across processes/ranks).
        Accepts numpy statistics (a report read back from another process)."""
        if self.locations != other.locations:
            raise ValueError("RaptorReport.merge: location tables differ "
                             "(reports come from different computations)")
        device = next((x.device for x in (self.flags, other.flags)
                       if isinstance(x, torch.Tensor)), None)
        i64, f32 = torch.int64, torch.float32
        return RaptorReport(
            self.locations,
            _as(self.flags, i64, device) + _as(other.flags, i64, device),
            torch.maximum(_as(self.max_rel, f32, device),
                          _as(other.max_rel, f32, device)),
            _as(self.op_counts, i64, device)
            + _as(other.op_counts, i64, device))

    @staticmethod
    def merge_all(reports: Sequence["RaptorReport"]) -> "RaptorReport":
        if not reports:
            raise ValueError("merge_all needs at least one report")
        out = reports[0]
        for r in reports[1:]:
            out = out.merge(r)
        return out


# --------------------------------------------------------------------------
# locations: per input signature, kept between calls
# --------------------------------------------------------------------------

# frames of torch and of the profiler itself (``repro_torch.core``,
# ``repro_torch.kernels``) never name a location
_CORE_DIR = os.path.dirname(__file__)
_OWN_DIRS = tuple(d + os.sep for d in (
    os.path.dirname(torch.__file__), _CORE_DIR,
    os.path.join(os.path.dirname(_CORE_DIR), "kernels")))


def _join(prefix: str, stack: str) -> str:
    return f"{prefix}/{stack}" if stack else prefix


def _user_line() -> str:
    """``file:line`` of the innermost frame that is neither torch nor the
    profiler (``repro_torch.core``, ``repro_torch.kernels``): the program's
    own source line, as the reference's ``user_frame`` gives it."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if not name.startswith(_OWN_DIRS):
            return f"{os.path.basename(name)}:{f.f_lineno}"
        f = f.f_back
    return "?"


# the reference's name-stack prefixes of a differentiated program's
# backward ops and of their rematerialised forward ops
BACKWARD_PREFIX = "transpose(jvp())"
RECOMPUTE_PREFIX = "transpose(jvp())/rematted_computation"


class LocationTable:
    """What one input signature keeps between calls: ``plan``, the rule
    decided for each site key ``(scope path, position, output index)`` (as
    op-mode's), the location id of each matched key, and the location
    descriptors ``"{scope} {prim} @ {file}:{line}"`` in order of first
    appearance (sites on one line with one scope and primitive share one).

    In a program that differentiates itself a backward op's scope is
    ``transpose(jvp())/{forward scope}`` and its line its forward op's (read
    through the autograd node: the engine's thread has no user frames), and
    a ``remat`` recompute's is ``transpose(jvp())/rematted_computation/
    {scope}``, as the reference names them. A forward op keeps its plain
    scope, where the reference writes ``jvp()/{scope}``. ``lines`` keeps
    each forward op's line by site key ``(scope path, position)``."""

    def __init__(self):
        self.plan: Dict[Tuple, Any] = {}
        self.locs: Dict[Tuple, int] = {}
        self.names: List[str] = []
        self.lines: Dict[Tuple, str] = {}
        self._ids: Dict[str, int] = {}

    def location(self, key: Tuple, frame, prim: str, backward: bool) -> int:
        idx = self.locs.get(key)
        if idx is not None:
            return idx
        stack = frame.stack
        if backward:
            line = self.lines.get(frame.origin, "?")
            stack = _join(BACKWARD_PREFIX, stack)
        else:
            line = _user_line()
            if _tls.recompute:
                stack = _join(RECOMPUTE_PREFIX, stack)
        desc = f"{stack or '<root>'} {prim} @ {line}"
        idx = self._ids.get(desc)
        if idx is None:
            idx = self._ids[desc] = len(self.names)
            self.names.append(desc)
        self.locs[key] = idx
        return idx


class _Tally:
    """One run's statistics, per location: the flag counts and maxima of
    each execution as device scalars (reduced once, at the end), and the
    element counts as host integers (they depend on shapes only).

    With ``traj_len > 0`` it also keeps, for every execution of a location
    that has a trajectory column, its step (a host integer) and its largest
    deviation, |error| sum and |shadow| sum (device scalars): the rows of
    the trajectory (module docstring). ``names`` is the location table,
    read to match ``traj_sites``."""

    def __init__(self, threshold: float, traj_len: int = 0, traj_sites=None,
                 names: Sequence[str] = ()):
        self.threshold = threshold
        self.flags: List[List[torch.Tensor]] = []
        self.maxes: List[List[torch.Tensor]] = []
        self.counts: List[int] = []
        self.device = None
        self.traj_len = int(traj_len)
        self.traj_sites = (tuple(traj_sites) if traj_sites is not None
                           else None)
        self.names = names
        self.step = 0                  # outermost-loop trips ended so far
        self._trip = None              # the trip a backward pass is in
        self.t_at: List[Tuple[int, int]] = []      # (step, location)
        self.t_size: List[int] = []
        self.t_max: List[torch.Tensor] = []
        self.t_abs: List[torch.Tensor] = []
        self.t_mag: List[torch.Tensor] = []
        self._tracked: Dict[int, bool] = {}

    def bump(self):
        """The end of one outermost-loop trip (``interpreter.on_step``)."""
        self.step += 1

    def in_trip(self, trip):
        """An op of a backward pass (or of a ``remat`` recompute) that
        belongs to the forward's outermost-loop trip ``trip`` (``None``: to
        none, as a forward op): a change ends the trip it was in, a step,
        as each trip of the reference's transposed scan is one."""
        if trip != self._trip:
            if self._trip is not None:
                self.step += 1
            self._trip = trip

    def _selects(self, desc: str) -> bool:
        """Whether the location ``desc`` gets a trajectory column."""
        return self.traj_sites is None or any(
            pat in desc for pat in self.traj_sites)

    def _tracks(self, loc: int) -> bool:
        hit = self._tracked.get(loc)
        if hit is None:
            hit = self._tracked[loc] = self._selects(self.names[loc])
        return hit

    def add(self, loc: int, low: torch.Tensor, shadow: torch.Tensor):
        while len(self.counts) <= loc:
            self.flags.append([])
            self.maxes.append([])
            self.counts.append(0)
        self.device = low.device
        self.counts[loc] += low.numel()
        if low.numel() == 0:
            return
        traj = self.traj_len and self._tracks(loc)
        thr = self.threshold
        if low is shadow and 0 <= thr < math.inf:
            # one tensor in both lanes: the deviation is 0 but on NaN lanes,
            # where it is inf; the same numbers without the elementwise pass
            nan = low.isnan()
            self.flags[loc].append(nan.sum())
            m = torch.where(nan.any(), math.inf, 0.0).to(torch.float32)
            self.maxes[loc].append(m)
            if traj:
                lowf = low.float()
                self._record(loc, low.numel(), m, torch.where(
                    nan, math.inf, 0.0).to(torch.float32).sum(),
                    lowf.abs().sum())
            return
        lowf, shf = low.float(), shadow.float()
        rel = deviation(lowf, shf)
        self.flags[loc].append((rel > thr).sum())
        m = rel.amax()
        self.maxes[loc].append(m)
        if traj:
            del rel
            self._record(loc, low.numel(), m, abs_error(lowf, shf).sum(),
                         shf.abs().sum())

    def _record(self, loc, size, m, err, mag):
        self.t_at.append((self.step, loc))
        self.t_size.append(size)
        self.t_max.append(m)
        self.t_abs.append(err)
        self.t_mag.append(mag)

    def report(self, names: Sequence[str], device) -> RaptorReport:
        device = self.device or device
        names = list(names) or [NO_LOCATIONS]
        n = len(names)
        flags = self.flags + [[]] * (n - len(self.flags))
        maxes = self.maxes + [[]] * (n - len(self.maxes))
        counts = self.counts + [0] * (n - len(self.counts))
        i64 = dict(dtype=torch.int64, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return RaptorReport(
            tuple(names),
            torch.stack([torch.stack(p).sum() if p else torch.zeros((), **i64)
                         for p in flags]),
            torch.stack([torch.stack(p).amax() if p
                         else torch.zeros((), **f32) for p in maxes]),
            torch.stack([torch.full((), c, **i64) for c in counts]))

    def trajectory(self, names: Sequence[str], device):
        """The run as a ``TrajectoryReport``: the steps' rows, folded into
        the ring in step order (the reference's per-step fold), on the
        device, with no host synchronisation."""
        from repro_torch.profile.trajectory import (TrajectoryReport,
                                                    scope_of_location)
        totals = self.report(names, device)
        device = self.device or device
        locs = totals.locations
        cols = [i for i, desc in enumerate(locs) if self._selects(desc)]
        col_of = {loc: c for c, loc in enumerate(cols)}
        n_cols, n_rows = max(len(cols), 1), self.traj_len
        n_steps = self.step + 1        # the loop steps and the residual row
        cells = [(s, col_of[loc]) for s, loc in self.t_at]
        f32 = dict(dtype=torch.float32, device=device)
        ring_max = torch.zeros(n_rows * n_cols, **f32)
        ring_abs = torch.zeros(n_rows, n_cols, **f32)
        ring_mag = torch.zeros(n_rows, n_cols, **f32)
        counts = np.zeros((n_rows, n_cols), np.int64)
        if cells:
            at = np.asarray(cells, np.int64)
            np.add.at(counts, (at[:, 0] % n_rows, at[:, 1]),
                      np.asarray(self.t_size, np.int64))
            step_cell = upload(at[:, 0] * n_cols + at[:, 1], device)
            ring_cell = upload((at[:, 0] % n_rows) * n_cols + at[:, 1],
                               device)
            # maxima fold in any order; the sums first per step, each in
            # execution order, then into the ring in step order
            ring_max.scatter_reduce_(0, ring_cell, torch.stack(self.t_max),
                                     "amax")
            fold = upload(np.arange(n_steps, dtype=np.int64) % n_rows,
                          device)
            for ring, vals in ((ring_abs, self.t_abs), (ring_mag, self.t_mag)):
                per_step = torch.zeros(n_steps * n_cols, **f32)
                per_step.index_put_((step_cell,), torch.stack(vals),
                                    accumulate=True)
                ring.index_put_((fold,), per_step.view(n_steps, n_cols),
                                accumulate=True)
        return TrajectoryReport(
            totals=totals,
            scopes=tuple(scope_of_location(locs[i]) for i in cols),
            max_rel=ring_max.view(n_rows, n_cols), abs_sum=ring_abs,
            mag_sum=ring_mag, op_counts=upload(counts, device),
            steps_seen=torch.full((), self.step, dtype=torch.int32,
                                  device=device),
            columns=tuple(cols))


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; on the card one asynchronous copy from
    pinned memory, so no host synchronisation (a copy from pageable memory
    synchronises)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# --------------------------------------------------------------------------
# the paired walk
# --------------------------------------------------------------------------

_WRITES: Dict[Any, Tuple[Tuple[int, str], ...]] = {}
_RETURNS_TENSORS: Dict[Any, bool] = {}


def _written(func, args, kwargs) -> List[torch.Tensor]:
    """The tensors an op writes into (its ``self`` in place, ``out=``)."""
    w = _WRITES.get(func)
    if w is None:
        w = _WRITES[func] = tuple(
            (i, a.name) for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write)
    out = []
    for i, name in w:
        t = args[i] if i < len(args) else kwargs.get(name)
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, (list, tuple)):
            out.extend(x for x in t if isinstance(x, torch.Tensor))
    return out


def _returns_tensors(func) -> bool:
    hit = _RETURNS_TENSORS.get(func)
    if hit is None:
        hit = _RETURNS_TENSORS[func] = any(
            "Tensor" in str(r.type) for r in func._schema.returns)
    return hit


def _generator(args, kwargs) -> torch.Generator:
    g = kwargs.get("generator")
    if g is not None:
        return g
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               None) or torch.device(kwargs.get("device") or "cpu")
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        return torch.cuda.default_generators[idx]
    return torch.default_generator


class _PairMode(TorchDispatchMode):
    """Runs every op on both lanes and keeps each output's shadow in the
    side table: the ops of a derivative formula (``interpreter._FORMULAS``),
    which the walk hands to the formula instead of running them one by
    one. ``off`` while the walk rounds and tallies a formula's site."""

    def __init__(self, walk: "_ShadowMode"):
        super().__init__()
        self.walk, self.off = walk, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.off or not _returns_tensors(func):
            return out
        walk = self.walk
        sh_args, sh_kwargs, paired = walk._lanes(args, kwargs)
        if paired:
            sh = func(*sh_args, **sh_kwargs)
            for o, so in zip(pytree.tree_leaves(out), pytree.tree_leaves(sh)):
                if isinstance(o, torch.Tensor) and so is not o:
                    walk.shadows[o] = so
        return out


class _ShadowMode(_PolicyMode):
    """The paired walk (the reference's ``_eval`` over two environments):
    op-mode's walk (site keys, scopes, primitive names, the rule memo) with
    each op run on the shadow lane too, when any input has a separate
    shadow. Under mem-mode a dot-input rule quantizes no inputs and no row
    is routed into a fused kernel.

    A backward pass inside the function is walked as op-mode walks it
    (``interpreter._Grads``), each op on both lanes: the cotangents' shadows
    are the backward ops' shadow outputs (the seed has none), the engine's
    sums of a tensor's cotangents are ops of the walk, a derivative
    formula's ops run under ``_PairMode``, and a tensor autograd saves for
    the backward keeps its shadow (``run_shadowed``'s saved-tensor hooks;
    inside a ``remat`` region the recompute makes the shadows)."""

    def __init__(self, policy: TruncationPolicy, threshold: float, impl: str,
                 table: LocationTable, traj_len: int = 0, traj_sites=None):
        super().__init__(policy, impl, table.plan)
        self.table = table
        self.shadows = WeakTensorKeyDictionary()
        self.tally = _Tally(threshold, traj_len, traj_sites, table.names)
        self._sh_out, self._mutates = None, False
        self._pair = _PairMode(self)

    # ---- the side table ----------------------------------------------------
    def _shadow(self, t: torch.Tensor) -> torch.Tensor:
        s = self.shadows.get(t)
        if s is not None:
            return s
        base = t._base
        if base is not None:
            bs = self.shadows.get(base)
            if bs is not None:
                # a view taken before its base got a separate shadow (see
                # _separate): the same view of the base's shadow
                s = self.shadows[t] = bs.as_strided(
                    t.size(), t.stride(),
                    t.storage_offset() - base.storage_offset())
                return s
        return t

    def _separate(self, t: torch.Tensor) -> torch.Tensor:
        """Give ``t`` a shadow that does not share its storage, copying its
        base with the base's strides so that every view of the base finds
        its part (``_shadow``)."""
        s = self._shadow(t)
        if s is not t:
            return s
        base = t._base if t._base is not None else t
        bs = torch.empty_strided(base.size(), base.stride(), dtype=base.dtype,
                                 device=base.device)
        bs.copy_(base)
        self.shadows[base] = bs
        return self._shadow(t)

    def _lane(self, x):
        """(``x`` with every tensor replaced by its shadow, whether any
        tensor has a separate one)."""
        if isinstance(x, torch.Tensor):
            s = self._shadow(x)
            return s, s is not x
        if isinstance(x, (list, tuple)) and any(
                isinstance(e, torch.Tensor) for e in x):
            pairs = [self._lane(e) for e in x]
            return type(x)(p[0] for p in pairs), any(p[1] for p in pairs)
        return x, False

    def _lanes(self, args, kwargs):
        sa = [self._lane(a) for a in args]
        sk = {k: self._lane(v) for k, v in kwargs.items()}
        paired = any(p[1] for p in sa) or any(p[1] for p in sk.values())
        return (tuple(p[0] for p in sa), {k: p[0] for k, p in sk.items()},
                paired)

    # ---- the walk's hooks --------------------------------------------------
    def _backward(self, frame) -> bool:
        return frame.origin is not None or frame is self.grads.orphan

    def on_inputs(self, frame, pos, prim, func, args, kwargs):
        grads = self.grads
        if grads.claimed is not None:
            # a forward op autograd records: its line, which its backward
            # ops' locations name
            key = (frame.path, pos)
            if key not in self.table.lines:
                self.table.lines[key] = _user_line()
        if self.tally.traj_len:
            self.tally.in_trip(frame.trip if _tls.recompute
                               or self._backward(frame) else None)
        return args, kwargs, ()

    @contextlib.contextmanager
    def formula_lanes(self):
        self._sh_out, self._mutates = None, False
        with self._pair:
            yield

    def run(self, func, args, kwargs, mutates):
        sh_args, sh_kwargs, paired = self._lanes(args, kwargs)
        paired = paired and _returns_tensors(func)
        if paired and mutates:
            for t in _written(func, args, kwargs):
                self._separate(t)
            sh_args, sh_kwargs, _ = self._lanes(args, kwargs)
        if not paired:
            out = sh_out = func(*args, **kwargs)
        elif torch.Tag.nondeterministic_seeded in func.tags:
            gen = _generator(args, kwargs)
            before = gen.get_state()
            out = func(*args, **kwargs)
            after = gen.get_state()
            gen.set_state(before)
            sh_out = func(*sh_args, **sh_kwargs)
            gen.set_state(after)
        else:
            out = func(*args, **kwargs)
            sh_out = func(*sh_args, **sh_kwargs)
        self._sh_out, self._mutates = sh_out, mutates
        return out

    def on_output(self, frame, pos, out_idx, prim, low):
        pair, off = self._pair, self._pair.off
        pair.off = True
        try:
            return self._paired_output(frame, pos, out_idx, prim, low)
        finally:
            pair.off = off

    def _paired_output(self, frame, pos, out_idx, prim, low):
        sh = self._sh_out
        if sh is None:                  # a formula's value: see _PairMode
            shadow = self._shadow(low)
        else:
            shadow = sh if isinstance(sh, torch.Tensor) else sh[out_idx]
        out = low
        if self.live and low.dtype.is_floating_point:
            rule = self._rule(frame, pos, out_idx, prim, low.dtype)
            if rule is not None:
                out = _maybe_quantize(low, rule, self.impl)
                if out is not low and self._mutates:
                    # the walk copies ``out`` into the written tensor, which
                    # keeps its storage: its shadow must not be that storage
                    shadow = self._separate(low)
                backward = self._backward(frame)
                if backward and self.tally.traj_len:
                    self.tally.in_trip(frame.trip)
                loc = self.table.location((frame.path, pos, out_idx), frame,
                                          prim, backward)
                self.tally.add(loc, out, shadow)
        kept = low if self._mutates else out
        if shadow is not kept:
            self.shadows[kept] = shadow
        return out

    def report(self, device):
        if self.tally.traj_len:
            return self.tally.trajectory(self.table.names, device)
        return self.tally.report(self.table.names, device)


def _program_device(args, kwargs):
    for leaf in pytree.tree_leaves((args, kwargs)):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def run_shadowed(fn, args, kwargs, policy: TruncationPolicy, threshold: float,
                 impl: str, table: LocationTable, *, traj_len: int = 0,
                 traj_sites=None):
    """Run ``fn(*args, **kwargs)`` on both lanes; returns ``(outputs of the
    truncated lane, RaptorReport)``. ``table`` carries the site decisions
    and locations between runs of one input signature. ``traj_len > 0``
    returns a ``TrajectoryReport`` instead, whose ring has ``traj_len``
    rows; ``traj_sites`` (substring patterns over location descriptions)
    narrows its columns to the matching locations."""
    mode = _ShadowMode(policy, threshold, impl, table, traj_len, traj_sites)
    # a tensor autograd saves for a backward pass is packed as a detached
    # alias that the walk pairs, so its shadow is found when it is unpacked
    # whatever object autograd would otherwise hand back for it (a saved
    # output is rebuilt from its data, a tensor the side table may not know)
    hooks = torch.autograd.graph.saved_tensors_hooks(_detach, _same)
    with _fresh_root(), on_step(mode.tally.bump), mode, hooks:
        out = fn(*args, **kwargs)
        mode.tally.in_trip(None)
    return out, mode.report(_program_device(args, kwargs))


def _detach(t):
    return t.detach()


def _same(t):
    return t
