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

Counts are int64 on the program's device; the reference's are int32 unless
x64 is on, which a full-width model outgrows. Nothing here synchronises
with the host: the report stays on the device until it is read.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.core.interpreter import (_PolicyMode, _fresh_root,
                                          _maybe_quantize)
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


def _as(x, dtype, device):
    return torch.as_tensor(x, device=device).to(dtype)


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

    def allreduce(self, axis_name: str) -> "RaptorReport":
        """In-SPMD reduction over a mesh axis: needs the distribution layer,
        which is not ported yet."""
        raise NotImplementedError(
            "RaptorReport.allreduce needs the distribution layer, which is "
            "not ported yet; reduce host-side with merge / merge_all")

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


class LocationTable:
    """What one input signature keeps between calls: ``plan``, the rule
    decided for each site key ``(scope path, position, output index)`` (as
    op-mode's), the location id of each matched key, and the location
    descriptors ``"{scope} {prim} @ {file}:{line}"`` in order of first
    appearance (sites on one line with one scope and primitive share one)."""

    def __init__(self):
        self.plan: Dict[Tuple, Any] = {}
        self.locs: Dict[Tuple, int] = {}
        self.names: List[str] = []
        self._ids: Dict[str, int] = {}

    def location(self, key: Tuple, stack: str, prim: str) -> int:
        idx = self.locs.get(key)
        if idx is not None:
            return idx
        desc = f"{stack or '<root>'} {prim} @ {_user_line()}"
        idx = self._ids.get(desc)
        if idx is None:
            idx = self._ids[desc] = len(self.names)
            self.names.append(desc)
        self.locs[key] = idx
        return idx


class _Tally:
    """One run's statistics, per location: the flag counts and maxima of
    each execution as device scalars (reduced once, at the end), and the
    element counts as host integers (they depend on shapes only)."""

    def __init__(self, threshold: float):
        self.threshold = threshold
        self.flags: List[List[torch.Tensor]] = []
        self.maxes: List[List[torch.Tensor]] = []
        self.counts: List[int] = []
        self.device = None

    def add(self, loc: int, low: torch.Tensor, shadow: torch.Tensor):
        while len(self.counts) <= loc:
            self.flags.append([])
            self.maxes.append([])
            self.counts.append(0)
        self.device = low.device
        self.counts[loc] += low.numel()
        if low.numel() == 0:
            return
        thr = self.threshold
        if low is shadow and 0 <= thr < math.inf:
            # one tensor in both lanes: the deviation is 0 but on NaN lanes,
            # where it is inf; the same numbers without the elementwise pass
            nan = low.isnan()
            self.flags[loc].append(nan.sum())
            self.maxes[loc].append(
                torch.where(nan.any(), math.inf, 0.0).to(torch.float32))
            return
        rel = deviation(low.float(), shadow.float())
        self.flags[loc].append((rel > thr).sum())
        self.maxes[loc].append(rel.amax())

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


class _ShadowMode(_PolicyMode):
    """The paired walk (the reference's ``_eval`` over two environments):
    op-mode's walk (site keys, scopes, primitive names, the rule memo) with
    each op run on the shadow lane too, when any input has a separate
    shadow. Under mem-mode a dot-input rule quantizes no inputs and no row
    is routed into a fused kernel."""

    def __init__(self, policy: TruncationPolicy, threshold: float, impl: str,
                 table: LocationTable):
        super().__init__(policy, impl, table.plan)
        self.table = table
        self.shadows = WeakTensorKeyDictionary()
        self.tally = _Tally(threshold)
        self._sh_out, self._mutates = None, False

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
    def on_inputs(self, frame, pos, prim, func, args, kwargs):
        return args, kwargs, ()

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
        sh = self._sh_out
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
                loc = self.table.location((frame.path, pos, out_idx),
                                          frame.stack, prim)
                self.tally.add(loc, out, shadow)
        kept = low if self._mutates else out
        if shadow is not kept:
            self.shadows[kept] = shadow
        return out

    def report(self, device) -> RaptorReport:
        return self.tally.report(self.table.names, device)


def _program_device(args, kwargs):
    for leaf in pytree.tree_leaves((args, kwargs)):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def run_shadowed(fn, args, kwargs, policy: TruncationPolicy, threshold: float,
                 impl: str, table: LocationTable):
    """Run ``fn(*args, **kwargs)`` on both lanes; returns ``(outputs of the
    truncated lane, RaptorReport)``. ``table`` carries the site decisions
    and locations between runs of one input signature."""
    mode = _ShadowMode(policy, threshold, impl, table)
    with _fresh_root(), mode:
        out = fn(*args, **kwargs)
    return out, mode.report(_program_device(args, kwargs))
