"""Temporal instability profiling: per-site error *trajectories*.

Plain mem-mode collapses a whole run into one scalar per location, so a
solver that diverges at step 400 is indistinguishable from one that is
uniformly sloppy from step 1. For stepped scientific workloads the signal
that makes precision selection cheap is *when and where* error grows (cf.
Nathan et al., "Profile-Driven Automated Mixed Precision"; the
runtime-reconfigurable-precision PDE study arXiv:2409.15073).

:class:`TrajectoryReport` widens the mem-mode accumulators to
``(n_steps, n_loc)`` ring buffers: one row per trip of the program's
OUTERMOST loops (a ``loop_body`` or ``scope(..., loop=True)`` entry that
lies in no other loop trip, see ``core/memmode.py``), one column per
truncated source location. On top of the raw buffers it offers

  * **divergence-onset detection** — the first step at which a site's
    deviation crosses a budget-derived threshold (:meth:`onset_steps`),
  * **error-growth slopes** — least-squares d(log2 err)/d(step)
    (:meth:`growth_slopes`),
  * a per-scope **blame ranking** (:meth:`blame`) ordering scopes most
    unstable first, and
  * :func:`ladder_hints` — the bridge into ``search.autosearch``'s
    error-guided warm start: stable scopes get aggressive initial mantissa
    guesses, unstable scopes are pinned high.

The buffers are tensors on the program's device; a method that decides
something reads them to the host once, as numpy, and does its arithmetic
there in float64, as the reference package's methods do. Reductions mirror
``RaptorReport``: ``merge`` / ``merge_all`` host-side; ``allreduce`` needs
the distribution layer, which is not ported yet. Exactness under data
parallelism: per-step max deviations, op counts and the step counter reduce
bit for bit; the float magnitude sums reproduce up to summation order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.memmode import RaptorReport, _as
from repro_torch.core.policy import normalize_stack
from repro_torch.search.metrics import host_array as _host


def scope_of_location(desc: str) -> str:
    """Normalized scope path of a mem-mode location description
    (``"{scope} {prim} @ {file}:{line}"``)."""
    head = desc.split(" ", 1)[0]
    if head.startswith("<"):            # "<root>", "<no truncated locations>"
        return ""
    return normalize_stack(head)


def fit_log2_trend(steps, values):
    """Least-squares fit of ``log2(values)`` against ``steps`` over finite
    positive samples: ``(slope, level)`` where ``level`` is the fitted
    log2 value at the *last* sample. The :meth:`TrajectoryReport.growth_slopes`
    fit, exposed as a module function so an online filter can extrapolate
    exactly the signal the offline blame ranking sorts by. ``(0.0, -inf)``
    when under-sampled."""
    steps = np.asarray(steps, np.float64)
    values = np.asarray(values, np.float64)
    ok = np.isfinite(steps) & np.isfinite(values) & (values > 0)
    if ok.sum() < 2:
        last = float(np.log2(values[ok][-1])) if ok.any() else float("-inf")
        return 0.0, last
    t, y = steps[ok], np.log2(values[ok])
    t0 = t - t.mean()
    denom = float(np.sum(t0 * t0))
    slope = float(np.sum(t0 * (y - y.mean())) / denom) if denom > 0 else 0.0
    level = float(y.mean() + slope * (t[-1] - t.mean()))
    return slope, level


@dataclasses.dataclass
class TrajectoryReport:
    """Per-(step, location) deviation statistics, tensors on the program's
    device.

    Two temporal signals per (step, location):

      * ``max_rel[t, i]`` — the worst elementwise hybrid deviation site
        ``i`` produced during step ``t`` (see ``memmode.deviation``;
        bounded by 2, so a single tiny-magnitude cell can spike it), and
      * the **mean relative** signal :meth:`rel_traj` —
        ``abs_sum / mag_sum``, total absolute error over total shadow
        magnitude, the rel-L1 analogue of the apps' solver-level metrics.
        This is the default for onset/blame/hints: it sees *accumulated*
        error at the scale of the actual solution, not the worst
        background cell.

    Rows are a ring: step ``s`` lands in row ``s % n_steps``, so buffers
    sized to the workload's step count (``MiniApp.n_steps``) are exact and
    shorter buffers fold late steps onto early rows (``steps_seen`` tells
    how many steps actually ran). ``totals`` carries the ordinary whole-run
    :class:`RaptorReport` (location table, flags, per-site maxima).
    """

    totals: RaptorReport
    scopes: Tuple[str, ...]               # per-COLUMN normalized scope path
    max_rel: Any = None                   # f32[n_steps, n_cols]
    abs_sum: Any = None                   # f32[n_steps, n_cols] sum |low-shadow|
    mag_sum: Any = None                   # f32[n_steps, n_cols] sum |shadow|
    op_counts: Any = None                 # i64[n_steps, n_cols]
    steps_seen: Any = None                # i32[] outermost-loop trips run
    # trajectory column -> location id. ``None`` means the identity (one
    # column per location); a site-filtered profile
    # (``profile_trajectory(sites=...)``) carries columns for the selected
    # locations only — their whole-run totals still cover every site.
    columns: Any = None

    # ---- shape/bookkeeping ------------------------------------------------
    @property
    def locations(self) -> Tuple[str, ...]:
        return self.totals.locations

    def column_locations(self) -> Tuple[int, ...]:
        """Location id of each trajectory column."""
        if self.columns is None:
            return tuple(range(self.n_locations))
        return tuple(self.columns)

    @property
    def n_steps(self) -> int:
        """Ring-buffer rows (NOT necessarily the number of steps run)."""
        return int(np.shape(self.max_rel)[0])

    @property
    def n_locations(self) -> int:
        return len(self.totals.locations)

    @property
    def mean_abs(self) -> torch.Tensor:
        """Mean absolute deviation per (step, location)."""
        abs_sum = torch.as_tensor(self.abs_sum)
        cnt = _as(self.op_counts, torch.float32, abs_sum.device)
        return abs_sum / cnt.clamp_min(1.0)

    def rel_traj(self, signal: str = "mean") -> np.ndarray:
        """The ``(used_rows, n_loc)`` temporal error signal (host numpy):
        ``"mean"`` = total |error| over total |shadow| magnitude (the
        solver-level default), ``"max"`` = worst elementwise deviation."""
        rows = self.used_rows()
        if signal == "max":
            return _host(self.max_rel).astype(np.float64)[:rows]
        if signal != "mean":
            raise ValueError(f"unknown trajectory signal {signal!r}; "
                             "known: 'mean', 'max'")
        err = _host(self.abs_sum).astype(np.float64)[:rows]
        mag = _host(self.mag_sum).astype(np.float64)[:rows]
        cnt = _host(self.op_counts).astype(np.float64)[:rows]
        # magnitude floor: a site whose shadow values are all ~0 measures
        # its error absolutely, mirroring memmode's hybrid deviation
        floor = 1e-6 * np.maximum(cnt, 1.0)
        return err / np.maximum(mag, floor)

    def used_rows(self) -> int:
        """Rows that can carry data: the ``steps_seen`` loop rows PLUS the
        trailing row where post-loop ops (the observable harness after the
        final step) accumulate — that's why ``MiniApp.profile_trajectory``
        sizes the buffer ``n_steps + 1``. At least 1 (straight-line
        programs land entirely in row 0), at most the buffer length."""
        seen = int(_host(self.steps_seen))
        return max(1, min(seen + 1, self.n_steps))

    # ---- reductions (same exactness contract as RaptorReport) -------------
    def allreduce(self, axis_name: str) -> "TrajectoryReport":
        """In-SPMD reduction over a mesh axis: needs the distribution layer,
        which is not ported yet."""
        raise NotImplementedError(
            "TrajectoryReport.allreduce needs the distribution layer, which "
            "is not ported yet; reduce host-side with merge / merge_all")

    def merge(self, other: "TrajectoryReport") -> "TrajectoryReport":
        """Host-side pairwise reduction (across processes/ranks). Accepts
        numpy statistics (a report read back from another process)."""
        if np.shape(self.max_rel) != np.shape(other.max_rel):
            raise ValueError(
                "TrajectoryReport.merge: step buffers differ "
                f"({tuple(np.shape(self.max_rel))} vs "
                f"{tuple(np.shape(other.max_rel))}); "
                "profile both shards with the same n_steps")
        if self.column_locations() != other.column_locations():
            raise ValueError(
                "TrajectoryReport.merge: trajectory columns differ; profile "
                "both shards with the same site selection")
        totals = self.totals.merge(other.totals)  # validates location tables
        device = next((x.device for x in (self.max_rel, other.max_rel)
                       if isinstance(x, torch.Tensor)), None)
        f32, i64 = torch.float32, torch.int64

        def both(name, dtype):
            return (_as(getattr(self, name), dtype, device),
                    _as(getattr(other, name), dtype, device))

        return TrajectoryReport(
            totals=totals,
            scopes=self.scopes,
            max_rel=torch.maximum(*both("max_rel", f32)),
            abs_sum=sum(both("abs_sum", f32)),
            mag_sum=sum(both("mag_sum", f32)),
            op_counts=sum(both("op_counts", i64)),
            steps_seen=torch.maximum(*both("steps_seen", torch.int32)),
            columns=self.columns)

    @staticmethod
    def merge_all(reports: Sequence["TrajectoryReport"]) -> "TrajectoryReport":
        if not reports:
            raise ValueError("merge_all needs at least one report")
        out = reports[0]
        for r in reports[1:]:
            out = out.merge(r)
        return out

    # ---- temporal analysis ------------------------------------------------
    def onset_steps(self, threshold: float,
                    signal: str = "mean") -> np.ndarray:
        """Per-location divergence onset: the first step whose deviation
        exceeds ``threshold`` (-1 = never crossed). With a wrapped ring the
        reported step is the earliest ROW, a lower bound."""
        m = self.rel_traj(signal)
        crossed = m > threshold
        first = np.argmax(crossed, axis=0)
        return np.where(crossed.any(axis=0), first, -1).astype(np.int64)

    def growth_slopes(self, signal: str = "mean") -> np.ndarray:
        """Per-location error-growth slope: least-squares fit of
        log2(deviation) against the step index over rows with finite
        positive deviation (0.0 when fewer than two such rows). Positive
        slopes mean the site's error is still growing at run end —
        instability, not an equilibrated rounding floor."""
        m = self.rel_traj(signal)
        rows = np.arange(m.shape[0], dtype=np.float64)
        out = np.zeros(m.shape[1])
        for i in range(m.shape[1]):
            out[i] = fit_log2_trend(rows, m[:, i])[0]
        return out

    def blame(self, threshold: float,
              signal: str = "mean") -> List["ScopeBlame"]:
        """Per-scope instability ranking, most unstable first: scopes whose
        sites cross ``threshold`` rank before those that never do, earlier
        onsets before later ones, larger peaks break ties. ``threshold``
        is budget-derived — typically the search threshold or a fraction of
        the app's error budget."""
        onsets = self.onset_steps(threshold, signal)
        slopes = self.growth_slopes(signal)
        traj = self.rel_traj(signal)
        peaks = traj.max(axis=0) if traj.size else np.zeros(len(self.scopes))
        flags = _host(self.totals.flags)
        cols = self.column_locations()
        per: Dict[str, ScopeBlame] = {}
        for c, sc in enumerate(self.scopes):
            i = cols[c]                     # the column's location id
            if self.totals.locations[i].startswith("<no truncated"):
                continue                    # the empty-table sentinel row
            b = per.get(sc)
            onset = int(onsets[c]) if onsets[c] >= 0 else None
            if b is None:
                per[sc] = ScopeBlame(scope=sc, peak_rel=float(peaks[c]),
                                     onset=onset, slope=float(slopes[c]),
                                     flags=int(flags[i]), n_sites=1)
            else:
                if onset is not None:
                    b.onset = onset if b.onset is None else min(b.onset, onset)
                b.peak_rel = max(b.peak_rel, float(peaks[c]))
                b.slope = max(b.slope, float(slopes[c]))
                b.flags += int(flags[i])
                b.n_sites += 1
        return sorted(per.values(), key=lambda b: b.sort_key())

    def summary(self, threshold: float, k: int = 10) -> str:
        """The textual blame table — the temporal analogue of
        ``RaptorReport.summary``'s heatmap."""
        lines = [f"  {'onset':>6} {'slope':>8} {'peak_dev':>9} "
                 f"{'flags':>10}  scope"]
        for b in self.blame(threshold)[:k]:
            onset = f"{b.onset}" if b.onset is not None else "-"
            lines.append(f"  {onset:>6} {b.slope:>8.3f} {b.peak_rel:>9.2e} "
                         f"{b.flags:>10d}  {b.scope or '<root>'}")
        lines.append(f"  -- {self.n_locations} sites over "
                     f"{int(_host(self.steps_seen))} steps "
                     f"({self.n_steps}-row buffer), onset threshold "
                     f"{threshold:.1e}")
        return "\n".join(lines)


@dataclasses.dataclass
class ScopeBlame:
    """One scope's instability verdict in a blame ranking."""

    scope: str
    peak_rel: float          # worst whole-run deviation over the scope's sites
    onset: Optional[int]     # earliest step any site crossed the threshold
    slope: float             # steepest per-site log2-error growth (bits/step)
    flags: int               # total flagged elements
    n_sites: int

    def sort_key(self):
        # crossed-threshold scopes first, earliest onset first, then peak
        return (0 if self.onset is not None else 1,
                self.onset if self.onset is not None else math.inf,
                -self.peak_rel)

    @property
    def divergent(self) -> bool:
        """Crossed the threshold AND still growing — the classic
        step-400-blowup signature, as opposed to a flat rounding floor."""
        return self.onset is not None and self.slope > 0.0


def ladder_hints(traj: TrajectoryReport, widths: Sequence[int],
                 threshold: float, probe_man_bits: int, *,
                 joint_metric: Optional[float] = None,
                 margin: int = 1,
                 pin_slope: Optional[float] = None
                 ) -> Dict[str, Optional[int]]:
    """Lower a trajectory profile into per-scope warm-start hints for
    ``search.autosearch(warm_start=...)``.

    The profile must have been taken with every scope truncated to
    ``probe_man_bits`` mantissa bits (e.g. the app's uniform probe policy).
    Each extra mantissa bit halves rounding error, so a scope whose peak
    deviation at the probe width is ``peak`` is predicted to meet
    ``threshold`` at ``probe_man_bits + log2(peak / threshold)`` bits
    (plus ``margin`` bits of safety). The prediction is clamped onto the
    candidate ladder:

      * stable scopes (tiny peak) -> the narrowest candidate width — the
        aggressive guess the warm start probes first,
      * mid scopes -> the narrowest ladder width predicted admissible,
      * unstable scopes (prediction off the ladder's fine end, non-finite
        peak, or — when ``pin_slope`` is set — threshold-crossing error
        still growing faster than ``pin_slope`` bits/step) -> ``None`` —
        pinned high, i.e. predicted full precision, so the warm start
        seeds its bisection at the finest rung instead of wasting narrow
        probes.

    Site-level deviations over-estimate solver-level metrics (elementwise
    errors cancel in conserved-quantity observables, and the shadow measures
    the whole trajectory's accumulated drift, not one scope's marginal
    contribution). ``joint_metric`` corrects for this: pass the search
    metric evaluated between the profile run's truncated outputs and the
    full-precision outputs (what the joint probe-width policy actually
    scores), and every scope's peak is rescaled so the worst scope predicts
    that measured value.

    Hints are predictions, not decisions: the warm-started search probes
    every assignment it accepts (see ``autosearch``), so a wrong hint costs
    extra bisection rounds, not an unvalidated assignment.
    """
    cand = sorted({int(w) for w in widths if 0 <= int(w) < 23})
    if not cand:
        return {}
    blame = traj.blame(threshold)
    scale = 1.0
    if joint_metric is not None:
        peaks = [b.peak_rel for b in blame if np.isfinite(b.peak_rel)]
        top = max(peaks, default=0.0)
        if top > 0 and np.isfinite(joint_metric) and joint_metric > 0:
            scale = joint_metric / top
    hints: Dict[str, Optional[int]] = {}
    for b in blame:
        if not b.scope:
            continue
        if not np.isfinite(b.peak_rel):
            hints[b.scope] = None           # overflowed at the probe width
            continue
        if (pin_slope is not None and b.onset is not None
                and b.slope > pin_slope):
            hints[b.scope] = None           # diverging, pin high
            continue
        if b.peak_rel <= 0.0:
            hints[b.scope] = cand[0]        # bit-exact at the probe width
            continue
        pred = probe_man_bits + math.log2(b.peak_rel * scale / threshold)
        pred = int(math.ceil(pred)) + margin
        if pred <= cand[0]:
            hints[b.scope] = cand[0]
        elif pred > cand[-1]:
            hints[b.scope] = None           # beyond the finest candidate
        else:
            hints[b.scope] = min(w for w in cand if w >= pred)
    return hints


__all__ = [
    "TrajectoryReport", "ScopeBlame", "fit_log2_trend", "ladder_hints",
    "scope_of_location",
]
