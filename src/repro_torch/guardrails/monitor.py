"""Online divergence detection: cheap per-step signals plus a windowed
trajectory filter (``repro.guardrails.monitor``).

Three detectors, in increasing cost and decreasing latency-to-alarm:

  * **non-finite flags** -- the train step's ``nonfinite`` metric (or a
    host-side isfinite of the loss): one step of latency, catches
    overflow-to-inf and NaN poisoning the moment it reaches the loss.
  * **loss statistics** (:class:`StepMonitor`) -- rolling-window z-score
    and a hard spike-vs-median test over the per-step loss; catches finite
    blowups a few steps after onset.
  * **sampled trajectory filter** (:class:`TrendFilter` +
    :func:`probe_blame`) -- every ``probe_every`` steps the controller runs
    a short ``profile_trajectory`` probe on the live parameters; the
    per-scope blame ranking localizes *which* sites to widen, and the
    filter fits log2(peak deviation) over a window of probes -- the
    ``growth_slopes`` fit -- to predict when the deviation will cross the
    error budget.

Everything here runs on the host, on Python floats.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.profile.trajectory import fit_log2_trend


@dataclasses.dataclass(frozen=True)
class Verdict:
    """One monitor decision. ``alarm`` hands control to the escalation
    ladder; ``nonfinite`` verdicts skip the in-place rung (the parameters
    are already poisoned, only a rollback helps)."""

    ok: bool
    reason: str = ""
    nonfinite: bool = False
    z: float = 0.0

    @property
    def alarm(self) -> bool:
        return not self.ok


OK = Verdict(True)


class StepMonitor:
    """Cheap per-step divergence monitor over the scalar loss.

    Keeps a rolling window of recent *healthy* losses (alarmed samples are
    not admitted, so a blowup cannot drag its own baseline up) and alarms
    on, in order: a non-finite loss (or an explicit ``nonfinite`` flag), a
    hard spike above ``spike_factor`` x the rolling median, or a z-score
    excursion above ``z_threshold``. The z-score denominator is floored at
    a fraction of the mean so a flat plateau (std ~ 0) does not turn noise
    into alarms."""

    def __init__(self, window: int = 32, warmup: int = 8,
                 z_threshold: float = 6.0, spike_factor: float = 10.0):
        if warmup < 2:
            raise ValueError("warmup must be >= 2")
        self.warmup = warmup
        self.z_threshold = z_threshold
        self.spike_factor = spike_factor
        self._losses: collections.deque = collections.deque(maxlen=window)

    def update(self, step: int, loss, nonfinite: bool = False) -> Verdict:
        loss = float(loss)
        if nonfinite or not math.isfinite(loss):
            return Verdict(False, f"non-finite loss at step {step}",
                           nonfinite=True)
        if len(self._losses) >= self.warmup:
            arr = np.asarray(self._losses, np.float64)
            med = float(np.median(arr))
            mean = float(arr.mean())
            std = max(float(arr.std()), 1e-3 * abs(mean), 1e-12)
            z = (loss - mean) / std
            if loss > self.spike_factor * max(abs(med), 1e-12):
                return Verdict(
                    False, f"loss spike at step {step}: {loss:.4g} > "
                           f"{self.spike_factor:g}x median {med:.4g}", z=z)
            if z > self.z_threshold:
                return Verdict(
                    False, f"loss z-score {z:.1f} > {self.z_threshold:g} "
                           f"at step {step}", z=z)
            self._losses.append(loss)
            return Verdict(True, z=z)
        self._losses.append(loss)
        return OK

    def reset(self) -> None:
        """Forget the window -- called after a checkpoint rollback so the
        replayed steps rebuild a baseline instead of diffing against the
        pre-fault trajectory."""
        self._losses.clear()


class TrendFilter:
    """Windowed filter over a sampled trajectory signal.

    Feed it ``(step, value)`` pairs -- e.g. the peak relative deviation of
    each :func:`probe_blame` probe -- and it fits log2(value) against the
    step index over the last ``window`` samples
    (``profile.trajectory.fit_log2_trend``, the statistic the offline blame
    ranking sorts by, applied online). A positive slope means the
    deviation is compounding; :meth:`predicted_crossing` extrapolates the
    fit to estimate how many steps remain until a budget is crossed."""

    def __init__(self, window: int = 8):
        self.window = window
        self._steps: collections.deque = collections.deque(maxlen=window)
        self._values: collections.deque = collections.deque(maxlen=window)

    def update(self, step: int, value: float) -> float:
        """Record a sample; returns the current slope (bits/step)."""
        self._steps.append(float(step))
        self._values.append(float(value))
        return self.slope()

    def slope(self) -> float:
        return fit_log2_trend(self._steps, self._values)[0]

    def predicted_crossing(self, budget: float) -> Optional[int]:
        """Estimated steps (from the latest sample) until the fitted signal
        crosses ``budget``: 0 when already above, ``None`` when the signal
        is not growing or is under-sampled."""
        if len(self._steps) < 2 or budget <= 0:
            return None
        slope, level = fit_log2_trend(self._steps, self._values)
        target = math.log2(budget)
        if level >= target:
            return 0
        if slope <= 0:
            return None
        return int(math.ceil((target - level) / slope))

    def reset(self) -> None:
        self._steps.clear()
        self._values.clear()


def probe_blame(fn, policy, args, threshold: float, *, n_steps: int = 4,
                signal: str = "mean") -> Tuple[List, float]:
    """One sampled trajectory probe: run ``fn(*args)`` under ``policy`` with
    the shadow-trajectory profiler and return ``(blame, peak)`` -- the
    per-scope blame ranking (most unstable first) and the worst relative
    deviation seen. The controller uses the ranking to pick *which* table
    rows to widen and feeds the peak into a :class:`TrendFilter`. ``fn`` is
    a forward (the loss): the profiler walks no backward pass."""
    from repro_torch.core.api import profile_trajectory

    _, traj = profile_trajectory(fn, policy, threshold=threshold,
                                 n_steps=n_steps)(*args)
    blame = traj.blame(threshold, signal=signal)
    m = traj.rel_traj(signal)
    finite = m[np.isfinite(m)] if m.size else m
    peak = float(finite.max()) if finite.size else 0.0
    return blame, peak


__all__ = ["Verdict", "StepMonitor", "TrendFilter", "probe_blame"]
