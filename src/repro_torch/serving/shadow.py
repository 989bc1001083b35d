"""Sampled shadow profiling + drift detection for the serving engine.

A configurable fraction of live requests decode through the
``memtrace`` / ``profile_trajectory``-shadowed step against the *deployed*
policy. The served outputs stay the truncated lane's, so shadowed requests
serve bit-identical tokens. Their per-tick :class:`~repro_torch.core.RaptorReport`
s merge into per-request reports and one rolling serving-side report, and a
drift detector compares the rolling report's worst deviation against the
error level the deployed :class:`~repro_torch.artifacts.PolicyArtifact` was
accepted at. When live traffic exceeds that budget by ``drift_margin``, the
detector fires a re-search hook and records the event in a
:class:`~repro_torch.guardrails.GuardrailLog`, which lands in the
artifact's provenance.

The reports stay on the program's device: merging a tick's report is tensor
code with no host synchronisation; only :meth:`ShadowProfiler.check` reads
the peak back, once a shadowed tick after ``min_shadow_ticks``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.api import memtrace, profile_trajectory
from repro_torch.guardrails.log import GuardrailLog


@dataclasses.dataclass(frozen=True)
class ShadowConfig:
    """Knobs for serving-side shadow profiling.

    ``rate``: fraction of submitted requests sampled into shadow mode (every
    decode tick with at least one live shadowed slot runs the paired step).
    ``mode``: ``"memtrace"`` (whole-step report) or ``"trajectory"``
    (per-layer error trajectories on top).
    ``drift_budget``: accepted error level; defaults to the deployed
    artifact's recorded ``provenance["threshold"]`` (the level its oracle
    verdict was accepted at), falling back to ``threshold``.
    ``drift_margin``: fire when the rolling report's worst relative
    deviation exceeds ``drift_margin * budget``.
    ``min_shadow_ticks``: don't judge drift before this many shadowed steps.
    ``on_drift``: the re-search hook — called once with a
    :class:`DriftEvent`; the detector latches after firing.
    """

    rate: float = 0.0625
    threshold: float = 1e-3
    mode: str = "memtrace"
    n_steps: int = 32
    seed: int = 0
    drift_budget: Optional[float] = None
    drift_margin: float = 4.0
    min_shadow_ticks: int = 8
    on_drift: Optional[Callable[["DriftEvent"], None]] = None


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """One fired drift detection: what drifted, by how much, vs what budget."""

    tick: int
    peak: float                       # worst max_rel in the rolling report
    budget: float                     # accepted error level being enforced
    blame: Tuple[Tuple[str, int, float], ...]   # (location, flags, max_rel)
    report: object                    # the merged serving-side RaptorReport

    def __str__(self):
        top = self.blame[0][0] if self.blame else "<none>"
        return (f"drift@tick{self.tick}: peak {self.peak:.2e} > "
                f"{self.budget:.1e} x margin (top blame: {top})")


class ShadowProfiler:
    """Owns the shadowed decode step, the sampling RNG, the rolling report,
    and the drift detector. The engine calls :meth:`sample` at submit,
    :meth:`step` on ticks with live shadowed slots, and :meth:`check` after
    every shadowed tick."""

    def __init__(self, step_fn, policy, config: ShadowConfig, artifact=None):
        if policy is None:
            raise ValueError(
                "shadow profiling traces deviation against a deployed "
                "truncation policy; construct the Engine with policy=... "
                "(or an artifact) to enable it")
        if config.mode == "trajectory":
            self._step = profile_trajectory(step_fn, policy,
                                            threshold=config.threshold,
                                            n_steps=config.n_steps)
        elif config.mode == "memtrace":
            self._step = memtrace(step_fn, policy,
                                  threshold=config.threshold)
        else:
            raise ValueError(f"unknown shadow mode {config.mode!r}; "
                             "expected 'memtrace' or 'trajectory'")
        self.config = config
        self.artifact = artifact
        self._rng = np.random.RandomState(config.seed)
        self.report = None            # rolling serving-side RaptorReport
        self.shadow_ticks = 0
        self.log = GuardrailLog()
        self.events: List[DriftEvent] = []
        self._fired = False
        prov = getattr(artifact, "provenance", None) or {}
        self.budget = float(
            config.drift_budget
            if config.drift_budget is not None
            else prov.get("threshold", config.threshold))

    # ---- sampling ----------------------------------------------------------
    def sample(self) -> bool:
        """Deterministic (seeded, submission-ordered) request sampling."""
        return bool(self._rng.random_sample() < self.config.rate)

    # ---- the shadowed step -------------------------------------------------
    def step(self, params, cache, tokens):
        """Paired truncated/shadow execution of one decode tick. Returns
        ``(logits, new_cache, report)`` — logits/cache are the truncated
        lane, bit-identical to the plain deployed step."""
        (logits, new_cache), report = self._step(params, cache, tokens)
        return logits, new_cache, report

    def observe(self, report, shadow_requests: Sequence, tick: int) -> None:
        """Merge one tick's report into the rolling serving report and into
        each live shadowed request's per-request report (exact reductions:
        SUM for flags/op_counts, MAX for max_rel)."""
        rep = getattr(report, "totals", report)   # TrajectoryReport -> totals
        self.report = rep if self.report is None else self.report.merge(rep)
        for req in shadow_requests:
            req.report = (rep if req.report is None
                          else req.report.merge(rep))
        self.shadow_ticks += 1

    # ---- drift detection ---------------------------------------------------
    def peak_rel(self) -> float:
        if self.report is None:
            return 0.0
        max_rel = torch.as_tensor(self.report.max_rel).double().cpu().numpy()
        finite = max_rel[np.isfinite(max_rel)]
        return float(finite.max()) if finite.size else 0.0

    def check(self, tick: int) -> Optional[DriftEvent]:
        """Fire (once) when live-traffic deviation breaks the deployed
        artifact's accepted budget. Records ``drift_detected`` (+
        ``research_paged`` when a hook runs) into the guardrail log."""
        if self._fired or self.shadow_ticks < self.config.min_shadow_ticks:
            return None
        peak = self.peak_rel()
        if peak <= self.config.drift_margin * self.budget:
            return None
        self._fired = True
        blame = tuple(self.report.top(5))
        event = DriftEvent(tick=tick, peak=peak, budget=self.budget,
                           blame=blame, report=self.report)
        self.events.append(event)
        self.log.record(tick, "drift_detected", peak=peak, budget=self.budget,
                        margin=self.config.drift_margin,
                        shadow_ticks=self.shadow_ticks,
                        blame=[{"location": loc, "flags": fl, "max_rel": mr}
                               for loc, fl, mr in blame])
        hook = self.config.on_drift
        if hook is not None:
            self.log.record(tick, "research_paged",
                            hook=getattr(hook, "__name__", repr(hook)))
            hook(event)
        return event

    def cache_size(self) -> Optional[int]:
        fn = getattr(self._step, "cache_size", None)
        return None if fn is None else int(fn())


__all__ = ["ShadowConfig", "ShadowProfiler", "DriftEvent"]
