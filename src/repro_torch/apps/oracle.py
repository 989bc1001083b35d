"""FP64 reference trajectories and acceptance verdicts for the mini-apps.

The verification contract of the suite: every candidate precision policy is
graded against the *same app run in float64* — the practical stand-in for
RAPTOR's MPFR ground truth. Because ``init_state`` rounds initial data
through f32 for every dtype, the f64 trajectory differs from the f32 one by
solver arithmetic alone, so

    error_metric(fp64 oracle obs, candidate obs)  <=  app.error_budget

is a pure statement about accumulated rounding in the candidate's
arithmetic. ``fp32_floor`` measures where plain f32 lands on that scale —
the buffer between it and the budget is the room a truncation policy may
spend.

Oracle observables are returned as host numpy (f64). Every function runs
the app on ``device`` (``None`` = the CUDA device; raises without one).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.apps.base import MiniApp, Observables, _host


def fp64_reference(app: MiniApp, device=None) -> Dict[str, np.ndarray]:
    """The app's full trajectory in float64: the oracle observables."""
    with torch.no_grad():
        obs = app.run_observables(app.init_state(torch.float64, device))
    return {k: _host(v) for k, v in obs.items()}


def fp32_observables(app: MiniApp, device=None) -> Observables:
    """The plain f32 workload run (no truncation) — the search's reference
    lane and the floor of ``oracle_error``."""
    with torch.no_grad():
        return app.run_observables(app.init_state(torch.float32, device))


def oracle_error(app: MiniApp, cand_obs: Observables,
                 ref_obs: Dict[str, np.ndarray] = None, device=None) -> float:
    """``app.error_metric`` of a candidate's observables against the FP64
    oracle (computed fresh unless ``ref_obs`` is supplied)."""
    if ref_obs is None:
        ref_obs = fp64_reference(app, device)
    return app.error_metric(ref_obs, cand_obs)


def fp32_floor(app: MiniApp, ref_obs: Dict[str, np.ndarray] = None,
               device=None) -> float:
    """Oracle error of the untruncated f32 run — how much of the budget
    plain single precision already spends on this app."""
    return oracle_error(app, fp32_observables(app, device), ref_obs, device)


@dataclasses.dataclass(frozen=True)
class OracleVerdict:
    """One acceptance check: candidate observables vs the FP64 trajectory."""

    app: str
    error: float
    budget: float
    floor: float          # the untruncated-f32 oracle error, for context

    @property
    def passed(self) -> bool:
        return self.error <= self.budget

    def __str__(self) -> str:
        return (f"[{self.app}] oracle error {self.error:.3e} "
                f"(budget {self.budget:.1e}, f32 floor {self.floor:.3e}) "
                f"-> {'PASS' if self.passed else 'FAIL'}")

    # ---- policy-artifact integration --------------------------------------
    def to_json(self) -> dict:
        return {"app": self.app, "error": float(self.error),
                "budget": float(self.budget), "floor": float(self.floor),
                "passed": self.passed}

    @staticmethod
    def from_json(data: dict) -> "OracleVerdict":
        return OracleVerdict(app=str(data["app"]),
                             error=float(data["error"]),
                             budget=float(data["budget"]),
                             floor=float(data["floor"]))

    def attach(self, artifact):
        """Stamp this verdict onto a ``PolicyArtifact`` (returns the new,
        verdict-bearing artifact — artifacts are immutable)."""
        return artifact.with_oracle(self)


def verdict(app: MiniApp, cand_obs: Observables,
            ref_obs: Dict[str, np.ndarray] = None,
            device=None) -> OracleVerdict:
    """Grade candidate observables against the oracle and the app budget."""
    if ref_obs is None:
        ref_obs = fp64_reference(app, device)
    return OracleVerdict(
        app=app.name,
        error=oracle_error(app, cand_obs, ref_obs, device),
        budget=app.error_budget,
        floor=fp32_floor(app, ref_obs, device))
