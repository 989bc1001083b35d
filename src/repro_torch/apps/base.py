"""The uniform mini-app protocol the whole profiling stack runs on.

RAPTOR's validation targets are real solvers (Flash-X Sod, Sedov, cellular
detonation) judged on *solver-level observables* — conserved quantities and
residual norms — not per-op deviations. :class:`MiniApp` captures exactly
the surface the profiling/search stack needs from such a workload:

  * ``init_state(dtype, device)`` — initial condition (a pytree of tensors)
  * ``step(state)``              — one solver step (plain tensor code)
  * ``run(state)``               — the full trajectory (``n_steps`` steps)
  * ``observables(state)``       — dict of physically meaningful quantities
  * ``error_metric(ref, cand)``  — scalar "how wrong is this trajectory",
                                   smaller is better, inf = inadmissible
  * ``default_policy_scopes()``  — the named-scope regions truncation may
                                   legitimately target

Because ``run_observables`` is an ordinary function of the state,
``truncate``, ``truncate_sweep``, ``memtrace``, ``profile_counts`` and
``autosearch`` all apply to every app unmodified — the app's
``error_metric`` plugs straight into ``autosearch(metric=...)`` via
``search.metrics.resolve_metric``.

Every loop of a trajectory runs its trips under ``loop_body``, so all trips
share one set of quantize sites, as the reference's scanned bodies do.
Constants enter the arithmetic as Python scalars, which the kernels round
to the state's dtype (the reference's ``jnp.asarray(c, dtype)``) without a
host-to-device copy.

Observable computations are deliberately left OUTSIDE any named scope: they
are the measurement harness, not the workload, so scoped policies (and the
scope frontier ``autosearch`` discovers) can never truncate them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.api import loop_body, scope
from repro_torch.core.formats import parse_format
from repro_torch.core.policy import TruncationPolicy, TruncationRule
from repro_torch.models.common import resolve_device
from repro_torch.search.metrics import host_array

Observables = Dict[str, torch.Tensor]

_EPS = 1e-12
# CG coefficient guard: keeps 0/0 out of alpha/beta once the residual hits
# the rounding floor; small enough to be invisible at any probed precision
_CG_EPS = 1e-30


def _state_tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    """f64-computed initial data, rounded through f32 (so every dtype starts
    from the same bits), on ``device`` (``None`` = the CUDA device)."""
    return torch.from_numpy(a.astype(np.float32)).to(
        device=resolve_device(device), dtype=dtype)


class MiniApp:
    """Base class implementing the shared machinery of the protocol.

    Subclasses provide ``init_state``/``step``/``observables`` (and usually
    override ``error_metric``) plus the class attributes below. All solver
    arithmetic must derive its dtype from the state so the same code runs
    the f32 workload and the f64 oracle trajectory.
    """

    name: str = "?"
    n_steps: int = 1
    # acceptance threshold for error_metric(fp64 oracle, candidate) — the
    # app's physics budget, calibrated on the reference's default sizes
    error_budget: float = 1e-2
    # autosearch threshold on the app's own f32 self-metric; tighter than
    # error_budget so "f32 floor + search slack" stays inside the budget
    search_threshold: float = 1e-3
    # the uniform-low-precision strawman a mixed assignment must beat
    uniform_low: str = "e8m3"
    # mid-ladder probe format for instability profiling / warm-start hint
    # calibration
    probe_format: str = "e8m5"

    # ---- protocol --------------------------------------------------------
    def init_state(self, dtype=torch.float32, device=None):
        raise NotImplementedError

    def step(self, state):
        raise NotImplementedError

    def observables(self, state) -> Observables:
        raise NotImplementedError

    def run(self, state):
        """The full trajectory: ``n_steps`` solver steps, every trip under
        one ``loop_body`` so they share one set of quantize sites (and scope
        discovery counts every trip, as a scan's trip count does)."""
        for _ in range(self.n_steps):
            with loop_body("step"):
                state = self.step(state)
        return state

    def run_observables(self, state) -> Observables:
        """The profiled function of record: state -> solver observables."""
        return self.observables(self.run(state))

    def error_metric(self, ref_obs: Observables,
                     cand_obs: Observables) -> float:
        """Default: worst observable deviation — relative error for scalars,
        relative L2 for fields (see :func:`observable_error`)."""
        return observable_error(ref_obs, cand_obs)

    def default_policy_scopes(self) -> Tuple[str, ...]:
        raise NotImplementedError

    # ---- conveniences ----------------------------------------------------
    def uniform_policy(self, fmt=None) -> TruncationPolicy:
        """Uniform low precision over every solver scope — the strawman the
        searched mixed assignment is graded against. Scoped (not
        ``everywhere``) so the observable harness itself stays exact."""
        f = parse_format(fmt if fmt is not None else self.uniform_low)
        return TruncationPolicy(rules=tuple(
            TruncationRule(fmt=f, scope=s)
            for s in self.default_policy_scopes()))

    # ---- instability profiling (repro_torch.profile) ---------------------
    def profile_trajectory(self, state=None, *, policy=None, threshold=None,
                           n_steps=None, **kwargs):
        """Trajectory-profile ``run_observables``: returns ``(observables,
        TrajectoryReport)``. The ring buffer defaults to ``self.n_steps + 1``
        rows — one per solver step plus one for the trailing observable
        harness — so every step of the trajectory gets its own row and the
        blame ranking's onsets are exact. ``policy`` defaults to the app's
        scopes uniformly at :attr:`probe_format`; ``state`` to
        ``init_state()``, on the CUDA device."""
        from repro_torch.core.api import profile_trajectory as _profile
        if state is None:
            state = self.init_state()
        pol = policy if policy is not None \
            else self.uniform_policy(self.probe_format)
        thr = self.search_threshold if threshold is None else threshold
        steps = (self.n_steps + 1) if n_steps is None else n_steps
        return _profile(self.run_observables, pol, threshold=thr,
                        n_steps=steps, **kwargs)(state)

    def warm_hints(self, state=None, *, widths=None, threshold=None,
                   **kwargs):
        """One profiling run -> ``autosearch(warm_start=...)`` hints: blame
        the trajectory, calibrate site-level peaks against the measured
        solver-level metric of the probe run itself, and lower onto the
        search ladder (see ``repro_torch.profile.ladder_hints``)."""
        from repro_torch.profile import ladder_hints
        from repro_torch.search.driver import DEFAULT_WIDTHS
        if state is None:
            state = self.init_state()
        thr = self.search_threshold if threshold is None else threshold
        obs_lo, traj = self.profile_trajectory(state, threshold=thr, **kwargs)
        joint = self.error_metric(self.run_observables(state), obs_lo)
        return ladder_hints(traj, widths or DEFAULT_WIDTHS, thr,
                            parse_format(self.probe_format).man_bits,
                            joint_metric=joint)

    def __repr__(self) -> str:
        return (f"<{type(self).__name__} {self.name!r} steps={self.n_steps} "
                f"budget={self.error_budget:g}>")


# --------------------------------------------------------------------------
# observable comparison helpers
# --------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return host_array(x).astype(np.float64)


def observable_error(ref_obs: Observables, cand_obs: Observables) -> float:
    """Worst-key observable deviation: scalars compare by relative error,
    fields by relative L2; a non-finite candidate against a finite reference
    is infinitely wrong (a policy that overflows is never admissible)."""
    if set(ref_obs) != set(cand_obs):
        raise ValueError(f"observable keys differ: {sorted(ref_obs)} vs "
                         f"{sorted(cand_obs)}")
    worst = 0.0
    for key in ref_obs:
        r, c = _host(ref_obs[key]), _host(cand_obs[key])
        if np.all(np.isfinite(r)) and not np.all(np.isfinite(c)):
            return float("inf")
        if r.ndim == 0 or r.size == 1:
            d = abs(float(c.ravel()[0]) - float(r.ravel()[0])) \
                / (abs(float(r.ravel()[0])) + _EPS)
        else:
            d = float(np.linalg.norm((c - r).ravel())
                      / (np.linalg.norm(r.ravel()) + _EPS))
        worst = max(worst, d)
    return worst


# --------------------------------------------------------------------------
# shared conjugate-gradient building blocks (heat implicit path + poisson)
# --------------------------------------------------------------------------

def _dot(a, b):
    return torch.sum(a * b)


def cg_iteration(matvec, x, r, p):
    """One textbook CG iteration under the standard scope split: ``matvec``
    (the stencil — the FLOPs bulk), ``coeffs`` (the two global reductions —
    small but famously precision-critical), ``update`` (axpys)."""
    with scope("matvec"):
        Ap = matvec(p)
    with scope("coeffs"):
        rs = _dot(r, r)
        alpha = rs / (_dot(p, Ap) + _CG_EPS)
    with scope("update"):
        x = x + alpha * p
        r_new = r - alpha * Ap
    # a re-entered scope re-uses its sites; the reference traces the second
    # entries into coeffs and update as equations of their own, so they run
    # in a hidden frame of their own (one trip of straight-line code, never
    # a trajectory step)
    with loop_body("beta", once=True):
        with scope("coeffs"):
            beta = _dot(r_new, r_new) / (rs + _CG_EPS)
        with scope("update"):
            p = r_new + beta * p
    return x, r_new, p


def cg_solve(matvec, b, x0, iters: int):
    """Fixed-iteration CG (deterministic op count: the iteration count is
    part of the workload definition, exactly like a solver's max-iters).
    Every iteration runs under one ``loop_body``, so all of them share one
    set of quantize sites inside the caller's scope entry."""
    r0 = b - matvec(x0)
    x, r, p = x0, r0, r0
    for _ in range(iters):
        with loop_body("cg"):
            x, r, p = cg_iteration(matvec, x, r, p)
    return x


__all__ = [
    "MiniApp", "Observables", "observable_error",
    "cg_iteration", "cg_solve",
]
