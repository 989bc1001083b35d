"""2D heat diffusion: explicit stencil phase + implicit backward-Euler/CG.

A periodic unit square carrying a Gaussian temperature bump, evolved first
with the explicit 5-point FTCS stencil (diffusion number 0.24, just inside
the 0.25 stability bound) and then with backward-Euler steps whose linear
system ``(I - k L) u = u_old`` is solved by fixed-iteration CG — the
explicit/implicit pair every production diffusion module carries, with the
CG path dominating FLOPs exactly like the real thing.

Precision story: under periodic boundaries both the explicit update and the
implicit solve conserve total heat exactly in exact arithmetic (the stencil
is a divergence and CG preserves the mean of the right-hand side when the
operator does), so the total-heat drift is a pure rounding observable; the
final temperature field adds L2 solution sensitivity.

Scopes: ``heat/stencil`` (explicit phase), ``heat/implicit`` over the CG
machinery (``.../matvec``, ``.../coeffs``, ``.../update``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.apps.base import MiniApp, Observables, _state_tensor, cg_solve
from repro_torch.core.api import loop_body, scope


def _lap_periodic(u):
    """5-point periodic Laplacian in grid units (dx = 1)."""
    return (torch.roll(u, 1, 0) + torch.roll(u, -1, 0)
            + torch.roll(u, 1, 1) + torch.roll(u, -1, 1) - 4.0 * u)


class HeatDiffusion(MiniApp):
    name = "heat"
    error_budget = 1e-2
    search_threshold = 2e-3
    uniform_low = "e8m3"

    def __init__(self, n: int = 32, n_explicit: int = 64,
                 n_implicit: int = 4, cg_iters: int = 24,
                 k_explicit: float = 0.24, k_implicit: float = 2.0):
        self.n = int(n)
        self.n_explicit = int(n_explicit)
        self.n_implicit = int(n_implicit)
        self.cg_iters = int(cg_iters)
        self.k_explicit = float(k_explicit)   # diffusion number, < 0.25
        self.k_implicit = float(k_implicit)   # unconditionally stable
        # protocol bookkeeping: one "step" = the whole explicit phase or one
        # implicit solve; run() overrides the generic loop (two phases)
        self.n_steps = self.n_explicit + self.n_implicit

    # ---- protocol --------------------------------------------------------
    def init_state(self, dtype=torch.float32, device=None):
        """Gaussian bump, f64-computed then f32-rounded (see SodShockTube),
        on ``device`` (``None`` = the CUDA device)."""
        n = self.n
        xy = (np.arange(n, dtype=np.float64) + 0.5) / n
        X, Y = np.meshgrid(xy, xy, indexing="ij")
        u = np.exp(-((X - 0.5) ** 2 + (Y - 0.5) ** 2) / 0.02)
        return _state_tensor(u, dtype, device)

    def _explicit_step(self, u):
        with scope("heat"):
            with scope("stencil"):
                return u + self.k_explicit * _lap_periodic(u)

    def _implicit_step(self, u):
        k = self.k_implicit

        def matvec(v):
            return v - k * _lap_periodic(v)

        with scope("heat"):
            with scope("implicit"):
                return cg_solve(matvec, u, torch.zeros_like(u), self.cg_iters)

    def step(self, u):
        """Generic single step (explicit) — the step-loop protocol entry;
        ``run`` composes the real two-phase trajectory."""
        return self._explicit_step(u)

    def run(self, u):
        for _ in range(self.n_explicit):
            with loop_body("explicit"):
                u = self._explicit_step(u)
        for _ in range(self.n_implicit):
            with loop_body("implicit"):
                u = self._implicit_step(u)
        return u

    def observables(self, u) -> Observables:
        return {
            "total_heat": torch.sum(u),   # exactly conserved (periodic BC)
            "peak": torch.amax(u),        # bump decay (monotone under heat)
            "field": u,                   # solution accuracy (rel L2)
        }

    def default_policy_scopes(self) -> Tuple[str, ...]:
        return ("heat/stencil", "heat/implicit/matvec",
                "heat/implicit/coeffs", "heat/implicit/update")
