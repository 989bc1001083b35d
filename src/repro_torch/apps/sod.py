"""Sod shock tube: 1D compressible Euler, first-order finite volume.

The canonical hydro verification problem (and the paper's first Flash-X
study): a diaphragm at x=0.5 separates (rho=1, p=1) from (rho=0.125,
p=0.1); the breakup produces a left rarefaction, contact, and right shock.
Scheme: Godunov-type finite volume with the Rusanov (local Lax-Friedrichs)
flux and transmissive boundaries.

Precision story: with transmissive boundaries and u=0 end states, the
boundary mass/energy fluxes are exactly zero until a wave reaches the ends,
so total mass and total energy are conserved *exactly* in exact arithmetic
— their drift over the run measures accumulated rounding alone, the
conserved-quantity observable the paper grades applications on. The density
profile L2 error adds solution-accuracy sensitivity on top.

Scopes: ``hydro/eos`` (primitive recovery: divisions, sqrt — fragile),
``hydro/flux`` (interface fluxes — the FLOPs bulk), ``hydro/update`` (the
conservative difference — where cancellation lives).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.apps.base import MiniApp, Observables, _state_tensor
from repro_torch.core.api import scope


class SodShockTube(MiniApp):
    name = "sod"
    error_budget = 2e-2
    search_threshold = 5e-3
    uniform_low = "e8m3"

    def __init__(self, n_cells: int = 128, t_end: float = 0.2,
                 cfl: float = 0.4, gamma: float = 1.4):
        self.n_cells = int(n_cells)
        self.gamma = float(gamma)
        self.dx = 1.0 / self.n_cells
        # fixed dt against the global wave-speed bound (max |u|+c in the Sod
        # fan is < 2.0 for gamma=1.4) keeps the op count static — dt is part
        # of the workload, not state-dependent control flow
        self.dt = cfl * self.dx / 2.0
        self.n_steps = max(1, int(round(t_end / self.dt)))

    # ---- protocol --------------------------------------------------------
    def init_state(self, dtype=torch.float32, device=None):
        """Conserved state (rho, mom, E), each (n_cells,), on ``device``
        (``None`` = the CUDA device; raises without one).

        Computed in f64 then rounded through f32 before the cast to the
        requested dtype, so the f32 workload and the f64 oracle start from
        bit-identical initial data — trajectory differences measure solver
        arithmetic only, never initialization rounding."""
        n, g = self.n_cells, self.gamma
        x = (np.arange(n, dtype=np.float64) + 0.5) * self.dx
        left = x < 0.5
        rho = np.where(left, 1.0, 0.125)
        p = np.where(left, 1.0, 0.1)
        u = np.zeros(n)
        mom = rho * u
        E = p / (g - 1.0) + 0.5 * rho * u * u
        return tuple(_state_tensor(a, dtype, device) for a in (rho, mom, E))

    def step(self, state):
        rho, mom, E = state
        g = self.gamma
        dt_dx = self.dt / self.dx

        def pad(a):  # transmissive ghost cells
            return torch.cat([a[:1], a, a[-1:]])

        with scope("hydro"):
            rho_p, mom_p, E_p = pad(rho), pad(mom), pad(E)
            with scope("eos"):
                u = mom_p / rho_p
                p = (g - 1.0) * (E_p - 0.5 * mom_p * u)
                c = torch.sqrt(g * p / rho_p)
            with scope("flux"):
                # physical fluxes per padded cell
                f_rho = mom_p
                f_mom = mom_p * u + p
                f_E = (E_p + p) * u
                smax = torch.maximum((torch.abs(u) + c)[:-1],
                                     (torch.abs(u) + c)[1:])
                half = 0.5

                def rusanov(f, q):
                    return (half * (f[:-1] + f[1:])
                            - half * smax * (q[1:] - q[:-1]))

                F_rho = rusanov(f_rho, rho_p)
                F_mom = rusanov(f_mom, mom_p)
                F_E = rusanov(f_E, E_p)
            with scope("update"):
                rho = rho - dt_dx * (F_rho[1:] - F_rho[:-1])
                mom = mom - dt_dx * (F_mom[1:] - F_mom[:-1])
                E = E - dt_dx * (F_E[1:] - F_E[:-1])
        return (rho, mom, E)

    def observables(self, state) -> Observables:
        rho, mom, E = state
        return {
            "mass": torch.sum(rho) * self.dx,    # exactly conserved pre-breakout
            "energy": torch.sum(E) * self.dx,    # exactly conserved pre-breakout
            "rho_profile": rho,                  # solution accuracy (rel L2)
        }

    def default_policy_scopes(self) -> Tuple[str, ...]:
        return ("hydro/eos", "hydro/flux", "hydro/update")
