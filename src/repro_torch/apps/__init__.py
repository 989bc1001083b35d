# Scientific mini-apps: PDE workloads with solver-level observables and an
# FP64 oracle — the paper's application-class scenarios (shock hydro, heat
# diffusion, Krylov Poisson) as self-contained profiling targets. Every app
# exposes the uniform MiniApp protocol, so truncate / truncate_sweep /
# memtrace / profile_counts / autosearch run on them unmodified.
from repro_torch.apps.base import (
    MiniApp, Observables, observable_error, cg_iteration, cg_solve,
)
from repro_torch.apps.sod import SodShockTube
from repro_torch.apps.heat import HeatDiffusion
from repro_torch.apps.poisson import PoissonCG
from repro_torch.apps import oracle

# default-size instances: the configurations the reference's FP64-oracle
# budgets are calibrated on; tests needing speed construct smaller ones
APPS = {
    "sod": SodShockTube,
    "heat": HeatDiffusion,
    "poisson": PoissonCG,
}


def get_app(name: str, **kwargs) -> MiniApp:
    """Instantiate a registered mini-app by name (size knobs as kwargs)."""
    try:
        cls = APPS[name]
    except KeyError:
        raise ValueError(
            f"unknown app {name!r}; known: {sorted(APPS)}") from None
    return cls(**kwargs)


__all__ = [
    "MiniApp", "Observables", "observable_error", "cg_iteration", "cg_solve",
    "SodShockTube", "HeatDiffusion", "PoissonCG",
    "oracle", "APPS", "get_app",
]
