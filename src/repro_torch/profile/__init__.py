# Instability profiling: per-site error trajectories over the program's
# step loops, divergence-onset detection, per-scope blame ranking, and the
# error-guided warm start feeding repro_torch.search.autosearch.
from repro_torch.profile.trajectory import (
    TrajectoryReport, ScopeBlame, fit_log2_trend, ladder_hints,
    scope_of_location,
)

__all__ = [
    "TrajectoryReport", "ScopeBlame", "fit_log2_trend", "ladder_hints",
    "scope_of_location",
]
