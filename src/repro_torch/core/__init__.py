# The paper's primary contribution: transparent, scoped, arbitrary-precision
# numerical profiling (RAPTOR, SC'25), here for PyTorch programs on CUDA.
# Same names as the reference package's ``repro.core``.
from repro_torch.core.formats import (
    FPFormat, parse_format, FP64, FP32, TF32, BF16, FP16, E5M2, E4M3, E4M3FN,
)
from repro_torch.core.policy import (
    TruncationPolicy, TruncationRule, magnitude_below, magnitude_above,
    parse_policy, resolve_policy, ResolvedPolicy, NotSerializableError,
)
from repro_torch.core.api import (
    truncate, truncate_sweep, SweepHandle, memtrace, profile_counts,
    profile_trajectory, scope, loop_body,
)
from repro_torch.core.counters import CountReport
from repro_torch.core.memmode import RaptorReport
from repro_torch.core.speedup import (
    estimate_speedup, fpu_area_model, SpeedupEstimate,
)


def __getattr__(name):
    # lazy: repro_torch.profile.trajectory imports repro_torch.core
    # submodules, which runs this package __init__ first
    if name == "TrajectoryReport":
        from repro_torch.profile.trajectory import TrajectoryReport
        return TrajectoryReport
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "FPFormat", "parse_format", "FP64", "FP32", "TF32", "BF16", "FP16",
    "E5M2", "E4M3", "E4M3FN",
    "TruncationPolicy", "TruncationRule", "magnitude_below", "magnitude_above",
    "parse_policy", "resolve_policy", "ResolvedPolicy",
    "NotSerializableError",
    "truncate", "truncate_sweep", "SweepHandle", "memtrace",
    "profile_counts", "profile_trajectory", "scope", "loop_body",
    "CountReport", "RaptorReport", "TrajectoryReport",
    "estimate_speedup", "fpu_area_model", "SpeedupEstimate",
]
