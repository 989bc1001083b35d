"""Hardware co-design speedup model (paper §7.2, Table 4, Fig. 8).

The paper models a CPU whose die area is split between FP64 and one
low-precision FPU, with per-precision performance densities extrapolated from
FPNew, then predicts speedup as  T = sum_i N_i / (A_i * P_i)  for the op
counts N_i collected by the runtime, plus a memory-traffic model and a
roofline crossover to pick which bound applies.

The port parameterizes the model for the NVIDIA H100 SXM5 80 GB at its
700 W power limit, from the dense (no sparsity) figures of NVIDIA's data
sheet ("NVIDIA H100 Tensor Core GPU Datasheet",
https://resources.nvidia.com/en-us-tensor-core/nvidia-tensor-core-gpu-datasheet):

  * compute: bf16 tensor cores 989 TFLOP/s; fp8 twice that (1,979);
    IEEE float32 on the CUDA cores 67 TFLOP/s. TF32 (495) is not a rung:
    the port keeps ``allow_tf32`` off, so an f32 program runs at the f32
    rate;
  * memory: HBM3 at 3.35 TB/s; truncated formats move proportionally fewer
    bytes (their storage container).

A card set below 700 W runs slower under load, and these are peaks: **no
prediction of this model is a claim** until ``reconcile`` has a speedup
measured on the card beside it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

from repro_torch.core.counters import CountReport
from repro_torch.core.formats import FPFormat, parse_format

# ---- hardware constants (NVIDIA H100 SXM5 80 GB, 700 W; data sheet) -------
PEAK_BF16_FLOPS = 989e12         # dense bf16 tensor-core rate
PEAK_FP8_FLOPS = 2 * PEAK_BF16_FLOPS
PEAK_F32_FLOPS = 67e12           # IEEE f32 outside the tensor cores
HBM_BW = 3.35e12                 # bytes/s

# FPNew performance-density table from the paper (Table 4), normalized to
# fp64 = 1.0 — used for the CPU-style co-design variant.
FPNEW_PERF_DENSITY = {
    "fp64": 1.00,
    "fp32": 2.65,
    "fp16": 7.30,
    "e5m2": 18.41,
}


def _width_bits(fmt: FPFormat) -> int:
    return 1 + fmt.exp_bits + fmt.man_bits


def h100_relative_throughput(fmt: FPFormat) -> float:
    """Relative FLOP/s of ops on values storable in ``fmt`` vs bf16 = 1.0
    on the H100. Emulated widths snap up to the next hardware container:
    <= 8 bits the fp8 tensor cores (2x), <= 16 bits the bf16 ones (1x),
    wider the f32 CUDA cores (67 / 989)."""
    w = _width_bits(fmt)
    if w <= 8:
        return PEAK_FP8_FLOPS / PEAK_BF16_FLOPS
    if w <= 16:
        return 1.0
    return PEAK_F32_FLOPS / PEAK_BF16_FLOPS


def container_bytes(fmt: FPFormat) -> int:
    w = _width_bits(fmt)
    if w <= 8:
        return 1
    if w <= 16:
        return 2
    return 4


@dataclasses.dataclass
class SpeedupEstimate:
    compute_bound: float         # predicted speedup if compute bound
    memory_bound: float          # predicted speedup if memory bound
    operational_intensity: float  # flops/byte of the *baseline* workload
    bound: str                   # which side of the roofline the baseline is on

    @property
    def predicted(self) -> float:
        return self.compute_bound if self.bound == "compute" else self.memory_bound


def estimate_speedup(report: CountReport,
                     baseline_fmt: str = "fp32",
                     peak_flops: float = PEAK_BF16_FLOPS,
                     hbm_bw: float = HBM_BW) -> SpeedupEstimate:
    """Paper Fig. 8: predicted speedup of a truncation profile vs running
    everything in ``baseline_fmt``.

    compute model:  T = sum_i N_i / (peak * rel_throughput_i)
    memory model:   T = sum_i B_i * (container_i / baseline_container) / bw
    """
    base = parse_format(baseline_fmt)
    base_tp = h100_relative_throughput(base)
    base_bytes = container_bytes(base)

    total_flops = report.total_flops
    total_bytes = sum(report.bytes_by_fmt.values())
    if total_flops == 0:
        return SpeedupEstimate(1.0, 1.0, 0.0, "compute")

    t_base_c = total_flops / (peak_flops * base_tp)
    t_base_m = total_bytes / hbm_bw

    t_mix_c = 0.0
    t_mix_m = 0.0
    for key, flops in report.flops_by_fmt.items():
        fmt = base if key == "full" else parse_format(key)
        t_mix_c += flops / (peak_flops * h100_relative_throughput(fmt))
        nbytes = report.bytes_by_fmt.get(key, 0.0)
        t_mix_m += nbytes * (container_bytes(fmt) / base_bytes) / hbm_bw

    oi = total_flops / max(total_bytes, 1.0)
    ridge = (peak_flops * base_tp) / hbm_bw
    bound = "compute" if oi >= ridge else "memory"
    return SpeedupEstimate(
        compute_bound=t_base_c / max(t_mix_c, 1e-30),
        memory_bound=t_base_m / max(t_mix_m, 1e-30),
        operational_intensity=oi,
        bound=bound,
    )


@dataclasses.dataclass
class Reconciliation:
    """Measured-vs-modeled speedup reconciliation for one experiment.

    ``gap`` is the fraction of the modeled win the measurement realized
    (measured / modeled): 1.0 means the model was exact, < 1.0 means the
    backend under-delivers, > 1.0 means the model was conservative (e.g.
    fusion savings the compute term does not credit)."""
    measured: float
    modeled: float

    @property
    def gap(self) -> float:
        return self.measured / max(self.modeled, 1e-30)

    def within(self, tol: float) -> bool:
        """True when the measurement is within ``tol`` (relative) of the
        model on either side."""
        return abs(self.gap - 1.0) <= tol


def reconcile(measured: float, modeled: float) -> Reconciliation:
    """Pair a measured wall-clock speedup with its model prediction, so
    every predicted speedup is read beside a measured ratio on the same
    program and the gap between them is a number, not prose."""
    return Reconciliation(measured=float(measured), modeled=float(modeled))


def fpu_area_model(counts_by_fmt: Mapping[str, float],
                   density: Mapping[str, float] = FPNEW_PERF_DENSITY,
                   area_ratio_dbl_low: Optional[float] = None,
                   ) -> Dict[str, float]:
    """The paper's exact CPU-style model: two FPUs (double + one low
    precision) in a fixed area budget; time = sum N_i / (A_i * P_i).

    ``area_ratio_dbl_low`` defaults to the paper's A_dbl : A_low = 1.39
    (derived from a 1:2 fp64:fp32 compute-capability split, A64FX-style).
    Returns times per configuration, normalized to all-double = 1.0.
    """
    ratio = 1.39 if area_ratio_dbl_low is None else area_ratio_dbl_low
    a_dbl = ratio / (1.0 + ratio)
    a_low = 1.0 / (1.0 + ratio)
    p_dbl = density["fp64"]

    n_total = sum(counts_by_fmt.values())
    t_all_dbl = n_total / (a_dbl * p_dbl)

    out = {}
    for key, dens in density.items():
        if key == "fp64":
            continue
        t = 0.0
        for fmt_key, n in counts_by_fmt.items():
            if fmt_key == "full":
                t += n / (a_dbl * p_dbl)
            else:
                t += n / (a_low * dens)
        out[key] = t_all_dbl / max(t, 1e-30)
    return out
