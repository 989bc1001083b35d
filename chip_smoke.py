#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and nothing else; exits non-zero without a
device. Builds the port's CUDA kernels from the sources in this checkout
(one ``nvcc`` per library, all started together), holds each against its
plain PyTorch version on the card, then drives the port's fifteen paths:

  * the main path — op-mode truncation (``truncate`` and ``truncate_sweep``)
    of h2o-danube-1.8b at full width and depth, bf16, one batch of 1 x 8192
    tokens, random weights from a seed;
  * the mem path — mem-mode (``memtrace``) of the same model, depth cut to
    2 layers, and batch under three policies, held bit for bit to op-mode,
    with the counters
    (``profile_counts``); phase ``reconcile`` sets the speedup model's
    prediction beside a measured f32 / bf16 ratio at depth 2;
  * the fused path — the same entry points over the fused-epilogue
    kernels: the attention block of h2o-danube-1.8b's layer 0 (projections,
    flash attention with GQA and the 4096-token window, output projection)
    at 1 x 8192 tokens, and the WKV6 recurrence of rwkv6-7b (64 heads of
    64) at 1 x 4096 tokens, each with a matched site's format row routed
    into the kernel's epilogue, and ``memtrace`` of the attention block;
  * the search path — ``autosearch`` of the same model's loss at full width,
    depth cut to 4 layers, every candidate a swept
    forward through the dynamic quantizer, held to a hand count of launches
    and to ``truncate`` of the searched policy;
  * the mesh path — the same model and shapes on a DeviceMesh of one rank
    (NCCL): ``truncate_sweep(mesh=)`` on a 6-rung and a 5-rung ladder,
    ``memtrace(mesh=, in_shardings=batch_sharding)`` of a DTensor batch and
    ``autosearch(mesh=)``, each held to its unsharded twin bit for bit; and
    two ranks on the same card (gloo, 2 layers): a probe axis of two with
    an identity-padded ladder, and ``RaptorReport`` /
    ``TrajectoryReport.allreduce`` of a per-example program against
    ``merge_all``;
  * the apps path — the Sod, heat and Poisson mini-apps at their default
    sizes: ``autosearch`` against each app's FP64 oracle and budget, the
    uniform-low strawman, a swept ladder against ``truncate``, and the same
    search on the CPU (``device="cpu"``) with the same assignments;
  * the trajectory path — ``profile_trajectory`` of h2o-danube-1.8b at full
    width, depth cut to 2 layers (one layer a step) under the main path's
    policy and with every float result at e8m3, held to ``truncate`` and
    ``memtrace``;
  * the artifact path — the profile -> warm start -> publish -> deploy
    loop: the cold search of the depth-4 model, a trajectory profile of its
    frontier lowered to ``ladder_hints``, the artifact through a registry in
    a temporary directory and ``resolve_policy("danube@v1")``, a
    warm-started re-search (the cold assignments in at most 4 dispatches);
    and the three mini-apps warm-started from ``warm_hints()`` and from
    their cold result's artifact;
  * the models path — every model family's forward: olmoe-1b-7b (64
    experts, top-8) at full width, depth cut to 8 of its 16 layers, bf16,
    1 x 4096 tokens, through
    ``truncate`` scoped to its experts and to its router, three swept
    tables and ``memtrace`` of the router policy; then glm4-9b,
    deepseek-coder-33b, internlm2-20b, qwen2-vl-7b (three position streams)
    and rwkv6-7b at 2 layers, deepseek-v2-236b at 2 (one dense lead layer,
    one MoE layer of 160 experts), hymba-1.5b at 3 (global layers 0 and 2)
    and seamless-m4t-large-v2 at 2 + 2, each at full width, 1 x 2048
    tokens, through one scoped ``truncate`` held to ``impl='ref'``;
  * the serve path — ``repro_torch.launch.serve.main`` at glm4-9b's full
    width, depth cut to 4 of its 40 layers (``--layers 40`` serves all 9.4 B
    parameters), bf16: 8 ragged requests
    through the continuous-batching ``Engine`` in 4 slots under
    ``scope:**/mlp=e5m7``, every decode step's MLP results through the
    static quantizer; the same parameters through ``Engine`` plain,
    truncated and shadowed (``memtrace``), bit-identity of shadowed,
    continuous and isolated decoding, decode against the forward, one drift
    run; then every other family's decode step at full width, depth cut,
    16 steps in 2,048-slot caches (hymba-1.5b's windowed layers through
    their rings) against its forward and one scoped ``truncate`` held to
    ``impl='ref'``, and h2o-danube-1.8b's ring cache decoded 4,112 steps,
    past its 4,096-token window;
  * the train path — training h2o-danube-1.8b at full width, depth cut to
    8 layers (``--layers 24`` runs it whole), bf16 parameters with the f32 master copy, 1 x 2048 tokens from the
    seeded pipeline: plain steps (twice, deterministic), the train step
    truncated under ``scope:**/mlp=e5m7`` (loss and gradients, every
    backward op under its forward scope) held bit for bit to
    ``impl='ref'`` with the static quantizer's launches = the matched
    forward, recompute and backward site executions, the hot-swapped step
    over two tables held to the static steps with the dynamic quantizer's
    launches = its site executions and its sites = a CPU enumeration's (the
    backward runs on autograd's device thread on the card), and
    ``launch.train --production`` with one restore, its checkpoint restored
    bit for bit (at 2 layers unless ``--layers`` is given);
  * the grad profile path — profiling that training loss: ``profile_counts``,
    ``memtrace`` and ``profile_trajectory`` of ``value_and_grad(model.loss)``
    at the train path's width, depth and batch under its policy: the loss
    and gradients ``truncate``'s bit for bit, the static quantizer's
    launches = the matched forward, recompute and backward site executions,
    forward, recompute and backward locations, a trajectory step per layer
    and direction;
  * the fp8 path — ``truncate(model.loss, P, native_fp8=True)`` of
    h2o-danube-1.8b at full width, depth cut to 12 layers, 1 x 8192
    tokens, ``P`` an e4m3
    ``quantize_dot_inputs`` rule on the MLP's products: every one through
    the fp8 dot kernel (``kernels/csrc/fp8_dot.cu``, on the tensor
    cores), the loss held to the emulated ``truncate(model.loss, P)``,
    launches = matched dot sites;
  * the guard path — runtime guardrails on h2o-danube-1.8b at full width,
    depth cut to 2 layers: ``launch.train --production --guardrails
    --policy-artifact ... --inject-fault 0:1:bitflip`` (the fault through
    the dynamic quantizer's fault channel, caught, the row widened, one
    rollback, finite to the end with one enumeration), a fault-free
    ``GuardedTrainer`` bit-equal to the unguarded hot-swap step, and the
    guarded Sod loop recovering from overflow faults;
  * the sharded path — parameters that stay DTensor shards, on two gloo
    ranks of the one card, after the guard path: glm4-9b at full width, 2
    of its 40 layers, served tensor-parallel on (1, 2) under
    ``SERVE_PARAM_RULES`` through ``launch.serve`` (8 ragged requests, 4
    slots, ``**/mlp`` e5m7), each rank half of every sharded leaf,
    teacher-forced logits against the one-rank engine's, static launches =
    ticks x matched site executions, the host syncs of a tick;
    h2o-danube-1.8b at full width, 2 layers, 1 x 2048 a data rank, trained
    on (1, 2) (TP, the reference's smoke mesh) and, with ``--phases
    sharded_fsdp``, on (2, 1) (FSDP): three plain, truncated and
    hot-swapped steps against one rank's, the truncated step bit for bit
    ``impl='ref'``, every sharded leaf of the parameters, moments and
    master a rank's half —

and times the kernels and the forward. Nothing is caught: any failed phase
ends the run with a traceback and a non-zero exit code.

Every phase prints one JSON line. The line before the last lists every
kernel with its launches on the main path (and on each path that ran, in
``launches_by_path``), its error against the plain
version, its time, its bound, the plain version's time and the time of the
one library call that computes the same function (where there is one). The
last line is ``{"ok": true, "device": {...}}``.

Options (for debugging at a smaller size; the defaults are the full run):
``--layers N`` cuts the depth (the search, mesh and artifact paths' is 4,
the mem and trajectory paths' 2, the serve path's 4, the fp8 path's 12, the
train and grad profile paths' 8, the guard path's 2 and the sharded path's
2 served and 2 trained unless given; on the models path, olmoe-1b-7b's, 8
unless given),
``--seq S`` the sequence length of the
h2o-danube paths (``--wkv-seq`` that of the WKV6 program), ``--phases a,b``
runs only some of
``kernels,fused_kernels,main_path,mem_path,traj_path,fused_path,small_ref,
times,reconcile,search_path,mesh_path,apps_path,artifact_path,models_path,
serve_path,train_path,grad_profile_path,fp8_path,guard_path,sharded_path``
(``kernels``
includes the fp8
kernel's checks, ``times`` its times; ``fp8_times`` alone times it)
or adds
``sharded_fsdp`` (the sharded path's training on the FSDP mesh (2, 1)
too), ``fp8_probe`` (the fp8 kernel's design step 0: which tensor-core route holds
its error bound, from a library of its own, ``csrc/fp8_mma_probe.cu``),
``profile`` (device time by kernel name for one plain and one swept forward,
a decode tick, a train step; ``profile_train`` the train step alone),
``train_lr`` (the train path's plain steps at several learning rates and
depths) or ``isa`` (registers and spills of every WKV6 kernel and of the
fp8 dot kernel, from ``nvcc -Xptxas -v``); ``fused_times`` alone times the
flash-attention and WKV6 kernels
without the quantizers (``times`` includes it).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# data-sheet figures of the H100 SXM (NVIDIA H100 data sheet): the bounds
# below are stated against them whatever the card's power limit is
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12        # dense tensor-core rate
PEAK_FP8_OPS_PER_S = 1979e12        # dense tensor-core rate
# instructions one element costs in quantize_one (integer and f32, counted
# from the source: ~8 for the mantissa trick, ~6 subnormal branch, ~6
# overflow, ~4 specials and fault, ~8 widen/narrow/address)
OPS_PER_ELEMENT = 32

# the TPU kernel each of the port's kernels replaces
REPLACES = {
    "quantize_em_static": "src/repro/kernels/quantize_em/kernel.py:88",
    "quantize_em_dynamic": "src/repro/kernels/quantize_em/kernel.py:121",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:84",
    "wkv6": "src/repro/kernels/rwkv6/kernel.py:75",
    # not a pallas_call: the reference's fp8 dot_general, left to XLA
    "fp8_dot": "src/repro/kernels/fp8_dot.py:53",
}

RUNG_M = (23, 15, 10, 7, 5, 3, 2, 1)
RUNG_E = (8, 5, 4, 2)
FAULT_BITS = (0, 1, 24, 31, 32)
STORAGE = (torch.float32, torch.bfloat16, torch.float16)


def check(cond, *why):
    """A failed check ends the run (and survives ``python -O``)."""
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + " ".join(
            str(w) for w in why))


_T0 = time.perf_counter()


def emit(phase: str, **kw):
    """One JSON line; ``at_s`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": round(time.perf_counter() - _T0, 1)}),
          flush=True)


def run_text(cmd):
    return subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          timeout=60, check=True).stdout.decode().strip()


# ---------------------------------------------------------------------------
# comparing bit patterns
# ---------------------------------------------------------------------------

def bit_mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bit patterns differ. For 16-bit storage a NaN may be
    stored with any payload (the narrowing conversion canonicalises it), so
    there two NaNs count as equal; f32 is compared on all 32 bits."""
    check(a.shape == b.shape and a.dtype == b.dtype, a.shape, b.shape)
    if a.dtype == torch.float32:
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())
    diff = a.view(torch.int16) != b.view(torch.int16)
    return int((diff & ~(a.isnan() & b.isnan())).sum())


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two f32 scalars (losses) with the same bit pattern."""
    return bool(a.view(torch.int32) == b.view(torch.int32))


def equal_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two tensors of the same shape and dtype with the same bit patterns
    (NaNs included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        kind = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.view(kind[t.element_size()]) for t in (a, b))
    return bool(torch.equal(a, b))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    both = torch.isfinite(a) & torch.isfinite(b)
    if not bool(both.any()):
        return 0.0
    return float((a[both] - b[both]).abs().max())


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| less 1e-6, in units of the bf16 spacing at
    |want| (8 significant bits: in [2^(e-1), 2^e) the spacing is 2^(e-8))."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(want.abs().clamp_min(torch.finfo(torch.bfloat16).tiny))
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    return float((((got - want).abs() - 1e-6).clamp_min(0) / ulp).max())


def sweep_inputs(device) -> torch.Tensor:
    """All 65536 float16 bit patterns widened to f32, random f32 over the
    whole exponent range, random bit patterns (f32 subnormals, NaN payloads),
    and the specials."""
    r = np.random.RandomState(0)
    f16 = np.arange(1 << 16, dtype=np.uint16).view(np.float16) \
        .astype(np.float32)
    wide = (r.randn(20000) * np.exp(r.randn(20000) * 20)).astype(np.float32)
    bits = r.randint(0, 1 << 32, 20000, dtype=np.uint64).astype(np.uint32) \
        .view(np.float32)
    sub = (r.randint(1, 1 << 23, 4000).astype(np.uint32)
           | (r.randint(0, 2, 4000).astype(np.uint32) << 31)).view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 65504.0, 448.0,
                        57344.0, 3.4028235e38, -3.4028235e38, 1e-45],
                       np.float32)
    x = np.concatenate([f16, wide, bits, sub, special])
    return torch.from_numpy(x).to(device)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env():
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    from repro_torch.kernels import _build
    nvcc = run_text([_build.find_nvcc(), "--version"]).splitlines()[-2:]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda_runtime=torch.version.cuda, nvcc=" | ".join(nvcc),
         triton=triton_version, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())
    return smi


def phase_build():
    from repro_torch import kernels
    from repro_torch.kernels import fp8_dot as f8
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.quantize_em import kernel as qk
    from repro_torch.kernels.rwkv6 import kernel as wk
    t0 = time.perf_counter()
    builds = kernels.start_builds()   # one nvcc per library, all together
    paths = [b.wait() for b in builds]
    for m in (qk, fk, wk, f8):
        m._lib()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         libraries=[os.path.relpath(str(p)) for p in paths],
         sources=[qk.SOURCE, fk.SOURCE, wk.SOURCE, f8.SOURCE])


def phase_kernels(device):
    """Each kernel against its plain version on the card, bit for bit."""
    from repro_torch.core.formats import FPFormat
    from repro_torch.kernels.quantize_em import kernel as qk, ops, ref

    x32 = sweep_inputs(device)
    x32_cpu = x32.cpu()
    stats = {"quantize_em_static": dict(cases=0, mismatches=0, err=0.0),
             "quantize_em_dynamic": dict(cases=0, mismatches=0, err=0.0)}
    cross = dict(cases=0, mismatches=0)        # kernel 1 against kernel 2
    vs_cpu = dict(cases=0, mismatches=0)       # kernel against the CPU plain

    def hold(name, got, want):
        s = stats[name]
        s["cases"] += 1
        s["mismatches"] += bit_mismatches(got, want)
        s["err"] = max(s["err"], max_abs_err(got, want))

    def row_tensor(e, m, sat, inf, fault=0):
        return torch.tensor([e, m, sat, inf | (fault << 1)],
                            dtype=torch.int32, device=device)

    # ---- the rung grid on the full sweep, three storage types ------------
    for dt in STORAGE:
        x = x32.to(dt)
        xf = x.to(torch.float32)
        for e in RUNG_E:
            for m in RUNG_M:
                for sat in (0, 1):
                    for inf in (0, 1):
                        fmt = FPFormat(e, m, bool(sat), bool(inf))
                        row = row_tensor(e, m, sat, inf)
                        k1 = qk.quantize_em_static(x, fmt)
                        k2 = qk.quantize_em_dynamic(x, row)
                        p1 = ref.quantize_ref_fmt(xf, fmt).to(dt)
                        p2 = ops.quantize_dynamic(x, row, impl="ref")
                        hold("quantize_em_static", k1, p1)
                        hold("quantize_em_dynamic", k2, p2)
                        cross["cases"] += 1
                        cross["mismatches"] += bit_mismatches(k1, k2)
                        if dt == torch.float32:
                            c1 = ref.quantize_ref_fmt(x32_cpu, fmt).to(device)
                            vs_cpu["cases"] += 2
                            vs_cpu["mismatches"] += bit_mismatches(k1, c1)
                            vs_cpu["mismatches"] += bit_mismatches(k2, c1)

    # ---- fault channel, identity row, a row from the middle of a table ---
    ident = torch.tensor(ops.IDENTITY_ROW, device=device)
    for dt in STORAGE:
        x = x32.to(dt)
        hold("quantize_em_dynamic", qk.quantize_em_dynamic(x, ident), x)
        for fault in FAULT_BITS:
            for (e, m, sat, inf) in ((5, 7, 0, 1), (4, 3, 1, 0), (11, 52, 0, 1)):
                row = row_tensor(e, m, sat, inf, fault)
                hold("quantize_em_dynamic", qk.quantize_em_dynamic(x, row),
                     ops.quantize_dynamic(x, row, impl="ref"))
    table = torch.tensor(
        [[11, 52, 0, 1], [5, 2, 0, 1], [8, 3, 0, 1], [4, 3, 1, 0],
         [5, 7, 0, 1 | (24 << 1)], [8, 5, 0, 1], [2, 1, 0, 1]],
        dtype=torch.int32, device=device)
    for site in range(table.shape[0]):
        hold("quantize_em_dynamic", qk.quantize_em_dynamic(x32, table, site),
             ops.quantize_dynamic(x32, (table, site), impl="ref"))

    # ---- odd sizes, a misaligned view, a strided view, an empty tensor ---
    fmt, row = FPFormat(5, 7), row_tensor(5, 7, 0, 1)
    for dt in STORAGE:
        base = x32.to(dt)
        views = [base[:n] for n in (1, 3, 5, 7, 1023, 1025, 4099)]
        views += [base[1:], base[3:70001], base[::2], base[5::3],
                  base[:4096].reshape(64, 64).t(), base[:0]]
        for v in views:
            vf = v.to(torch.float32)
            hold("quantize_em_static", qk.quantize_em_static(v, fmt),
                 ref.quantize_ref_fmt(vf, fmt).to(dt))
            hold("quantize_em_dynamic", qk.quantize_em_dynamic(v, row),
                 ops.quantize_dynamic(v, row, impl="ref"))

    # ---- the public ops: shortcuts before the kernel, dispatch, raising --
    finite_or_inf = x32[~x32.isnan()]     # a convert pair drops NaN payloads
    for spec in ("e8m7", "e5m10"):
        a = ops.quantize(finite_or_inf, spec)             # convert pair
        b = ops.quantize_dynamic(
            finite_or_inf, torch.tensor(ops.format_row(spec), device=device))
        cross["cases"] += 1
        cross["mismatches"] += bit_mismatches(a, b)
    before = qk.quantize_em_static.launches
    check(ops.quantize(x32, "fp32") is x32, "identity shortcut")
    ops.quantize(x32, "e8m7")
    check(qk.quantize_em_static.launches == before, "shortcut reached kernel")
    ops.quantize(x32, "e5m7")
    check(qk.quantize_em_static.launches == before + 1, "e5m7 must launch")
    raised = False
    try:
        ops.quantize(x32_cpu, "e5m7", impl="cuda")
    except ValueError:
        raised = True
    check(raised, "impl='cuda' on a CPU tensor must raise")

    # the result keeps the input's strides (a permuted, dense view is
    # rounded in its own memory order; a view with gaps through a copy), as
    # the plain versions' results do
    fmt = FPFormat(5, 7)
    base = x32[:2 ** 16].reshape(16, 64, 64)
    layouts = {"permuted": base.permute(2, 0, 1),
               "transposed": base[0].t(), "strided": base[:, ::2]}
    layout_bad = {}
    for lname, v in layouts.items():
        for dt in (torch.float32, torch.bfloat16):
            xv = v.to(dt)
            want = ref.quantize_ref_fmt(xv.float(), fmt).to(dt)
            for name, got in (
                    ("quantize_em_static", qk.quantize_em_static(xv, fmt)),
                    ("quantize_em_dynamic", qk.quantize_em_dynamic(
                        xv, row_tensor(5, 7, 0, 1)))):
                hold(name, got, want)
                if got.stride() != torch.empty_like(xv).stride():
                    layout_bad[f"{name}/{lname}/{dt}"] = got.stride()
    check(not layout_bad, "quantizer results change the layout", layout_bad)

    torch.cuda.synchronize()
    emit("kernels", n_elements=int(x32.numel()),
         kernels=[dict(name=k, cases=v["cases"], mismatches=v["mismatches"],
                       max_abs_err=v["err"]) for k, v in stats.items()],
         static_vs_dynamic=cross, kernel_vs_cpu_plain=vs_cpu,
         tolerance="bit-exact (0 mismatching patterns; two NaNs in 16-bit "
                   "storage count as equal)",
         launches={k: w.launches for k, w in
                   (("quantize_em_static", qk.quantize_em_static),
                    ("quantize_em_dynamic", qk.quantize_em_dynamic))})
    bad = (sum(v["mismatches"] for v in stats.values())
           + cross["mismatches"] + vs_cpu["mismatches"])
    check(bad == 0, bad, "mismatching bit patterns")
    return {k: v["err"] for k, v in stats.items()}


# ---------------------------------------------------------------------------
# the fused-epilogue kernels: cases, rows, inputs
# ---------------------------------------------------------------------------

# tests/test_kernels.py FLASH_CASES: B, Hq, Hkv, S, D, window, causal, dtype
FLASH_CASES = [
    (2, 4, 2, 128, 32, None, True, torch.float32),
    (1, 8, 8, 64, 16, None, True, torch.float32),
    (2, 4, 1, 128, 32, 32, True, torch.float32),
    (1, 2, 2, 256, 64, None, False, torch.float32),
    (2, 6, 3, 128, 32, None, True, torch.bfloat16),
    (1, 4, 4, 128, 128, 64, True, torch.float32),
]
# tests/test_kernels.py test_wkv6_pallas_vs_ref: B, H, S, hd, chunk
WKV_CASES = [(2, 3, 64, 16, 16), (1, 2, 128, 32, 64), (2, 1, 32, 8, 32),
             (1, 4, 64, 64, 64)]
# tests/test_fused_epilogue.py ROWS: every ladder rung, both fp8 overflow
# conventions, a fault-armed row (bit 31) and the identity row
FUSED_ROWS = [
    ("e8m15", [8, 15, 0, 1]), ("e8m10", [8, 10, 0, 1]),
    ("e8m7", [8, 7, 0, 1]), ("e8m5", [8, 5, 0, 1]), ("e8m3", [8, 3, 0, 1]),
    ("e8m2", [8, 2, 0, 1]), ("e5m2", [5, 2, 0, 1]), ("e4m3s", [4, 3, 1, 0]),
    ("e4m3fn", [4, 3, 0, 0]), ("e4m3fn+fault31", [4, 3, 0, 64]),
    ("identity", [11, 52, 0, 1]),
]
WKV_PATH = dict(B=1, H=64, hd=64)          # rwkv6-7b: 64 heads of 64


def randn(g, shape, device, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


def flash_path_inputs(device, seq, dtype=torch.bfloat16):
    """q, k, v at the attention path's shape: h2o-danube-1.8b, 32 q heads,
    8 KV heads, head dim 80."""
    g = torch.Generator(device=device)
    g.manual_seed(1)
    return (randn(g, (1, 32, seq, 80), device, dtype),
            randn(g, (1, 8, seq, 80), device, dtype),
            randn(g, (1, 8, seq, 80), device, dtype))


def wkv_inputs(device, B, H, S, hd, seed=0, rkv_dtype=torch.bfloat16):
    """r, k, v (rkv_dtype) and the decay w (f32, in (0, 1)) as the rwkv6
    mix produces them: (B, S, H, hd) tensors seen as (B, H, S, hd) views,
    w = exp(-exp(w_log)); the bonus u (H, hd) and the state s0 f32."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def heads(t):
        return t.permute(0, 2, 1, 3)

    r, k, v = (heads(randn(g, (B, S, H, hd), device, rkv_dtype))
               for _ in range(3))
    w = heads(torch.exp(-torch.exp(randn(g, (B, S, H, hd), device,
                                         scale=0.5) - 0.5)))
    u = randn(g, (H, hd), device, scale=0.1)
    s0 = randn(g, (B, H, hd, hd), device, scale=0.1)
    return r, k, v, w, u, s0


def flash_pairs(S, window) -> int:
    """Unmasked (q, k) pairs of one causal head with a sliding window: what
    the work depends on."""
    i = np.arange(S, dtype=np.int64)
    return int((i + 1 - np.maximum(i - window + 1, 0)).sum())


def phase_fused_kernels(device, seq, wkv_seq):
    """The flash-attention and WKV6 kernels against their plain versions on
    the card, and their fused epilogues against the unfused kernel followed
    by quantize_em_dynamic, bit for bit."""
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    from repro_torch.kernels.quantize_em import kernel as qk
    from repro_torch.kernels.rwkv6 import ops as wops, ref as wref

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    # ---- flash: the reference's cases against the naive oracle -----------
    flash_cases = []
    for n, (B, Hq, Hkv, S, D, win, causal, dt) in enumerate(FLASH_CASES):
        r = np.random.RandomState(n)
        q, k, v = (t(r.randn(B, H, S, D), dt) for H in (Hq, Hkv, Hkv))
        o = fops.flash_attention(q, k, v, causal=causal, window=win,
                                 impl="cuda")
        want = fref.attention_ref(q, k, v, causal=causal, window=win)
        flash_cases.append(dict(
            case=[B, Hq, Hkv, S, D, win, causal, str(dt)],
            max_abs_err=max_abs_err(o, want),
            finite=bool(torch.isfinite(o).all()),
            tol=2e-2 if dt == torch.bfloat16 else 2e-5))

    # ---- flash bf16 on the tensor cores: the six cases as bf16 and two
    # ragged S (keys past S masked, rows past S not stored), against the
    # naive oracle at 2e-2 and against the f32-computed plain version within
    # 2 bf16 units of |want| (+1e-6). At S = seq - 1 the chunked plain
    # version cannot split S into chunks, so its reference is the S = seq
    # result cut to seq - 1 rows (causal: no earlier row sees the last key),
    # and the oracle, which holds (heads, S, S) f32 scores, runs on q heads
    # 0-3 and their KV head
    def hold_bf16(case, o, oracle, plain, heads=None):
        sub = o if heads is None else o[:, :heads]
        return dict(case=case, max_abs_err=max_abs_err(sub, oracle),
                    max_bf16_ulps=bf16_ulps(o, plain),
                    finite=bool(torch.isfinite(o).all()), tol=2e-2,
                    tol_bf16_ulps=2.0)

    flash_bf16 = []
    bf16_cases = [c[:-1] for c in FLASH_CASES] + [(1, 4, 1, 200, 64, 64, True)]
    for n, (B, Hq, Hkv, S, D, win, causal) in enumerate(bf16_cases):
        r = np.random.RandomState(n)
        q, k, v = (t(r.randn(B, H, S, D), torch.bfloat16)
                   for H in (Hq, Hkv, Hkv))
        o = fops.flash_attention(q, k, v, causal=causal, window=win,
                                 impl="cuda")
        flash_bf16.append(hold_bf16(
            [B, Hq, Hkv, S, D, win, causal], o,
            fref.attention_ref(q, k, v, causal=causal, window=win),
            fops.flash_attention(q, k, v, causal=causal, window=win,
                                 impl="ref")))
    q, k, v = flash_path_inputs(device, seq)
    cut = seq - 1
    qc, kc, vc = (x[:, :, :cut] for x in (q, k, v))
    o = fops.flash_attention(qc, kc, vc, window=4096, impl="cuda")
    plain = fops.flash_attention(q, k, v, window=4096, impl="ref")[:, :, :cut]
    flash_bf16.append(hold_bf16(
        [1, 32, 8, cut, 80, 4096, True], o,
        fref.attention_ref(qc[:, :4], kc[:, :1], vc[:, :1], window=4096),
        plain, heads=4))
    del q, k, v, qc, kc, vc, o, plain
    torch.cuda.empty_cache()

    # ---- flash at the path's shape against the chunked plain version -----
    # (the naive oracle would hold (32, S, S) f32 scores); bf16 as on the
    # path, and f32 to see the kernel's arithmetic without bf16 rounding.
    # Most rows attend to 4096 keys, so a typical |out| is ~0.03 and an
    # absolute bf16 limit would be loose: both sides compute in f32 and round
    # once to bf16, so the bf16 output is held within 2 bf16 units of |want|
    # (plus 1e-6), the f32 one within 2e-5. No atomics and a fixed order: a
    # second launch gives the same bits
    W = 4096
    flash_path = {}
    for dt, tol in ((torch.bfloat16, 2.0), (torch.float32, 2e-5)):
        q, k, v = flash_path_inputs(device, seq, dt)
        o = fops.flash_attention(q, k, v, window=W, impl="cuda")
        again = fops.flash_attention(q, k, v, window=W, impl="cuda")
        want = fops.flash_attention(q, k, v, window=W, impl="ref")
        err = max_abs_err(o, want)
        flash_path[str(dt)] = dict(
            max_abs_err=err, finite=bool(torch.isfinite(o).all()),
            max_abs_out=float(o.float().abs().max()),
            mean_abs_out=float(o.float().abs().mean()),
            rerun_mismatches=bit_mismatches(o, again),
            **(dict(max_bf16_ulps=bf16_ulps(o, want), tol_bf16_ulps=tol)
               if dt == torch.bfloat16 else dict(tol=tol)))
        del q, k, v, o, again, want
    torch.cuda.empty_cache()

    # ---- wkv6: the reference's cases ---------------------------------------
    wkv_cases = []
    for n, (B, H, S, hd, chunk) in enumerate(WKV_CASES):
        r = np.random.RandomState(100 + n)
        rr, kk, vv = (t(r.randn(B, H, S, hd)) for _ in range(3))
        w = t(1 / (1 + np.exp(-r.randn(B, H, S, hd))) * 0.98 + 0.01)
        u, s0 = t(r.randn(H, hd) * 0.1), t(r.randn(B, H, hd, hd) * 0.1)
        y, sT = wops.wkv6(rr, kk, vv, w, u, s0, chunk=chunk, impl="cuda")
        y2, sT2 = wref.wkv6_ref(rr, kk, vv, w, u, s0)
        wkv_cases.append(dict(case=[B, H, S, hd, chunk],
                              y_err=max_abs_err(y, y2),
                              sT_err=max_abs_err(sT, sT2),
                              sT_mismatches=bit_mismatches(sT, sT2),
                              tol=1e-4))

    # ---- wkv6 at the path's shape; chunk invariance ------------------------
    args = wkv_inputs(device, WKV_PATH["B"], WKV_PATH["H"], wkv_seq,
                      WKV_PATH["hd"])
    y, sT = wops.wkv6(*args, impl="cuda")
    y2, sT2 = wref.wkv6_ref(*args)
    y_max = float(y2.abs().max())
    # y_t is a 64-term sum over the head dimension, taken in another order
    # than the plain einsum (and with fmas); the state update is elementwise
    # and the same operations, so sT must agree bit for bit
    wkv_path = dict(shape=[WKV_PATH["B"], WKV_PATH["H"], wkv_seq,
                           WKV_PATH["hd"]],
                    y_err=max_abs_err(y, y2), max_abs_y=y_max,
                    tol=1e-4 * y_max, sT_mismatches=bit_mismatches(sT, sT2),
                    finite=bool(torch.isfinite(y).all()))
    chunk_bits = 0
    # 4096: more tokens than two stages hold, capped by the kernel
    for chunk in (16, 100, 200, 4096):
        yc, sc = wops.wkv6(*args, chunk=chunk, impl="cuda")
        chunk_bits += bit_mismatches(yc, y) + bit_mismatches(sc, sT)
    r = np.random.RandomState(7)
    wsmall = [t(r.randn(1, 2, 128, 16)) for _ in range(3)]
    wsmall += [t(1 / (1 + np.exp(-r.randn(1, 2, 128, 16)))),
               t(r.randn(2, 16) * 0.1), t(np.zeros((1, 2, 16, 16)))]
    base = wops.wkv6(*wsmall, chunk=16, impl="cuda")
    for chunk in (32, 128, 48):
        yc, sc = wops.wkv6(*wsmall, chunk=chunk, impl="cuda")
        chunk_bits += bit_mismatches(yc, base[0]) + bit_mismatches(sc, base[1])
    again = wops.wkv6(*args, impl="cuda")
    wkv_path["rerun_mismatches"] = bit_mismatches(again[0], y) \
        + bit_mismatches(again[1], sT)
    del y, sT, y2, sT2, again

    # ---- wkv6: B = 2 with S not a multiple of chunk at hd = 32, and views
    # the kernel's 16-byte loads cannot take (an odd offset into a wider
    # tensor: the wrapper copies them) against the same values contiguous
    r = np.random.RandomState(8)
    B, H, S, hd = 2, 3, 203, 32
    ragged = [t(r.randn(B, H, S, hd)) for _ in range(3)]
    ragged += [t(1 / (1 + np.exp(-r.randn(B, H, S, hd))) * 0.98 + 0.01),
               t(r.randn(H, hd) * 0.1), t(r.randn(B, H, hd, hd) * 0.1)]
    y, sT = wops.wkv6(*ragged, chunk=64, impl="cuda")
    y2, sT2 = wref.wkv6_ref(*ragged)
    wkv_cases.append(dict(case=[B, H, S, hd, 64], y_err=max_abs_err(y, y2),
                          sT_err=max_abs_err(sT, sT2),
                          sT_mismatches=bit_mismatches(sT, sT2), tol=1e-4))
    wide = [torch.zeros(B, H, S, hd + 1, device=device, dtype=x.dtype)
            for x in ragged[:4]]
    views = []
    for x, big in zip(ragged[:4], wide):
        big[..., 1:] = x
        views.append(big[..., 1:])
    yv, sTv = wops.wkv6(*views, *ragged[4:], chunk=64, impl="cuda")
    wkv_unaligned = dict(case=[B, H, S, hd, 64], offset_bytes=4,
                         y_mismatches=bit_mismatches(yv, y),
                         sT_mismatches=bit_mismatches(sTv, sT))
    del y, sT, y2, sT2, yv, sTv, wide, views

    # ---- fused epilogue == unfused kernel + quantize_em_dynamic ------------
    r = np.random.RandomState(0)
    small = tuple(t(r.randn(1, 2, 128, 32) * 4) for _ in range(3))
    flash_progs = {
        "flash_f32": small + (None,),
        "flash_bf16": tuple(x.to(torch.bfloat16) for x in small) + (None,),
        "flash_path_bf16": flash_path_inputs(device, seq) + (W,),
    }
    fused = {k: 0 for k in list(flash_progs) + ["wkv6_small_y", "wkv6_path_y",
                                                 "wkv6_sT_touched"]}
    for _, row in FUSED_ROWS:
        row = torch.tensor(row, dtype=torch.int32, device=device)
        for name, (q, k, v, win) in flash_progs.items():
            got = fops.flash_attention(q, k, v, window=win, impl="cuda",
                                       out_fmt=row)
            plain = fops.flash_attention(q, k, v, window=win, impl="cuda")
            fused[name] += bit_mismatches(got, qk.quantize_em_dynamic(plain,
                                                                      row))
        for name, wargs, chunk in (("wkv6_small_y", wsmall, 32),
                                   ("wkv6_path_y", args, 64)):
            yf, sTf = wops.wkv6(*wargs, chunk=chunk, impl="cuda", out_fmt=row)
            yp, sTp = wops.wkv6(*wargs, chunk=chunk, impl="cuda")
            fused[name] += bit_mismatches(yf, qk.quantize_em_dynamic(yp, row))
            fused["wkv6_sT_touched"] += bit_mismatches(sTf, sTp)
    torch.cuda.synchronize()

    emit("fused_kernels", flash_cases=flash_cases, flash_bf16=flash_bf16,
         flash_path=flash_path,
         wkv6_cases=wkv_cases, wkv6_path=wkv_path,
         wkv6_unaligned=wkv_unaligned, wkv6_chunk_mismatches=chunk_bits,
         fused_rows=[n for n, _ in FUSED_ROWS], fused_mismatches=fused,
         tolerance="flash 2e-5 f32 / 2e-2 bf16 (max abs) on the reference "
                   "cases, 2e-5 f32 / 2 bf16 units of |want| + 1e-6 at the "
                   "path shape; the bf16 cases and ragged S 2e-2 against "
                   "the oracle and 2 bf16 units of |want| + 1e-6 against the "
                   "plain version; two launches bit-equal; wkv6 1e-4 on the "
                   "reference cases, 1e-4 * max|y| at the path shape; sT, "
                   "chunk invariance and fused vs unfused bit for bit")
    for c in flash_cases:
        check(c["finite"] and c["max_abs_err"] < c["tol"], "flash", c)
    for c in flash_bf16:
        check(c["finite"] and c["max_abs_err"] < c["tol"]
              and c["max_bf16_ulps"] <= c["tol_bf16_ulps"], "flash bf16", c)
    for k, c in flash_path.items():
        check(c["finite"] and (c["max_bf16_ulps"] <= c["tol_bf16_ulps"]
                               if "tol_bf16_ulps" in c
                               else c["max_abs_err"] < c["tol"]),
              "flash path", k, c)
        check(c["rerun_mismatches"] == 0, "flash path determinism", k, c)
    for c in wkv_cases:
        check(c["y_err"] < c["tol"] and c["sT_mismatches"] == 0, "wkv6", c)
    check(wkv_path["finite"] and wkv_path["y_err"] <= wkv_path["tol"]
          and wkv_path["sT_mismatches"] == 0, "wkv6 path", wkv_path)
    check(wkv_path["rerun_mismatches"] == 0, "wkv6 determinism", wkv_path)
    check(wkv_unaligned["y_mismatches"] == 0
          and wkv_unaligned["sT_mismatches"] == 0, "wkv6 views",
          wkv_unaligned)
    check(chunk_bits == 0, "wkv6 chunk invariance", chunk_bits)
    check(sum(fused.values()) == 0, "fused vs unfused", fused)
    return {"flash_attention": flash_path[str(torch.bfloat16)]["max_abs_err"],
            "wkv6": wkv_path["y_err"]}


MESH_LADDER = (15, 10, 7, 5, 3, 2)   # e8m<m> rungs of the sharded sweeps
MESH_TWO_LAYERS = 2                  # the two-rank check: full width, depth 2
MESH_TWO_SEQ = 2048


def mesh_rank(rank, world, store, out, seq):
    """One of the two ranks of ``mesh_path``'s check, both on the one card
    (``cuda:0``): NCCL refuses two ranks on one device, so the group is
    gloo, which the port's collectives feed from host copies. Writes
    ``rank<r>.json``."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import (TruncationPolicy, memtrace,
                                  profile_trajectory, truncate_sweep)
    from repro_torch.core.memmode import RaptorReport
    from repro_torch.launch.mesh import make_probe_mesh, make_profile_mesh
    from repro_torch.models import Model
    from repro_torch.profile.trajectory import TrajectoryReport

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        device = torch.device("cuda")
        cfg = get_config("h2o-danube-1.8b").replace(n_layers=MESH_TWO_LAYERS)
        model = Model(cfg)
        params = model.init(seed=0)
        batch = make_batch(cfg, world, seq, device)
        site = TruncationPolicy.everywhere("e5m2")
        ladder = [TruncationPolicy.everywhere(f"e8m{m}")
                  for m in MESH_LADDER[:5]]
        res = {}
        with torch.no_grad():
            pmesh = make_probe_mesh(device="cpu")
            h0 = truncate_sweep(model.loss, site)(params, batch)
            h1 = truncate_sweep(model.loss, site, mesh=pmesh)(params, batch)
            t5 = h0.tables(ladder)
            one, two = h0.batch(t5), h1.batch(t5)
            res["sweep_k5_bit_equal"] = equal_bits(one, two)
            res["sweep_k5_shape"] = list(two.shape)

            # a per-example program (the logits: no reduction over the
            # batch) on this rank's row
            dmesh = make_profile_mesh(1, world, device="cpu")
            mine = {k: v[rank:rank + 1] for k, v in batch.items()}
            _, rep = memtrace(model.forward, site)(params, mine)
            red = rep.allreduce("data", dmesh)
            _, traj = profile_trajectory(model.forward, site,
                                         n_steps=cfg.n_layers + 1)(
                params, mine)
            tred = traj.allreduce("data", dmesh)
            torch.cuda.synchronize()

        def host(r):
            return [torch.as_tensor(x).cpu() for x in
                    (r.flags, r.max_rel, r.op_counts)]

        def thost(t):
            return [torch.as_tensor(getattr(t, k)).cpu() for k in
                    ("max_rel", "abs_sum", "mag_sum", "op_counts",
                     "steps_seen")] + host(t.totals)

        reps, trajs = [None] * world, [None] * world
        dist.all_gather_object(reps, (rep.locations, host(rep)))
        dist.all_gather_object(trajs, thost(traj))
        merged = RaptorReport.merge_all([RaptorReport(loc, *h)
                                         for loc, h in reps])
        res["allreduce_equals_merge_all"] = all(
            torch.equal(a, b) for a, b in zip(host(red), host(merged)))
        res["flags"] = int(merged.flags.sum())
        res["n_locations"] = len(merged.locations)
        tm = TrajectoryReport.merge_all([
            TrajectoryReport(
                totals=RaptorReport(traj.totals.locations, *h[5:]),
                scopes=traj.scopes, max_rel=h[0], abs_sum=h[1],
                mag_sum=h[2], op_counts=h[3], steps_seen=h[4],
                columns=traj.columns) for h in trajs])
        got, want = thost(tred), thost(tm)
        exact = [0, 3, 4, 5, 6, 7]          # maxima, counts, step counter
        res["traj_allreduce_equals_merge_all"] = all(
            torch.equal(got[i], want[i]) for i in exact) and all(
            torch.allclose(got[i], want[i], rtol=1e-6, atol=0)
            for i in (1, 2))
        res["steps_seen"] = int(want[4])
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_mesh_path(device, layers, seq):
    """Distribution on the card: a DeviceMesh of one rank (NCCL, ``cuda:0``)
    over h2o-danube-1.8b at full width, depth ``layers`` (the search
    path's), 1 x ``seq`` tokens. ``truncate_sweep(mesh=)`` of the MLP's
    sites on a 6-rung and a 5-rung ladder held bit for bit to the unsharded
    handle, its dynamic quantizer's launches = rows x site executions;
    ``memtrace(mesh=,
    in_shardings=batch_sharding)`` of a DTensor batch held bit for bit to
    the plain report; ``autosearch(mesh=)`` held to the search path's
    unsharded result of this run (or to its own when that phase did not
    run). Beside it, started first and joined last, two ranks on the same
    card (gloo) at 2 layers: a probe axis of two with K = 5 padded, bit for
    bit the one-rank rows; ``RaptorReport`` / ``TrajectoryReport.allreduce``
    of a per-example program equal to ``merge_all`` of the ranks'
    reports."""
    import tempfile
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import TruncationPolicy, memtrace, truncate_sweep
    from repro_torch.distributed.sharding import batch_sharding, place
    from repro_torch.launch.mesh import make_probe_mesh, make_profile_mesh
    from repro_torch.models import Model
    from repro_torch.search import autosearch, loss_degradation

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mesh_path_")
    world = 2
    two = mp.start_processes(mesh_rank, args=(
        world, os.path.join(tmp, "store"), tmp, MESH_TWO_SEQ),
        nprocs=world, join=False, start_method="spawn")
    try:
        cfg = get_config("h2o-danube-1.8b").replace(n_layers=layers)
        model = Model(cfg)
        params = model.init(seed=0)
        batch = make_batch(cfg, 1, seq, device)
        # the MLP's sites: a row costs about a plain forward
        site = TruncationPolicy.scoped("layer/mlp", "e5m2")
        ladder = [TruncationPolicy.everywhere(f"e8m{m}")
                  for m in MESH_LADDER]
        started = not dist.is_initialized()
        pmesh = make_probe_mesh()                  # NCCL, one rank
        dmesh = make_profile_mesh(1, 1)
        backend = dist.get_backend()
        torch.cuda.synchronize()

        kernels.reset_launch_counts()              # the mesh path starts here
        with torch.no_grad():
            h0 = truncate_sweep(model.loss, site)(params, batch)
            t6 = h0.tables(ladder)
            want6 = h0.batch(t6)
            h1 = truncate_sweep(model.loss, site, mesh=pmesh)(params, batch)
            (got6, got5), sweep_launches = launches_of(
                lambda: (h1.batch(t6), h1.batch(t6[:5])))
        check(equal_bits(got6, want6) and equal_bits(got5, want6[:5])
              and tuple(got5.shape) == (5,), "mesh sweep", got6, want6)
        rows = 6 + 5
        check(sweep_launches["quantize_em_dynamic"]
              == rows * h1.site_executions, "mesh sweep launches",
              sweep_launches, rows, h1.site_executions)

        pol = TruncationPolicy.scoped("**/mlp", "e5m7")
        sharded = place(batch["tokens"], batch_sharding(dmesh))
        check(type(sharded).__name__ == "DTensor", type(sharded))
        with torch.no_grad():
            out0, rep0 = memtrace(model.loss, pol)(params, batch)
            out1, rep1 = memtrace(
                model.loss, pol, mesh=dmesh,
                in_shardings=[None, batch_sharding(dmesh)])(
                params, dict(batch, tokens=sharded))
        check(equal_bits(out0, out1) and rep0.locations == rep1.locations
              and all(equal_bits(getattr(rep0, k), getattr(rep1, k))
                      for k in ("flags", "max_rel", "op_counts")),
              "mesh memtrace")

        base = SEARCH_RESULT.get("res")
        own = base is None
        if own:
            base = autosearch(model.loss, (params, batch), loss_degradation,
                              SEARCH_BUDGET, threshold=SEARCH_THRESHOLD)
        t_search = time.perf_counter()
        res = autosearch(model.loss, (params, batch), loss_degradation,
                         SEARCH_BUDGET, threshold=SEARCH_THRESHOLD,
                         mesh=pmesh)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t_search
        counts = kernels.launch_counts()           # ... and ends here
        check(assigns_of(res) == assigns_of(base)
              and res.evals_used == base.evals_used
              and res.n_dispatches == base.n_dispatches
              and res.final_error == base.final_error
              and res.n_devices == 1, "mesh autosearch", res.table(),
              base.table())
        one_rank_s = time.perf_counter() - t0
    finally:
        while not two.join():
            pass
        if "started" in locals() and started and dist.is_initialized():
            dist.destroy_process_group()
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    for r in ranks:
        check(r["sweep_k5_bit_equal"] and r["sweep_k5_shape"] == [5]
              and r["allreduce_equals_merge_all"]
              and r["traj_allreduce_equals_merge_all"]
              and r["steps_seen"] == MESH_TWO_LAYERS, "two ranks", ranks)
    emit("mesh_path", model=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, batch=[1, seq], world=1, backend=backend,
         ladders=[6, 5], site_executions=h1.site_executions,
         sweep_launches=sweep_launches["quantize_em_dynamic"],
         memtrace_locations=len(rep1.locations),
         memtrace_flags=int(rep1.flags.sum()),
         search_against="own" if own else "search_path",
         evals_used=res.evals_used, n_dispatches=res.n_dispatches,
         n_devices=res.n_devices, search_s=search_s,
         one_rank_s=one_rank_s, launches=counts,
         two_ranks=dict(world=world, backend="gloo", device="cuda:0",
                        n_layers=MESH_TWO_LAYERS, batch=[world, MESH_TWO_SEQ],
                        ranks=ranks),
         seconds=time.perf_counter() - t0)
    del params
    torch.cuda.empty_cache()
    return counts



def timed(fn, reps=3):
    """Median wall time (ms) of ``reps`` calls, each between two device
    synchronisations."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def sync_free(fn):
    """``fn()`` with any host synchronisation on the card an error."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def launches_of(fn):
    """``fn()`` and the kernel launches it made, by kernel."""
    from repro_torch import kernels
    before = kernels.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    return out, {k: after[k] - before[k] for k in after}


def assigns_of(res):
    return {p: (a.man_bits, a.excluded) for p, a in res.assignments.items()}


def make_batch(cfg, B, S, device, seed=0):
    r = np.random.RandomState(seed)
    toks = r.randint(0, cfg.vocab, (B, S + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1]).to(device, torch.int32),
            "labels": torch.from_numpy(toks[:, 1:]).to(device, torch.int32)}


def phase_main_path(device, layers, seq):
    """truncate and truncate_sweep of the full-width model, through the
    entry points a user calls."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import TruncationPolicy, truncate, truncate_sweep
    from repro_torch.models import Model

    cfg = get_config("h2o-danube-1.8b")
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    model = Model(cfg)
    params = model.init(seed=0)                 # on the card by default
    batch = make_batch(cfg, 1, seq, device)
    check(params["embed"].is_cuda, "Model.init() must default to the card")
    torch.cuda.synchronize()

    scoped = TruncationPolicy.scoped("layer/mlp", "e5m7")
    ladder = [("identity", None)] + [
        (f, TruncationPolicy.everywhere(f))
        for f in ("e8m10", "e8m7", "e8m5", "e8m3")] + [("scoped_e5m7", scoped)]

    with torch.no_grad():
        kernels.reset_launch_counts()           # the main path starts here
        plain = model.loss(params, batch)
        lossy = truncate(model.loss, scoped)
        t_scoped = lossy(params, batch)
        sweep = truncate_sweep(model.loss, TruncationPolicy.everywhere("e5m2"))
        handle = sweep(params, batch)
        tables = [handle.device_table(handle.identity_table() if p is None
                                      else handle.table(p))
                  for _, p in ladder]
        torch.cuda.synchronize()
        # the swept forwards must not synchronise with the host anywhere
        torch.cuda.set_sync_debug_mode("error")
        swept = [sweep(params, batch)(t) for t in tables]
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = kernels.launch_counts()        # ... and ends here

    losses = {"plain": float(plain), "truncate_scoped_e5m7": float(t_scoped)}
    losses.update({f"table_{n}": float(v) for (n, _), v in zip(ladder, swept)})
    tables_run = len(tables)
    emit("main_path", model=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
         head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab,
         window=cfg.sliding_window, dtype=cfg.dtype, batch=[1, seq],
         n_params=model.n_params(), num_sites=handle.num_sites,
         site_executions_per_forward=handle.site_executions,
         tables_run=tables_run, n_traces=sweep.n_traces,
         truncate_n_traces=lossy.n_traces, losses=losses, launches=counts,
         peak_memory_gb=round(torch.cuda.max_memory_allocated() / 2**30, 2))

    check(all(np.isfinite(v) for v in losses.values()), losses)
    check(plain.dtype == torch.float32 and plain.shape == (), plain.shape)

    check(same_bits(swept[0], plain), "identity table changed the loss")
    check(same_bits(swept[-1], t_scoped),
          "scoped truncate differs from the same policy's table")
    check(sweep.n_traces == 1 and sweep.cache_size() == 1, sweep.n_traces)
    check(lossy.n_traces == 1, lossy.n_traces)
    check(counts["quantize_em_static"] > 0, counts)
    check(counts["quantize_em_dynamic"]
          == handle.site_executions * tables_run,
          counts, handle.site_executions, tables_run)
    check(losses["table_e8m3"] != losses["plain"], "truncation had no effect")

    times = {}
    with torch.no_grad():
        times["forward_plain_ms"] = timed(lambda: model.loss(params, batch))
        times["forward_truncate_scoped_e5m7_ms"] = timed(
            lambda: lossy(params, batch))
        # two calls a table: six tables at full depth are the phase's bulk
        for (n, _), t in zip(ladder, tables):
            times[f"forward_table_{n}_ms"] = timed(lambda: handle(t), reps=2)
    del params
    torch.cuda.empty_cache()
    return counts, times


# the mem path's depth unless --layers is given: every float result under
# memtrace at full depth (24 layers, ~12 s a call, nine calls) would put the
# default run past 600 s since the serve path came, 12 layers since the
# statically pruned searches came, and 8 since the grad profile path came; a
# score location still passes 2^31 elements at 2 layers
MEM_LAYERS = 2


def phase_mem_path(device, layers, seq):
    """Mem-mode: ``memtrace(model.loss, ·)`` of the full-width model under
    three policies, held to op-mode on the same inputs, and the counters."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import (TruncationPolicy, TruncationRule, memtrace,
                                  parse_format, profile_counts, truncate,
                                  truncate_sweep)
    from repro_torch.core.memmode import NO_LOCATIONS
    from repro_torch.kernels.quantize_em.ref import quantize_ref_fmt
    from repro_torch.models import Model

    cfg = get_config("h2o-danube-1.8b")
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    model = Model(cfg)
    params = model.init(seed=0)
    batch = make_batch(cfg, 1, seq, device)
    policies = {"scoped_e5m7": TruncationPolicy.scoped("layer/mlp", "e5m7"),
                "everywhere_e8m7": TruncationPolicy.everywhere("e8m7"),
                "everywhere_e8m3": TruncationPolicy.everywhere("e8m3")}
    torch.cuda.synchronize()

    # the shadow-lane check: layer/mlp rounded onto e5m7 and the logits
    # product onto e8m3. At the logits site the truncated lane is op-mode's
    # logits under the scoped policy, rounded, and the shadow lane is the
    # plain forward's: its flags and max_rel, computed here in plain tensor
    # code, must be what memtrace reports
    shadow_policy = TruncationPolicy(rules=(
        TruncationRule("e5m7", scope="layer/mlp"),
        TruncationRule("e8m3", scope="logits", ops=("dot_general",))))
    threshold = 1e-3                    # memtrace's default

    info, losses, reports, wrappers = {}, {}, {}, {}
    with torch.no_grad():
        plain = model.loss(params, batch)
        # op-mode under the same policies, and the swept e8m7 table
        opmode = {n: launches_of(lambda: truncate(model.loss, p)(params,
                                                                  batch))
                  for n, p in policies.items()}
        handle = truncate_sweep(model.loss, TruncationPolicy.everywhere(
            "e5m2"))(params, batch)
        table = handle.device_table(handle.table(policies["everywhere_e8m7"]))
        torch.cuda.synchronize()
        swept_e8m7 = sync_free(lambda: handle(table))
        shadow_truncate_loss = truncate(model.loss, shadow_policy)(params,
                                                                   batch)
        sh = model.forward(params, batch)
        low = quantize_ref_fmt(truncate(model.forward, policies[
            "scoped_e5m7"])(params, batch), parse_format("e8m3"))
        dev = ((low - sh).abs()
               / torch.maximum(torch.maximum(sh.abs(), low.abs()),
                               torch.tensor(1e-6, device=device)))
        dev = torch.where(low == sh, 0.0, dev)
        dev = torch.where(dev.isnan(), math.inf, dev)
        want_logits = dict(flags=int((dev > threshold).sum()),
                           max_rel=float(dev.amax()), op_counts=sh.numel())
        del sh, low, dev
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        kernels.reset_launch_counts()           # the mem path starts here
        walls = {}
        for name, pol in policies.items():
            mt = wrappers[name] = memtrace(model.loss, pol)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (losses[name], reports[name]), counts = launches_of(
                lambda: sync_free(lambda: mt(params, batch)))
            # the first call (the one that walks the policy) and two more
            walls[name] = [(time.perf_counter() - t0) * 1e3]
            walls[name] += [timed(lambda: sync_free(lambda: mt(params, batch)),
                                  reps=1) for _ in range(2)]
            rep = reports[name]
            info[name] = dict(
                loss=float(losses[name]),
                truncate_loss=float(opmode[name][0]),
                bit_equal_to_truncate=same_bits(losses[name],
                                                opmode[name][0]),
                launches=counts, truncate_launches=opmode[name][1],
                peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
                report_on_card=all(t.is_cuda for t in (
                    rep.flags, rep.max_rel, rep.op_counts)),
                n_locations=len(rep.locations))
        info["everywhere_e8m7"]["bit_equal_to_table_e8m7"] = same_bits(
            losses["everywhere_e8m7"], swept_e8m7)
        shadow_loss, shadow_rep = sync_free(
            lambda: memtrace(model.loss, shadow_policy)(params, batch))
        empty = memtrace(model.loss, TruncationPolicy(()))
        (loss0, rep0), counts0 = launches_of(
            lambda: sync_free(lambda: empty(params, batch)))
        torch.cuda.synchronize()
        path_counts = kernels.launch_counts()   # ... and ends here

        # the counters: one untruncated run, no quantizer
        counter = profile_counts(model.loss, policies["scoped_e5m7"])
        counted, count_launches = launches_of(lambda: counter(params, batch))
        counter(params, batch)

        times = {"forward_plain_ms": timed(lambda: model.loss(params, batch))}
        for name, w in walls.items():
            times[f"memtrace_{name}_ms"] = statistics.median(w)
            times[f"overhead_{name}"] = (times[f"memtrace_{name}_ms"]
                                         / times["forward_plain_ms"])

    # ---- the reports -------------------------------------------------------
    for name, rep in reports.items():
        flags, max_rel = rep.flags.cpu(), rep.max_rel.cpu()
        counts = rep.op_counts.cpu()
        info[name].update(
            total_flags=int(flags.sum()), total_op_counts=int(counts.sum()),
            max_op_counts=int(counts.max()),
            max_op_counts_location=rep.locations[int(counts.argmax())],
            max_rel_bounded=bool(((max_rel <= 2) | max_rel.isinf()).all()),
            n_traces=wrappers[name].n_traces,
            top10=[[loc, f, m] for loc, f, m in rep.top(10)])
    # op_counts by hand for the scoped policy: its five MLP sites in program
    # order (the gate/up product, sigmoid, x * sigmoid, silu * up, the down
    # product), each on every layer
    scoped = reports["scoped_e5m7"]
    n = seq * cfg.d_ff
    want_counts = [e * cfg.n_layers for e in (2 * n, n, n, n,
                                              seq * cfg.d_model)]
    info["scoped_e5m7"]["op_counts"] = scoped.op_counts.tolist()
    info["scoped_e5m7"]["op_counts_by_hand"] = want_counts
    e7, e3 = reports["everywhere_e8m7"], reports["everywhere_e8m3"]
    at = [i for i, loc in enumerate(shadow_rep.locations)
          if loc.startswith("logits dot_general @ ")]
    shadow_check = dict(
        want=want_logits, locations=len(shadow_rep.locations),
        logits_location=[shadow_rep.locations[i] for i in at],
        got=dict(flags=int(shadow_rep.flags[at[0]]),
                 max_rel=float(shadow_rep.max_rel[at[0]]),
                 op_counts=int(shadow_rep.op_counts[at[0]])) if at else None,
        loss_bit_equal_to_truncate=same_bits(shadow_loss,
                                             shadow_truncate_loss))
    counts_report = dict(
        total_gflop=counted.total_flops / 1e9,
        total_gb=sum(counted.bytes_by_fmt.values()) / 1e9,
        gflop_by_fmt={k: v / 1e9 for k, v in counted.flops_by_fmt.items()},
        truncated_fraction=counted.truncated_fraction,
        n_traces=counter.n_traces, launches=count_launches)
    emit("mem_path", model=cfg.name, n_layers=cfg.n_layers, batch=[1, seq],
         dtype=cfg.dtype, policies=info, plain_loss=float(plain),
         empty_policy=dict(loss=float(loss0), locations=list(rep0.locations),
                           flags=rep0.flags.tolist(), launches=counts0),
         shadow_check=shadow_check, profile_counts=counts_report,
         launches=path_counts, **times)

    for name, i in info.items():
        check(i["bit_equal_to_truncate"], name, "memtrace != truncate", i)
        check(i["launches"]["quantize_em_static"]
              == i["truncate_launches"]["quantize_em_static"], name, i)
        check(i["launches"]["quantize_em_dynamic"] == 0, name, i)
        check(i["report_on_card"] and i["max_rel_bounded"], name, i)
        check(i["n_traces"] == 1, name, "n_traces", i)
        check(np.isfinite(i["loss"]), name, i)
    check(info["everywhere_e8m7"]["bit_equal_to_table_e8m7"],
          "memtrace e8m7 != the swept e8m7 table")
    check(info["scoped_e5m7"]["launches"]["quantize_em_static"]
          == 5 * cfg.n_layers, info["scoped_e5m7"])
    check(info["scoped_e5m7"]["op_counts"] == want_counts,
          info["scoped_e5m7"])
    check(info["everywhere_e8m3"]["total_flags"]
          > info["everywhere_e8m7"]["total_flags"], "e8m3 flags <= e8m7")
    check(e7.locations == e3.locations
          and torch.equal(e7.op_counts, e3.op_counts), "e8m7 vs e8m3 sites")
    if seq == 8192:         # 1.6e9 elements a layer at the scores' sites
        check(info["everywhere_e8m3"]["max_op_counts"] > 2**31,
              "no location passed 2^31 elements", info["everywhere_e8m3"])
    check(same_bits(loss0, plain) and rep0.locations == (NO_LOCATIONS,)
          and rep0.flags.tolist() == [0], "empty policy", rep0)
    check(counter.n_traces == 1 and sum(count_launches.values()) == 0,
          counts_report)
    check(len(at) == 1 and shadow_check["got"] == want_logits
          and shadow_check["loss_bit_equal_to_truncate"],
          "the logits location differs from the plain computation",
          shadow_check)
    check(path_counts["quantize_em_static"] > 0
          and path_counts["quantize_em_dynamic"] == 0, path_counts)
    return path_counts


# --------------------------------------------------------------------------
# the models path: every family's forward through the quantizer kernels
# --------------------------------------------------------------------------

MODELS_SEQ = 4096          # olmoe-1b-7b's context length
# olmoe-1b-7b's default depth, for the default run's 600 s budget;
# --layers 16 runs it whole
MODELS_LAYERS = 8
FAMILY_SEQ = 2048
# every other family at full width, depth cut (each cut listed), with the
# block it is profiled by
FAMILY_CUTS = [
    ("glm4-9b", dict(n_layers=2), ("layer/attn/qkv",)),
    ("deepseek-coder-33b", dict(n_layers=2), ("layer/attn/qkv",)),
    ("internlm2-20b", dict(n_layers=2), ("layer/attn/qkv",)),
    ("qwen2-vl-7b", dict(n_layers=2), ("layer/attn/qkv",)),
    # one dense lead layer and one MoE layer of 160 experts
    ("deepseek-v2-236b", dict(n_layers=2),
     ("layer/attn/mla_mix", "layer/moe/experts")),
    ("hymba-1.5b", dict(n_layers=3, global_layers=(0, 2)), ("layer/mamba",)),
    ("rwkv6-7b", dict(n_layers=2), ("layer/time_mix",)),
    ("seamless-m4t-large-v2", dict(n_layers=2, enc_layers=2),
     ("dec_layer/cross_attn",)),
]


def family_batch(cfg, B, S, device, seed=0):
    """A batch for any family: tokens, or stub-frontend embeddings — frames
    for the encoder-decoder, patches with three different M-RoPE position
    streams (time, row, column of a 32-wide grid) for the VLM."""
    r = np.random.RandomState(seed)
    toks = r.randint(0, cfg.vocab, (B, S + 1))
    nb = {"labels": toks[:, 1:].astype(np.int32)}
    if cfg.family == "encdec":
        nb["src_embeds"] = r.randn(B, S, cfg.d_model).astype(np.float32)
        nb["tokens"] = toks[:, :-1].astype(np.int32)
    elif cfg.input_mode == "embeds":
        nb["embeds"] = r.randn(B, S, cfg.d_model).astype(np.float32)
        s = np.arange(S)
        nb["positions"] = np.stack([np.broadcast_to(v, (B, S)) for v in (
            s // 256, s // 32 % 8, s % 32)]).astype(np.int32)
    else:
        nb["tokens"] = toks[:, :-1].astype(np.int32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in nb.items()}


def scoped_policy(scopes, fmt):
    from repro_torch.core import TruncationPolicy, TruncationRule
    return TruncationPolicy(rules=tuple(TruncationRule(fmt, scope=s)
                                        for s in scopes))


def matched_executions(fn, policy, args):
    """Executions of the sites ``policy`` matches in one run of ``fn``
    (an enumeration: it launches no quantizer)."""
    from repro_torch.core import truncate_sweep
    return truncate_sweep(fn, policy)(*args).site_executions


def phase_models_path(device, layers):
    """Every model family's forward through ``truncate``, ``truncate_sweep``
    and ``memtrace``: olmoe-1b-7b at full width, depth cut to
    ``MODELS_LAYERS`` (``--layers`` sets it; 16 is full depth), then each
    other family at full width with its depth cut. Each
    ``truncate`` loss is held bit for bit to the same call with
    ``impl='ref'`` (kernel against plain version), ``memtrace``'s to
    ``truncate``'s, the static kernel's launches to the matched site
    executions, the dynamic kernel's to the swept site executions; no call
    synchronises with the host."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import (TruncationPolicy, memtrace, truncate,
                                  truncate_sweep)
    from repro_torch.models import Model
    from repro_torch.models.moe import capacity_of

    seq = MODELS_SEQ
    cfg = get_config("olmoe-1b-7b").replace(n_layers=layers or MODELS_LAYERS)
    model = Model(cfg)
    params = model.init(seed=0)
    batch = family_batch(cfg, 1, seq, device)
    policies = {"experts_e5m7": TruncationPolicy.scoped("layer/moe/experts",
                                                        "e5m7"),
                "router_e8m3": TruncationPolicy.scoped("layer/moe/router",
                                                       "e8m3")}
    table_fmts = ("e8m7", "e5m7", "e8m3")
    torch.cuda.synchronize()

    info, losses = {}, {}
    with torch.no_grad():
        plain = model.loss(params, batch)
        want_static = {n: matched_executions(model.loss, p, (params, batch))
                       for n, p in policies.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()           # the models path starts here
        wrappers = {}
        for name, pol in policies.items():
            w = wrappers[name] = truncate(model.loss, pol)
            losses[name], launched = launches_of(
                lambda: sync_free(lambda: w(params, batch)))
            # the plain version builds its constants from the host
            ref = truncate(model.loss, pol, impl="ref")(params, batch)
            info[name] = dict(loss=float(losses[name]), ref_loss=float(ref),
                              bit_equal_to_ref=same_bits(losses[name], ref),
                              static_launches=launched["quantize_em_static"],
                              matched_site_executions=want_static[name],
                              n_traces=w.n_traces)
        sweep = truncate_sweep(model.loss, TruncationPolicy.everywhere("e5m2"))
        handle = sweep(params, batch)
        tables = {f: handle.device_table(handle.table(
            TruncationPolicy.everywhere(f))) for f in table_fmts}
        torch.cuda.synchronize()
        swept, swept_launches = {}, {}
        for f, t in tables.items():
            swept[f], c = launches_of(lambda: sync_free(lambda: handle(t)))
            swept_launches[f] = c["quantize_em_dynamic"]
        mt = memtrace(model.loss, policies["router_e8m3"])
        (m_loss, m_rep), m_counts = launches_of(
            lambda: sync_free(lambda: mt(params, batch)))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()        # ... and ends here
        peak_gb = torch.cuda.max_memory_allocated() / 2**30

        times = {"forward_plain_ms": timed(lambda: model.loss(params, batch))}
        for name, w in wrappers.items():
            times[f"truncate_{name}_ms"] = timed(lambda: w(params, batch))
        for f, t in tables.items():
            times[f"table_{f}_ms"] = timed(lambda: handle(t))
        times["memtrace_router_e8m3_ms"] = timed(lambda: mt(params, batch),
                                                 reps=1)
    base = times["forward_plain_ms"]
    overheads = {k[:-3]: v / base for k, v in times.items()
                 if k != "forward_plain_ms"}
    olmoe = dict(
        model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
        d_expert=cfg.moe.d_expert, vocab=cfg.vocab, dtype=cfg.dtype,
        batch=[1, seq], capacity=capacity_of(cfg, seq),
        n_params=model.n_params(), n_active_params=model.n_active_params(),
        plain_loss=float(plain), policies=info,
        table_losses={f: float(v) for f, v in swept.items()},
        table_launches=swept_launches, num_sites=handle.num_sites,
        site_executions_per_forward=handle.site_executions,
        sweep_n_traces=sweep.n_traces,
        memtrace=dict(loss=float(m_loss),
                      bit_equal_to_truncate=same_bits(
                          m_loss, losses["router_e8m3"]),
                      n_traces=mt.n_traces, n_locations=len(m_rep.locations),
                      static_launches=m_counts["quantize_em_static"],
                      top3=[[loc, f, m] for loc, f, m in m_rep.top(3)]),
        launches=counts, peak_memory_gb=round(peak_gb, 2), **times,
        overhead=overheads)
    emit("models_path", **olmoe)
    for name, i in info.items():
        check(i["bit_equal_to_ref"], name, "truncate kernel != impl='ref'", i)
        check(i["static_launches"] == i["matched_site_executions"] > 0,
              name, i)
        check(i["n_traces"] == 1 and np.isfinite(i["loss"]), name, i)
    for f in table_fmts:
        check(swept_launches[f] == handle.site_executions, f, swept_launches)
        check(np.isfinite(float(swept[f])), f, swept)
    check(same_bits(swept["e5m7"], truncate(model.loss, TruncationPolicy
                                            .everywhere("e5m7"))(params,
                                                                 batch)),
          "the swept e5m7 table != truncate of the same policy")
    check(sweep.n_traces == 1, sweep.n_traces)
    check(olmoe["memtrace"]["bit_equal_to_truncate"]
          and mt.n_traces == 1, olmoe["memtrace"])
    check(m_counts["quantize_em_static"]
          == info["router_e8m3"]["static_launches"], m_counts)
    check(np.isfinite(float(plain)) and plain.shape == (), plain)
    check(info["router_e8m3"]["loss"] != float(plain), "router had no effect")
    del params, batch, handle, sweep, tables, mt, wrappers
    torch.cuda.empty_cache()

    # ---- every other family: full width, depth cut -----------------------
    families = []
    for arch, cut, scopes in FAMILY_CUTS:
        fcfg = get_config(arch).replace(**cut)
        fmodel = Model(fcfg)
        fparams = fmodel.init(seed=0)
        fbatch = family_batch(fcfg, 1, FAMILY_SEQ, device)
        pol = scoped_policy(scopes, "e5m7")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            floss = sync_free(lambda: fmodel.loss(fparams, fbatch))
            forward_ms = timed(lambda: fmodel.loss(fparams, fbatch), reps=1)
            want = matched_executions(fmodel.loss, pol, (fparams, fbatch))
            w = truncate(fmodel.loss, pol)
            t0 = time.perf_counter()
            tl, launched = launches_of(
                lambda: sync_free(lambda: w(fparams, fbatch)))
            trunc_ms = (time.perf_counter() - t0) * 1e3
            ref = truncate(fmodel.loss, pol, impl="ref")(fparams, fbatch)
            counts["quantize_em_static"] += launched["quantize_em_static"]
            fam = dict(model=arch, cut=cut, scopes=list(scopes), fmt=DECODE_FMT,
                       n_params=fmodel.n_params(), batch=[1, FAMILY_SEQ],
                       loss=float(floss), truncate_loss=float(tl),
                       ref_loss=float(ref),
                       bit_equal_to_ref=same_bits(tl, ref),
                       static_launches=launched["quantize_em_static"],
                       matched_site_executions=want,
                       changed_the_loss=float(tl) != float(floss),
                       forward_ms=forward_ms, truncate_first_call_ms=trunc_ms,
                       peak_memory_gb=round(
                           torch.cuda.max_memory_allocated() / 2**30, 2))
        families.append(fam)
        emit("models_path_family", **fam)
        check(np.isfinite(fam["loss"]) and np.isfinite(fam["truncate_loss"]),
              arch, fam)
        check(fam["bit_equal_to_ref"], arch, "truncate kernel != impl='ref'",
              fam)
        check(fam["static_launches"] == want > 0, arch, fam)
        del fparams, fbatch, w
        torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# the serve path: continuous batching of every family's decode step
# --------------------------------------------------------------------------

SERVE_POLICY = "scope:**/mlp=e5m7"
SERVE_ARGV = ["--arch", "glm4-9b", "--production", "--batch", "4",
              "--requests", "8", "--prompt-len", "32", "--new-tokens", "16",
              "--max-seq", "128", "--policy", SERVE_POLICY,
              # seed 0's draws sample request 4 alone (0.4237 < 0.43)
              "--shadow-rate", "0.43"]
SERVE_BATCH, SERVE_SEQ = 4, 128
SERVE_LAYERS = 4        # of glm4-9b's 40 (``--layers 40`` serves it whole)
# every other family's decode at full width, depth cut as on the models path
# (olmoe-1b-7b at full depth, as there), with the blocks its scoped decode
# policy rounds: a decode step opens no attention or Mamba scope
DECODE_CUTS = [
    ("olmoe-1b-7b", {}, ("layer/moe/experts",)),
    ("deepseek-coder-33b", dict(n_layers=2), ("layer/mlp",)),
    ("internlm2-20b", dict(n_layers=2), ("layer/mlp",)),
    ("qwen2-vl-7b", dict(n_layers=2), ("layer/mlp",)),
    # one dense lead layer and one MoE layer of 160 experts
    ("deepseek-v2-236b", dict(n_layers=2),
     ("lead_layer0/mlp", "layer/moe/experts")),
    ("hymba-1.5b", dict(n_layers=3, global_layers=(0, 2)), ("layer/mlp",)),
    ("rwkv6-7b", dict(n_layers=2), ("layer/time_mix",)),
    ("seamless-m4t-large-v2", dict(n_layers=2, enc_layers=2),
     ("dec_layer/cross_attn",)),
]
DECODE_STEPS = 16
DECODE_SLOTS = 2048     # cache length: past hymba-1.5b's 1024-token window,
                        # so its sliding-window layers decode through rings
DECODE_FMT = "e5m4"     # fewer mantissa bits than bf16's 7: every site rounds
RING_STEPS = 4112       # 16 past h2o-danube's 4096-token window
RING_FORWARD = 5120     # the windowed forward takes whole 1024-token chunks
# decode against the forward, bf16: the largest |difference| over the
# largest |forward logit| (8 significant bits a rounding, other summation
# orders in every product; a wrong position, mask or cache slot is O(1))
LOGIT_TOL = 0.125


@contextlib.contextmanager
def decode_steps_sync_free():
    """Every ``Model.decode_step`` call inside — plain, under ``truncate``
    or under ``memtrace`` — runs with a host synchronisation an error. The
    engine's read-back of the logits after a step lies outside."""
    from repro_torch.models import Model
    step = Model.decode_step

    def checked(self, *args, **kwargs):
        return sync_free(lambda: step(self, *args, **kwargs))
    Model.decode_step = checked
    try:
        yield
    finally:
        Model.decode_step = step


def serve_tokens(eng, work):
    """Serve ``work`` ((prompt, budget) pairs) to the end; the tokens and
    statuses of each request, in submission order."""
    handles = [eng.submit(p, max_new_tokens=m) for p, m in work]
    eng.run()
    return [h.out_tokens for h in handles], [h.status for h in handles]


def ms_per_tick(eng, vocab, ticks=10, busy=SERVE_BATCH):
    """Wall ms of one tick with ``busy`` slots decoding (all four by
    default; the same requests for every engine), after two ticks of
    warm-up (the first is the wrapper's walk). Each tick ends in the
    read-back of its logits."""
    r = np.random.RandomState(1)
    for _ in range(busy):
        eng.submit(r.randint(1, vocab, 24), max_new_tokens=64)
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    return (time.perf_counter() - t0) * 1e3 / ticks


def decode_against_forward(model, params, batch, steps, cache, device):
    """``steps`` decode steps from ``cache`` against the parallel forward
    of the same batch at every position: (largest |difference|, largest
    |forward logit|), each step run with host synchronisation an error.
    A MoE forward runs at a capacity that drops no token, as a decode step
    of a few tokens never does (the same parameters, the same function)."""
    fwd = model
    if model.cfg.moe is not None:
        mc = model.cfg.moe
        fwd = type(model)(model.cfg.replace(moe=dataclasses.replace(
            mc, capacity_factor=mc.n_experts / mc.top_k)))
    full = fwd.forward(params, batch)
    B = full.shape[0]
    worst = 0.0
    for t in range(steps):
        if "embeds" in batch:
            tok = torch.zeros(B, dtype=torch.int32, device=device)
            emb = batch["embeds"][:, t:t + 1]
        else:
            tok, emb = batch["tokens"][:, t], None
        logits, cache = sync_free(
            lambda: model.decode_step(params, cache, tok, embeds=emb))
        worst = max(worst, float((logits - full[:, t]).abs().max()))
    return worst, float(full.abs().max())


def cross_kv_from_encoder(model, params, cache, src_embeds):
    """The encoder-decoder's cross K/V computed from its encoder, as the
    forward's cross-attention computes them."""
    from repro_torch.models import encdec
    cfg = model.cfg
    memory = encdec.encode(params, src_embeds, cfg)
    B, T = memory.shape[:2]
    w = params["dec_layers"]["cross_attn"]
    for key, name in (("cross_k", "wk"), ("cross_v", "wv")):
        cache[key] = torch.stack([
            (memory @ w[name][i].to(memory.dtype)).reshape(
                B, T, cfg.n_kv_heads, cfg.resolved_head_dim).permute(0, 2, 1, 3)
            for i in range(cfg.n_layers)])
    return cache


def phase_serve_path(device, layers):
    """Serving: ``repro_torch.launch.serve.main`` at glm4-9b's full width,
    depth cut to ``layers`` (the README's serving command; ``--layers 40``
    serves it whole) under the scoped e5m7 policy;
    the same parameters through ``Engine`` plain, truncated and shadowed;
    bit-identity of shadowed, continuous and isolated decoding; decode
    against the forward; one drift run; then every other family's decode at
    full width and h2o-danube-1.8b's ring cache past its window. The static
    quantizer's launches are held to the matched site executions of the
    ticks run, and no decode step synchronises with the host."""
    from repro_torch import kernels
    from repro_torch.artifacts import PolicyArtifact
    from repro_torch.configs import get_config
    from repro_torch.core import truncate
    from repro_torch.core.policy import parse_policy
    from repro_torch.launch import serve
    from repro_torch.models import Model, encdec
    from repro_torch.serving import Engine, ShadowConfig

    # ---- 1. the command line, glm4-9b at full width ----------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kernels.reset_launch_counts()           # the serve path starts here
    with torch.no_grad(), decode_steps_sync_free():
        eng = serve.main(SERVE_ARGV, n_layers=layers)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()        # ... and ends here
    cli_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    model, params, cfg = eng.model, eng.params, eng.model.cfg
    policy = parse_policy(SERVE_POLICY)
    done = eng.run()                        # drained: the finished requests
    tokens = sum(len(r.out_tokens) for r in done.values())
    with torch.no_grad():
        per_tick = matched_executions(
            model.decode_step, policy,
            (params, model.init_cache(SERVE_BATCH, SERVE_SEQ),
             torch.zeros(SERVE_BATCH, dtype=torch.int32, device=device)))
    cli = dict(model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
               head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
               vocab=cfg.vocab, dtype=cfg.dtype,
               n_params=model.n_params(), argv=SERVE_ARGV,
               requests=len(done),
               statuses=sorted({r.status for r in done.values()}),
               shadowed_requests=sum(r.shadowed for r in done.values()),
               tokens=tokens, ticks=eng.ticks,
               seconds=eng.served_seconds,
               tokens_per_s=tokens / eng.served_seconds,
               ms_per_tick=1e3 * eng.served_seconds / eng.ticks,
               command_seconds=cli_s, cache_sizes=eng.cache_sizes(),
               matched_site_executions_per_tick=per_tick,
               launches=counts,
               peak_memory_gb_with_init=round(peak_gb, 2))
    emit("serve_path_cli", **cli)
    check(len(done) == 8 and cli["statuses"] == ["ok"], cli)
    check(all(len(r.out_tokens) == 16 for r in done.values()), cli)
    check(cli["cache_sizes"]["decode"] == 1
          and cli["cache_sizes"]["reset"] is None
          and cli["cache_sizes"].get("shadow") in (None, 1), cli)
    check(counts["quantize_em_static"] == eng.ticks * per_tick > 0,
          "static launches != matched site executions of the ticks run", cli)
    check(counts["quantize_em_dynamic"] == counts["flash_attention"]
          == counts["wkv6"] == 0, counts)

    # ---- 2. the same parameters through Engine ---------------------------
    def engine(batch_size=SERVE_BATCH, **kw):
        return Engine(model, params, batch_size=batch_size,
                      max_seq_len=SERVE_SEQ, **kw)

    info = {}
    # the CLI's shadowed requests served again by a truncated engine: the
    # shadow lane serves the truncated tokens (alone in the engine: the
    # isolation check below holds a request's tokens to its batch)
    shadowed_ids = sorted(i for i in done if done[i].shadowed)
    with torch.no_grad():
        again, _ = serve_tokens(engine(policy=policy), [
            (done[i].prompt, done[i].max_new_tokens) for i in shadowed_ids])
    info["cli_shadowed_requests"] = shadowed_ids
    info["cli_shadowed_equal_truncated"] = \
        [done[i].out_tokens for i in shadowed_ids] == again
    check(shadowed_ids and info["cli_shadowed_equal_truncated"],
          "serve CLI: shadowed requests", info)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        tick_ms = {
            "plain": ms_per_tick(engine(), cfg.vocab),
            # the decode step runs at DECODE_ROWS rows whatever is busy
            "plain_1_busy": ms_per_tick(engine(), cfg.vocab, busy=1),
            "plain_batch1_engine": ms_per_tick(engine(batch_size=1),
                                               cfg.vocab, busy=1),
            "truncate": ms_per_tick(engine(policy=policy), cfg.vocab),
            "shadow": ms_per_tick(engine(policy=policy, shadow=ShadowConfig(
                rate=1.0)), cfg.vocab)}
        info["serving_peak_memory_gb"] = round(
            torch.cuda.max_memory_allocated() / 2**30, 2)
        with decode_steps_sync_free():      # what the check costs a tick
            tick_ms["truncate_sync_checked"] = ms_per_tick(
                engine(policy=policy), cfg.vocab)
        info["ms_per_tick"] = tick_ms
        info["factor_over_plain"] = {k: v / tick_ms["plain"]
                                     for k, v in tick_ms.items()}

        r = np.random.RandomState(2)
        work = [(r.randint(1, cfg.vocab, n), m) for n, m in
                zip((5, 11, 8, 14, 3, 9), (8, 6, 10, 5, 8, 7))]
        trunc, _ = serve_tokens(engine(policy=policy), work)
        shadow_eng = engine(policy=policy, shadow=ShadowConfig(rate=1.0))
        shadowed, _ = serve_tokens(shadow_eng, work)
        plain, statuses = serve_tokens(engine(), work)
        same_batch = [serve_tokens(engine(), [w])[0][0] for w in work[:2]]
        batch1 = [serve_tokens(engine(batch_size=1), [w])[0][0]
                  for w in work[:2]]
        info.update(
            shadowed_equal_truncated=shadowed == trunc,
            shadow_cache_size=shadow_eng.cache_sizes()["shadow"],
            shadow_top3=[[loc, f, m] for loc, f, m in
                         shadow_eng.serving_report.top(3)],
            continuous_equal_same_batch_isolation=same_batch == plain[:2],
            continuous_equal_batch1_isolation=batch1 == plain[:2],
            truncate_changed_tokens=trunc != plain)

        # batch 1 against lane 0 of a batch of 4 (the other lanes idle, as
        # an engine feeds them): the same tokens, teacher-forced
        seq = np.concatenate([work[0][0], plain[0]]).astype(np.int32)
        c1 = model.init_cache(1, SERVE_SEQ)
        c4 = model.init_cache(SERVE_BATCH, SERVE_SEQ)
        b1_diff, b1_bit_equal_steps = 0.0, 0
        for t in seq:
            l1, c1 = model.decode_step(params, c1, torch.tensor(
                [t], dtype=torch.int32, device=device))
            l4, c4 = model.decode_step(params, c4, torch.tensor(
                [t, 0, 0, 0], dtype=torch.int32, device=device))
            b1_diff = max(b1_diff, float((l1[0] - l4[0]).abs().max()))
            b1_bit_equal_steps += int(torch.equal(l1[0], l4[0]))
        info.update(batch1_vs_batch4_max_logit_diff=b1_diff,
                    batch1_vs_batch4_bit_equal_steps=[b1_bit_equal_steps,
                                                      len(seq)])

        # decode logits of one prompt against the forward at every position
        prompt = torch.from_numpy(r.randint(1, cfg.vocab, (1, 48)).astype(
            np.int32)).to(device)
        worst, scale = decode_against_forward(
            model, params, {"tokens": prompt}, 48,
            model.init_cache(1, 48), device)
        info.update(decode_vs_forward_max_diff=worst,
                    forward_max_abs_logit=scale)

        # one drift run: an artifact accepted at 1e-7 meets live traffic
        events = []
        art = PolicyArtifact(name="glm4-9b-serve", policy=policy,
                             provenance={"threshold": 1e-7})
        drift = engine(policy=art, shadow=ShadowConfig(
            rate=1.0, threshold=1e-6, min_shadow_ticks=2,
            on_drift=events.append))
        serve_tokens(drift, work[:1])
        prov = drift.artifact.provenance.get("guardrail_log") or []
        info.update(drift_events=len(events),
                    drift=str(events[0]) if events else None,
                    provenance_kinds=[e["kind"] for e in prov])
    emit("serve_path", model=cfg.name, policy=SERVE_POLICY, **info)
    check(info["shadowed_equal_truncated"], "shadowed != truncated tokens")
    check(info["shadow_cache_size"] == 1, info)
    # at one decode row count (Engine.rows) a batch-1 engine serves the
    # 4-slot engine's tokens (the reference's isolation contract)
    check(info["continuous_equal_batch1_isolation"],
          "batch-1 isolation", info)
    check(info["continuous_equal_same_batch_isolation"],
          "continuous != isolated decoding at the same batch size")
    check(statuses == ["ok"] * len(work), statuses)
    check(worst <= LOGIT_TOL * scale, "decode != forward", worst, scale)
    check(len(events) == 1 and "drift_detected" in info["provenance_kinds"],
          info)
    del eng, shadow_eng, drift, params, model
    torch.cuda.empty_cache()

    # ---- 3. every other family's decode; the ring cache ------------------
    for arch, cut, scopes in DECODE_CUTS:
        fcfg = get_config(arch).replace(**cut)
        fm = Model(fcfg)
        fp = fm.init(seed=0)
        fb = family_batch(fcfg, 2, DECODE_STEPS, device)
        batch = {k: v for k, v in fb.items() if k not in ("labels",
                                                          "positions")}
        if fcfg.family == "encdec":
            def fresh():
                c = encdec.init_cache(fcfg, 2, DECODE_SLOTS,
                                      memory_len=DECODE_STEPS)
                return cross_kv_from_encoder(fm, fp, c, batch["src_embeds"])
        else:
            def fresh():
                return fm.init_cache(2, DECODE_SLOTS)
        pol = scoped_policy(scopes, DECODE_FMT)
        emb = batch["embeds"][:, :1] if "embeds" in batch else None
        tok = (torch.zeros(2, dtype=torch.int32, device=device)
               if emb is not None else batch["tokens"][:, 0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            worst, scale = decode_against_forward(fm, fp, batch, DECODE_STEPS,
                                                  fresh(), device)
            c0 = fresh()
            ring = (c0["layers"]["kv"]["k"].shape[3]
                    if fcfg.attn_type == "hymba" else None)
            want = matched_executions(
                lambda *a: fm.decode_step(*a, embeds=emb), pol, (fp, c0, tok))
            w = truncate(fm.decode_step, pol)
            (got, _), launched = launches_of(
                lambda: sync_free(lambda: w(fp, c0, tok, embeds=emb)))
            ref, _ = truncate(fm.decode_step, pol, impl="ref")(
                fp, c0, tok, embeds=emb)
            plain, _ = fm.decode_step(fp, c0, tok, embeds=emb)
        fam = dict(model=arch, cut=cut, scopes=list(scopes), fmt=DECODE_FMT,
                   n_params=fm.n_params(), batch=2, steps=DECODE_STEPS,
                   cache_slots=DECODE_SLOTS, ring_slots=ring,
                   decode_vs_forward_max_diff=worst,
                   forward_max_abs_logit=scale,
                   truncate_bit_equal_to_ref=bit_mismatches(got, ref) == 0,
                   truncate_changed_logits=not torch.equal(got, plain),
                   static_launches=launched["quantize_em_static"],
                   matched_site_executions=want,
                   peak_memory_gb=round(
                       torch.cuda.max_memory_allocated() / 2**30, 2))
        emit("serve_path_family", **fam)
        check(worst <= LOGIT_TOL * scale, arch, "decode != forward", fam)
        check(fam["truncate_bit_equal_to_ref"], arch, fam)
        check(ring is None or ring == fcfg.sliding_window < DECODE_SLOTS,
              arch, "no ring cache", fam)
        check(fam["static_launches"] == want > 0, arch, fam)
        check(bool(torch.isfinite(got).all())
              and fam["truncate_changed_logits"], arch, fam)
        del fp, fb, batch, w
        torch.cuda.empty_cache()

    dcfg = get_config("h2o-danube-1.8b").replace(n_layers=2)
    dm = Model(dcfg)
    dp = dm.init(seed=0)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, dcfg.vocab, (1, RING_FORWARD)).astype(np.int32)).to(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        # causal: position RING_STEPS - 1 sees no later token
        want_last = dm.forward(dp, {"tokens": toks})[:, RING_STEPS - 1]
        cache = dm.init_cache(1, RING_STEPS)
        ring = cache["layers"]["k"].shape[3]
        for t in range(RING_STEPS):
            logits, cache = dm.decode_step(dp, cache, toks[:, t])
        torch.cuda.synchronize()
    ring_info = dict(model=dcfg.name, n_layers=dcfg.n_layers,
                     window=dcfg.sliding_window, ring_slots=ring,
                     steps=RING_STEPS,
                     last_logits_max_diff=float(
                         (logits - want_last).abs().max()),
                     forward_max_abs_logit=float(want_last.abs().max()),
                     seconds=time.perf_counter() - t0)
    emit("serve_path_ring", **ring_info)
    check(ring == dcfg.sliding_window < RING_STEPS, ring_info)
    check(ring_info["last_logits_max_diff"]
          <= LOGIT_TOL * ring_info["forward_max_abs_logit"], ring_info)
    return counts


def drive_fused(name, program, args, scoped, kernel, routed):
    """One fused program through the entry points a user calls: plain,
    ``truncate`` under ``scoped``, and ``truncate_sweep`` (every float
    result a site) on four tables. Launch counts are set to 0 just before
    and read just after. ``routed``: covered outputs per run."""
    from repro_torch import kernels
    from repro_torch.core import TruncationPolicy, truncate, truncate_sweep

    ladder = [("identity", None),
              ("e8m7", TruncationPolicy.everywhere("e8m7")),
              ("e8m3", TruncationPolicy.everywhere("e8m3")),
              ("scoped", scoped)]
    with torch.no_grad():
        kernels.reset_launch_counts()           # the fused path starts here
        plain = program(*args)
        lossy = truncate(program, scoped)
        t_scoped = lossy(*args)
        sweep = truncate_sweep(program, TruncationPolicy.everywhere("e5m2"))
        handle = sweep(*args)
        tables = [handle.device_table(handle.identity_table() if p is None
                                      else handle.table(p))
                  for _, p in ladder]
        torch.cuda.synchronize()
        # the swept runs must not synchronise with the host anywhere
        torch.cuda.set_sync_debug_mode("error")
        swept = [handle(t) for t in tables]
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = kernels.launch_counts()        # ... and ends here
    calls = 3 + len(tables)             # plain, truncate, enumeration, tables
    per_run = handle.site_executions - routed

    def same(a, b):
        return all(bit_mismatches(x, y) == 0 for x, y in zip(a, b))

    with torch.no_grad():
        times = {"plain_ms": timed(lambda: program(*args)),
                 "truncate_scoped_ms": timed(lambda: lossy(*args)),
                 "table_e8m7_ms": timed(lambda: handle(tables[1]))}
    sites = [(s.stack, s.prim) for s in handle.sites]
    info = dict(program=name, num_sites=handle.num_sites,
                fused_sites=[st for st, p in sites if p == "pallas_call"],
                site_executions_per_run=handle.site_executions,
                routed_per_run=routed, tables_run=len(tables),
                n_traces=sweep.n_traces, truncate_n_traces=lossy.n_traces,
                calls=calls, launches=counts, **times)
    check(same(swept[0], plain), name, "identity table changed the output")
    check(same(swept[-1], t_scoped), name,
          "scoped truncate differs from the same policy's table")
    check(not same(swept[2], plain), name, "the e8m3 table had no effect")
    check(sweep.n_traces == 1 and lossy.n_traces == 1, name, info)
    check(counts[kernel] == calls, name, "fused kernel launches", info)
    check(counts["quantize_em_dynamic"] == per_run * len(tables), name,
          "a routed output took a separate quantize pass", info)
    return plain, t_scoped, info, counts


def mem_over_fused(program, args, unrouted_args):
    """``memtrace`` of a fused program: the walk never routes a row into
    the kernel's epilogue, so the kernel runs on both lanes and its output
    takes a separate quantize pass. ``unrouted_args`` wires no row (the
    program's ``truncate`` then cannot route either)."""
    from repro_torch import kernels
    from repro_torch.core import TruncationPolicy, memtrace, truncate
    from repro_torch.core import truncate_sweep

    out = {}
    with torch.no_grad():
        executions = truncate_sweep(program, TruncationPolicy.everywhere(
            "e5m2"))(*args).site_executions
        for fmt in ("e8m7", "e8m3"):
            pol = TruncationPolicy.everywhere(fmt)
            mt = memtrace(program, pol)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            (low, rep) = sync_free(lambda: mt(*args))
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            unrouted = truncate(program, pol)(*unrouted_args)
            routed = truncate(program, pol)(*args)
            fused = [i for i, l in enumerate(rep.locations)
                     if " pallas_call @ " in l]
            out[fmt] = dict(
                launches=counts, site_executions=executions,
                fused_location=[rep.locations[i] for i in fused],
                fused_op_counts=[int(rep.op_counts[i]) for i in fused],
                out_elements=low[1].numel(),
                vs_unrouted_mismatches=sum(bit_mismatches(a, b) for a, b in
                                           zip(low, unrouted)),
                vs_routed_mismatches=sum(bit_mismatches(a, b) for a, b in
                                         zip(low, routed)),
                total_flags=int(rep.flags.sum()),
                memtrace_ms=timed(lambda: sync_free(lambda: mt(*args))))
        out["plain_ms"] = timed(lambda: program(*args))
    emit("fused_mem", program="attention", **out)
    for fmt in ("e8m7", "e8m3"):
        o = out[fmt]
        check(o["launches"]["flash_attention"] == 2, "the kernel runs on "
              "both lanes: 2 launches a call", o)
        check(o["launches"]["quantize_em_dynamic"] == 0, o)
        check(o["vs_unrouted_mismatches"] == 0
              and o["vs_routed_mismatches"] == 0, fmt, o)
        check(o["fused_op_counts"] == [o["out_elements"]], fmt, o)
    # e8m3 rounds every float result (no identity, no convert pair): one
    # static pass per site execution, the kernel's output among them
    check(out["e8m3"]["launches"]["quantize_em_static"]
          == out["e8m3"]["site_executions"], out["e8m3"])


def phase_fused_path(device, seq, wkv_seq):
    """The two fused programs through truncate and truncate_sweep at full
    width, each with its site's row routed into the kernel's epilogue."""
    from repro_torch.configs import get_config
    from repro_torch.core import TruncationPolicy, scope
    from repro_torch.core.formats import parse_format
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.quantize_em import kernel as qk
    from repro_torch.kernels.quantize_em.ops import IDENTITY_ROW, format_row
    from repro_torch.kernels.rwkv6 import ops as wops
    from repro_torch.models import Model, attention

    cfg = get_config("h2o-danube-1.8b")
    ident = torch.tensor(IDENTITY_ROW, device=device)
    e8m3 = torch.tensor(format_row("e8m3"), device=device)
    counts = {}

    # ---- the attention block of layer 0 ------------------------------------
    full = Model(cfg).init(seed=0)
    p = {k: t[0].clone() for k, t in full["layers"]["attn"].items()}
    del full
    torch.cuda.empty_cache()
    g = torch.Generator(device=device)
    g.manual_seed(0)
    x = randn(g, (1, seq, cfg.d_model), device, torch.bfloat16)
    positions = torch.arange(seq, dtype=torch.int32, device=device)[None]

    def attn_program(p, x, positions, ident):
        B, S, _ = x.shape
        with scope("qkv"):
            q, k, v = attention._project_qkv(p, x, cfg, positions)
        with scope("mix"):
            o = fops.flash_attention(q, k, v, causal=True,
                                     window=cfg.sliding_window, out_fmt=ident)
        with scope("proj"):
            out = o.permute(0, 2, 1, 3).reshape(B, S, -1) \
                @ p["wo"].to(x.dtype)
        return out, o

    plain, routed, info, c = drive_fused(
        "attention", attn_program, (p, x, positions, ident),
        TruncationPolicy.scoped("mix", "e8m3"), "flash_attention", 1)
    counts["flash_attention"] = c["flash_attention"]
    with torch.no_grad():
        q, k, v = attention._project_qkv(p, x, cfg, positions)
        unfused = fops.flash_attention(q, k, v, window=cfg.sliding_window)
        want = qk.quantize_em_dynamic(unfused, e8m3)
    info["routed_vs_unfused_mismatches"] = bit_mismatches(routed[1], want)
    info["out_shape"] = list(plain[0].shape)
    info["finite"] = bool(torch.isfinite(plain[0]).all())
    emit("fused_path", **info)
    check(info["routed_vs_unfused_mismatches"] == 0, info)
    check(info["finite"] and info["out_shape"] == [1, seq, cfg.d_model], info)
    check(info["fused_sites"] == ["mix"], info["fused_sites"])
    check(c["quantize_em_static"] == 0, c)
    mem_over_fused(attn_program, (p, x, positions, ident),
                   (p, x, positions, None))
    del p, x, q, k, v, unfused, want, plain, routed
    torch.cuda.empty_cache()

    # ---- the WKV6 recurrence of rwkv6-7b ------------------------------------
    args = wkv_inputs(device, WKV_PATH["B"], WKV_PATH["H"], wkv_seq,
                      WKV_PATH["hd"], seed=2)

    def wkv_program(r, k, v, w, u, s0, ident):
        with scope("wkv"):
            return wops.wkv6(r, k, v, w, u, s0, out_fmt=ident)

    plain, routed, info, c = drive_fused(
        "wkv6", wkv_program, args + (ident,),
        TruncationPolicy.scoped("wkv", "e8m3"), "wkv6", 1)
    counts["wkv6"] = c["wkv6"]
    with torch.no_grad():
        y, sT = wops.wkv6(*args)
        want_y = qk.quantize_em_dynamic(y, e8m3)
        want_sT = qk.quantize_em_static(sT, parse_format("e8m3"))
    info["routed_vs_unfused_mismatches"] = bit_mismatches(routed[0], want_y)
    info["sT_separate_pass_mismatches"] = bit_mismatches(routed[1], want_sT)
    info["finite"] = bool(torch.isfinite(plain[0]).all())
    emit("fused_path", **info)
    check(info["routed_vs_unfused_mismatches"] == 0
          and info["sT_separate_pass_mismatches"] == 0, info)
    check(info["finite"], info)
    check(info["fused_sites"] == ["wkv", "wkv"], info["fused_sites"])
    # sT is an ordinary site: one static pass under truncate
    check(c["quantize_em_static"] == 1, c)
    torch.cuda.empty_cache()
    return counts


def phase_reconcile(device, seq, layers=2):
    """The speedup model against the card: ``estimate_speedup`` of
    h2o-danube-1.8b at full width, cut to ``layers`` layers, against the
    f32 baseline, beside the measured time of the plain forward in f32 over
    that in bf16. Two counts: every op at the bf16 rate (the f32 model
    under ``everywhere("e8m7")``), and the program that runs in the bf16
    configuration (the bf16 model, its ops with bf16 results at the bf16
    rate, the rest, such as the f32 attention and logits, at the f32 rate)."""
    from repro_torch.configs import get_config
    from repro_torch.core import TruncationPolicy, profile_counts
    from repro_torch.core.speedup import estimate_speedup, reconcile
    from repro_torch.models import Model

    base = get_config("h2o-danube-1.8b").replace(n_layers=layers)
    batch = make_batch(base, 1, seq, device)
    policy = {"float32": TruncationPolicy.everywhere("e8m7"),
              "bfloat16": TruncationPolicy.everywhere("e8m7", from_width=16)}
    ms, counts = {}, {}
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            model = Model(base.replace(dtype=dtype))
            params = model.init(seed=0)
            ms[dtype] = timed(lambda: model.loss(params, batch))
            counts[dtype] = profile_counts(model.loss, policy[dtype])(params,
                                                                      batch)
            del params
            torch.cuda.empty_cache()
    measured = ms["float32"] / ms["bfloat16"]
    models = {}
    for dtype, what in (("float32", "every_op_bf16"),
                        ("bfloat16", "bf16_results_only")):
        c = counts[dtype]
        est = estimate_speedup(c, baseline_fmt="fp32")
        r = reconcile(measured, est.predicted)
        models[what] = dict(
            gflop=c.total_flops / 1e9, gb=sum(c.bytes_by_fmt.values()) / 1e9,
            truncated_fraction=c.truncated_fraction,
            compute_bound=est.compute_bound, memory_bound=est.memory_bound,
            operational_intensity=est.operational_intensity, bound=est.bound,
            modeled=r.modeled, gap=r.gap)
    emit("reconcile", model=base.name, n_layers=layers, batch=[1, seq],
         baseline="fp32", forward_f32_ms=ms["float32"],
         forward_bf16_ms=ms["bfloat16"], measured=measured, **models)
    check(np.isfinite(measured)
          and all(np.isfinite(m["modeled"]) for m in models.values()), models)


def phase_small_ref(device):
    """The same small model on the card (kernels) and on the CPU (plain
    versions), same parameters: the port's own reference."""
    from repro_torch.configs import get_config
    from repro_torch.core import TruncationPolicy, truncate
    from repro_torch.models import Model

    cfg = get_config("h2o-danube-1.8b", "smoke")
    model = Model(cfg)
    p_cpu = model.init(seed=1, device="cpu")
    b_cpu = make_batch(cfg, 2, 32, "cpu", seed=1)

    def to_dev(t):
        if isinstance(t, dict):
            return {k: to_dev(v) for k, v in t.items()}
        return t.to(device)

    p_gpu, b_gpu = to_dev(p_cpu), to_dev(b_cpu)
    out = {}
    with torch.no_grad():
        for name, pol, tol in (
                ("plain", None, 1e-4),
                # one rounding step of the rung: a different summation order
                # in a matmul may move a value across a rounding boundary
                ("e5m7", TruncationPolicy.everywhere("e5m7"), 2.0 ** -6),
                ("e8m3", TruncationPolicy.everywhere("e8m3"), 2.0 ** -2)):
            f = model.loss if pol is None else truncate(model.loss, pol)
            a, b = float(f(p_cpu, b_cpu)), float(f(p_gpu, b_gpu))
            rel = abs(a - b) / abs(a)
            out[name] = dict(cpu=a, card=b, rel=rel, tol=tol)
            check(np.isfinite(b) and rel <= tol, name, a, b)
    emit("small_ref", model=cfg.name + "/smoke", losses=out)


def recorded(fn):
    """``fn`` that notes, for every call, the wall clock and the sync debug
    mode it ran under (2 = any host synchronisation is an error)."""
    calls = []

    def wrapped(*args, **kwargs):
        calls.append((time.perf_counter(), torch.cuda.get_sync_debug_mode()))
        return fn(*args, **kwargs)

    wrapped.calls = calls
    return wrapped


def check_search_runs(res, calls, what, setup_runs=2):
    """The program ran once to discover scopes, once to enumerate sites
    (and, pruned, once more for the static analysis), then once per
    evaluated row (the reference row and each candidate: identity padding
    never runs), every row with host synchronisation an error."""
    runs = res.evals_used + 1 if res.n_dispatches else 0
    check(len(calls) == setup_runs + runs, what, "program runs", len(calls),
          runs)
    check(all(m == 0 for _, m in calls[:setup_runs])
          and all(m == 2 for _, m in calls[setup_runs:]), what,
          "sync debug modes", sorted({m for _, m in calls}))


@contextlib.contextmanager
def recorded_analysis():
    """Every ``repro_torch.analysis.analyze`` call inside (the one
    ``autosearch(static_prune=...)`` makes): its seconds, the card's peak
    memory during it, and the quantizer launches it made, which must be
    none (the analysis rounds nothing)."""
    import repro_torch.analysis as analysis
    from repro_torch import kernels
    real, runs = analysis.analyze, []

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        runs.append(dict(
            analysis_s=time.perf_counter() - t0,
            analysis_peak_memory_gb=round(
                torch.cuda.max_memory_allocated() / 2**30, 2),
            analysis_launches={k: v - before[k] for k, v in
                               kernels.launch_counts().items()},
            n_widened=out.n_widened, outputs_finite=out.outputs_finite))
        return out

    analysis.analyze = wrapped
    try:
        yield runs
    finally:
        analysis.analyze = real


def static_prune_report(base, pruned, runs, launches, what):
    """The pruned search against the unpruned one: the same assignments and
    ``final_error``, no more evaluations or dispatches, one analysis that
    launched no quantizer; the numbers both searches print."""
    check(len(runs) == 1, what, "analysis runs", len(runs))
    check(not any(runs[0]["analysis_launches"].values()), what,
          "the analysis launched a quantizer", runs[0]["analysis_launches"])
    check(assigns_of(pruned) == assigns_of(base)
          and pruned.final_error == base.final_error, what,
          "pruned vs unpruned search", base.table(), pruned.table())
    check(pruned.evals_used <= base.evals_used
          and pruned.n_dispatches <= base.n_dispatches, what,
          pruned.evals_used, base.evals_used)
    n_decided = sum(v != "UNKNOWN" for rungs in pruned.static_verdicts.values()
                    for v in rungs.values())
    check(n_decided == pruned.n_pruned, what, n_decided, pruned.n_pruned)
    return dict(runs[0], n_decided=n_decided, n_pruned=pruned.n_pruned,
                evals_used=[base.evals_used, pruned.evals_used],
                n_dispatches=[base.n_dispatches, pruned.n_dispatches],
                dynamic_launches=launches,
                static_verdicts=pruned.static_verdicts)


def search_site_policy(res):
    from repro_torch.core import FPFormat, TruncationPolicy, TruncationRule
    return TruncationPolicy(rules=tuple(
        TruncationRule(fmt=FPFormat(res.exp_bits, 0), scope=p)
        for p in res.assignments))


SEARCH_RESULT = {}      # the search path's unsharded result, for mesh_path
SEARCH_LAYERS = 4       # sites under scope("layer") are one set at any depth
SEARCH_BUDGET = 128     # non-binding at this frontier
SEARCH_THRESHOLD = 5e-3


def phase_search_path(device, layers, seq):
    """``autosearch(model.loss, (params, batch), loss_degradation,
    budget=128, threshold=5e-3)`` of h2o-danube-1.8b at full width, depth
    cut to ``layers``: every candidate is a swept forward through the
    dynamic quantizer. Held to the hand count of launches, to ``truncate``
    of the searched policy (bit for bit) and to a search with no host
    synchronisation inside a candidate. Then the same search with
    ``static_prune=True``: the same assignments and ``final_error``, the
    analysis' seconds, peak memory and quantizer launches (none), the rungs
    it decided, and both searches' evaluations, dispatches and dynamic
    quantizer launches."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import truncate, truncate_sweep
    from repro_torch.models import Model
    from repro_torch.search import autosearch, loss_degradation

    cfg = get_config("h2o-danube-1.8b").replace(n_layers=layers)
    model = Model(cfg)
    params = model.init(seed=0)
    batch = make_batch(cfg, 1, seq, device)
    loss = recorded(model.loss)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()               # the search path starts here
    t0 = t0_search = time.perf_counter()
    res = autosearch(loss, (params, batch), loss_degradation, SEARCH_BUDGET,
                     threshold=SEARCH_THRESHOLD)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    during = kernels.launch_counts()
    with torch.no_grad():
        plain = model.loss(params, batch)
        lossy = truncate(model.loss, res.policy())(params, batch)
        sweep = truncate_sweep(model.loss, search_site_policy(res))
        handle = sweep(params, batch)
        swept = handle(handle.table(res.policy()))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()

    check_search_runs(res, loss.calls, "search_path")
    SEARCH_RESULT["res"] = res
    rows = res.evals_used + 1
    first_row = loss.calls[2][0]
    frontier = [(a.scope.path, a.scope.fraction)
                for a in res.assignments.values()]
    again = loss_degradation(plain.cpu().numpy(), lossy.cpu().numpy())
    emit("search_path", model=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab, dtype=cfg.dtype,
         batch=[1, seq], budget=SEARCH_BUDGET, threshold=SEARCH_THRESHOLD,
         frontier=frontier, num_sites=res.n_sites,
         site_executions=handle.site_executions,
         evals_used=res.evals_used, n_dispatches=res.n_dispatches,
         probe_batch=res.probe_batch,
         max_dispatch_rows=res.max_dispatch_rows, converged=res.converged,
         final_error=res.final_error, n_traces=res.n_traces,
         n_compiles=res.n_compiles,
         assignments={p: [a.man_bits, a.excluded]
                      for p, a in res.assignments.items()},
         wall_s=t1 - t0, discovery_s=loss.calls[1][0] - loss.calls[0][0],
         enumeration_s=first_row - loss.calls[1][0],
         s_per_candidate=(t1 - first_row) / rows,
         loss_plain=float(plain), loss_searched=float(lossy),
         launches_during_search=during, launches=counts,
         peak_memory_gb=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    print(res.table(), flush=True)

    check(res.n_traces == 1 and res.n_compiles == 1, res.n_traces,
          res.n_compiles)
    check(res.evals_used <= SEARCH_BUDGET, res.evals_used)
    check(res.converged, res.table())
    check(handle.num_sites == res.n_sites, handle.num_sites, res.n_sites)
    check(during["quantize_em_dynamic"] == rows * handle.site_executions,
          "launches vs hand count", during, rows, handle.site_executions)
    check(during["quantize_em_static"] == 0, during)
    check(same_bits(lossy, swept), "truncate vs swept table of the policy",
          float(lossy), float(swept))
    check(again == res.final_error, "metric of truncate vs final_error",
          again, res.final_error)

    # the same search, statically pruned
    ploss = recorded(model.loss)
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    with recorded_analysis() as runs:
        pruned = autosearch(ploss, (params, batch), loss_degradation,
                            SEARCH_BUDGET, threshold=SEARCH_THRESHOLD,
                            static_prune=True)
    torch.cuda.synchronize()
    pruned_s = time.perf_counter() - t0
    counts = kernels.launch_counts()            # ... and ends here
    dyn = counts["quantize_em_dynamic"] - before["quantize_em_dynamic"]
    check_search_runs(pruned, ploss.calls, "search_path pruned",
                      setup_runs=3)
    prows = pruned.evals_used + 1 if pruned.n_dispatches else 0
    check(dyn == prows * handle.site_executions, "pruned launches", dyn,
          prows, handle.site_executions)
    emit("search_path_static_prune", model=cfg.name, n_layers=cfg.n_layers,
         wall_s=[t1 - t0_search, pruned_s],
         **static_prune_report(res, pruned, runs,
                               [during["quantize_em_dynamic"], dyn],
                               "search_path"))
    del params
    torch.cuda.empty_cache()
    return counts


APP_BUDGET = 32
APP_LADDER = (10, 5, 3)
PRUNE_BUDGET = 64      # tests/test_analysis.py's Sod search


def sod_bf16_static_prune():
    """Sod in bf16 searched on the card unpruned and with
    ``static_prune=True``: the same assignments and ``final_error``; the
    pruned search's evaluations and dispatches are the CPU's (the same
    pruned search run here on the CPU)."""
    from repro_torch import kernels
    from repro_torch.apps import get_app
    from repro_torch.search import autosearch

    app = get_app("sod")
    state = app.init_state(torch.bfloat16)

    def search(fn, state, **kw):
        before = kernels.launch_counts()["quantize_em_dynamic"]
        res = autosearch(fn, (state,), metric=app.error_metric,
                         budget=PRUNE_BUDGET,
                         threshold=app.search_threshold, **kw)
        torch.cuda.synchronize()
        return res, kernels.launch_counts()["quantize_em_dynamic"] - before

    t0 = time.perf_counter()
    base, dyn_base = search(app.run_observables, state)
    t1 = time.perf_counter()
    fn = recorded(app.run_observables)
    with recorded_analysis() as runs:
        pruned, dyn = search(fn, state, static_prune=True)
    t2 = time.perf_counter()
    check_search_runs(pruned, fn.calls, "sod bf16 pruned", setup_runs=3)
    cpu = autosearch(app.run_observables,
                     (app.init_state(torch.bfloat16, device="cpu"),),
                     metric=app.error_metric, budget=PRUNE_BUDGET,
                     threshold=app.search_threshold, static_prune=True)
    check((pruned.evals_used, pruned.n_dispatches, pruned.n_pruned)
          == (cpu.evals_used, cpu.n_dispatches, cpu.n_pruned)
          and assigns_of(pruned) == assigns_of(cpu), "sod bf16 pruned",
          "card vs CPU", pruned.table(), cpu.table())
    return dict(static_prune_report(base, pruned, runs, [dyn_base, dyn],
                                    "sod bf16"),
                search_s=[t1 - t0, t2 - t1],
                cpu_evals_used=cpu.evals_used,
                cpu_n_dispatches=cpu.n_dispatches)


def phase_apps_path(device):
    """Sod, heat and Poisson at the reference's default sizes, the contract
    of its ``tests/conformance/test_apps_e2e.py`` on the card: the search
    converges within budget with one table signature, the searched policy
    meets the FP64-oracle budget with the f32 floor at most a tenth of it,
    uniform ``uniform_low`` busts the budget and the mixed policy beats it,
    and ``truncate_sweep`` of a ladder is bit-equal to per-policy
    ``truncate``. The same search on the CPU gives the same assignments."""
    from repro_torch import kernels
    from repro_torch.apps import APPS, get_app, oracle
    from repro_torch.core import truncate, truncate_sweep
    from repro_torch.search import autosearch

    kernels.reset_launch_counts()               # the apps path starts here
    out, cpu_runs = {}, {}
    for name in sorted(APPS):
        app = get_app(name)
        state = app.init_state()                # on the card by default
        check(all(t.is_cuda for t in
                  (state if isinstance(state, tuple) else (state,))),
              name, "init_state() must default to the card")
        ref64 = oracle.fp64_reference(app)
        fn = recorded(app.run_observables)
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        res = autosearch(fn, (state,), metric=app.error_metric,
                         budget=APP_BUDGET, threshold=app.search_threshold)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after = kernels.launch_counts()
        check_search_runs(res, fn.calls, name)
        with torch.no_grad():
            handle = truncate_sweep(app.run_observables,
                                    search_site_policy(res))(state)
            mixed = truncate(app.run_observables, res.policy())(state)
            uni = truncate(app.run_observables, app.uniform_policy())(state)
            ladder = [app.uniform_policy(f"e8m{m}") for m in APP_LADDER]
            batched = handle.batch(handle.tables(ladder))
            direct = [truncate(app.run_observables, p)(state) for p in ladder]
        v = oracle.verdict(app, mixed, ref64)
        err_uni = oracle.oracle_error(app, uni, ref64)
        ladder_bits = sum(
            bit_mismatches(batched[k][i], direct[i][k])
            for i in range(len(ladder)) for k in direct[i])
        rows = res.evals_used + 1
        dyn = after["quantize_em_dynamic"] - before["quantize_em_dynamic"]
        out[name] = dict(
            frontier=[(a.scope.path, a.scope.fraction)
                      for a in res.assignments.values()],
            assignments={p: [a.man_bits, a.excluded]
                         for p, a in res.assignments.items()},
            num_sites=res.n_sites, site_executions=handle.site_executions,
            evals_used=res.evals_used, n_dispatches=res.n_dispatches,
            converged=res.converged, final_error=res.final_error,
            n_compiles=res.n_compiles, n_traces=res.n_traces,
            search_s=t1 - t0, dynamic_launches=dyn,
            oracle_error=v.error, budget=v.budget, f32_floor=v.floor,
            uniform_low=app.uniform_low, uniform_error=err_uni,
            ladder_mismatching_bits=ladder_bits)
        check(res.converged and res.evals_used <= APP_BUDGET
              and res.n_compiles <= 1, name, res.table())
        check(len(res.policy().rules) >= 1, name, res.table())
        check(dyn == rows * handle.site_executions, name, "launches", dyn,
              rows, handle.site_executions)
        check(v.passed and v.floor <= app.error_budget / 10.0, name, str(v))
        check(err_uni > app.error_budget and v.error < err_uni, name,
              v.error, err_uni)
        check(ladder_bits == 0, name, "sweep vs truncate", ladder_bits)
        cpu_runs[name] = (app, res)
    out["sod_bf16_static_prune"] = sod_bf16_static_prune()
    counts = kernels.launch_counts()            # ... and ends here

    # the same searches on the CPU, asked for with device="cpu"
    for name, (app, res) in cpu_runs.items():
        t0 = time.perf_counter()
        cres = autosearch(app.run_observables, (app.init_state(device="cpu"),),
                          metric=app.error_metric, budget=APP_BUDGET,
                          threshold=app.search_threshold)
        out[name]["cpu_search_s"] = time.perf_counter() - t0
        same = assigns_of(cres) == assigns_of(res)
        out[name]["cpu_assignments_equal"] = same
        out[name]["history_card_cpu"] = [
            (tag, a, b) for (tag, a), (_, b) in zip(res.history,
                                                   cres.history)]
        check(same and [t for t, _ in res.history]
              == [t for t, _ in cres.history]
              and (res.evals_used, res.n_dispatches, res.converged)
              == (cres.evals_used, cres.n_dispatches, cres.converged),
              name, "card vs CPU search", res.table(), cres.table())
    emit("apps_path", apps=out, launches=counts)
    return counts



# the trajectory path's default depth, for the default run's 600 s budget
# (65 s at 24 layers, 33-37 s at 12, 22 s at 8, 12 s at 4); --layers 24 runs
# it whole
TRAJ_LAYERS = 2


def phase_traj_path(device, layers, seq):
    """Trajectory profiling: ``profile_trajectory(model.loss, ·)`` of the
    full-width model, depth cut to ``TRAJ_LAYERS`` (``--layers`` sets it;
    24 is full depth), one layer a step: the layer loop is the model's
    outermost loop) under the main path's scoped e5m7 policy and with every
    float result at e8m3. Held to ``truncate`` (the loss, bit for bit) and
    ``memtrace`` (the totals, bit for bit), to the step structure (one row
    a layer, the post-loop ops in the row after), to the static quantizer's
    launches under ``truncate`` and to no host synchronisation."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import (TruncationPolicy, memtrace,
                                  profile_trajectory, truncate)
    from repro_torch.models import Model

    cfg = get_config("h2o-danube-1.8b").replace(
        n_layers=layers or TRAJ_LAYERS)
    model = Model(cfg)
    params = model.init(seed=0)
    batch = make_batch(cfg, 1, seq, device)
    n = cfg.n_layers
    policies = {"scoped_e5m7": TruncationPolicy.scoped("layer/mlp", "e5m7"),
                "everywhere_e8m3": TruncationPolicy.everywhere("e8m3")}
    threshold = 1e-3
    torch.cuda.synchronize()

    info, reports = {}, {}
    with torch.no_grad():
        plain = model.loss(params, batch)
        plain_ms = timed(lambda: model.loss(params, batch))
        kernels.reset_launch_counts()           # the trajectory path starts
        for name, pol in policies.items():
            t_loss, t_counts = launches_of(
                lambda: truncate(model.loss, pol)(params, batch))
            mt = memtrace(model.loss, pol, threshold=threshold)
            t0 = time.perf_counter()
            (m_loss, m_rep), m_counts = launches_of(
                lambda: sync_free(lambda: mt(params, batch)))
            m_ms = (time.perf_counter() - t0) * 1e3
            pt = profile_trajectory(model.loss, pol, threshold=threshold,
                                    n_steps=n + 1)
            walls, peaks = [], []
            for _ in range(2):              # the walk, then a cached call
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                (p_loss, traj), p_counts = launches_of(
                    lambda: sync_free(lambda: pt(params, batch)))
                walls.append((time.perf_counter() - t0) * 1e3)
                peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            reports[name] = traj
            tot = traj.totals
            ops = traj.op_counts.cpu()
            info[name] = dict(
                loss=float(p_loss), truncate_loss=float(t_loss),
                bit_equal_to_truncate=same_bits(p_loss, t_loss),
                bit_equal_to_memtrace=same_bits(p_loss, m_loss),
                totals_equal_memtrace=(
                    tot.locations == m_rep.locations
                    and all(torch.equal(getattr(tot, k), getattr(m_rep, k))
                            for k in ("flags", "max_rel", "op_counts"))),
                steps_seen=int(traj.steps_seen), rows=traj.n_steps,
                n_locations=len(tot.locations),
                columns=len(traj.column_locations()),
                step_counts_sum_to_totals=torch.equal(
                    ops.sum(0), tot.op_counts.cpu()[list(
                        traj.column_locations())]),
                launches=p_counts, memtrace_launches=m_counts,
                truncate_launches=t_counts, n_traces=pt.n_traces,
                on_card=all(t.is_cuda for t in (
                    traj.max_rel, traj.abs_sum, traj.mag_sum, traj.op_counts,
                    traj.steps_seen)),
                memtrace_ms=m_ms, profile_trajectory_ms=walls,
                peak_memory_gb=peaks)
        torch.cuda.synchronize()
        path_counts = kernels.launch_counts()   # ... and ends here

    # ---- the steps -----------------------------------------------------------
    tail_scopes = ("final_norm", "logits", "loss")
    for name, traj in reports.items():
        ops = traj.op_counts.cpu()
        scopes = traj.scopes
        in_tail = [s.split("/")[0] in tail_scopes for s in scopes]
        i = info[name]
        i["rows_with_counts"] = int((ops.sum(1) > 0).sum())
        i["tail_row_scopes"] = sorted({scopes[c] for c in range(len(scopes))
                                       if ops[n, c] > 0})
        i["tail_row_is_post_loop"] = all(
            (ops[n, c] > 0) == in_tail[c] for c in range(len(scopes)))
        i["loop_rows_hold_no_post_loop_op"] = bool(
            (ops[:n][:, [c for c in range(len(scopes)) if in_tail[c]]]
             == 0).all())
        i["top5_blame"] = [(b.scope, b.onset, b.slope, b.peak_rel)
                           for b in traj.blame(threshold)[:5]]
        i["overhead_memtrace"] = i["memtrace_ms"] / plain_ms
        i["overhead_trajectory"] = [w / plain_ms
                                    for w in i["profile_trajectory_ms"]]
        i["trajectory_over_memtrace"] = (i["profile_trajectory_ms"][0]
                                         / i["memtrace_ms"])
    sc = reports["scoped_e5m7"]
    s_ops = sc.op_counts.cpu()
    per_layer = [seq * cfg.d_ff * 2] + [seq * cfg.d_ff] * 3 \
        + [seq * cfg.d_model]
    info["scoped_e5m7"]["per_layer_counts"] = s_ops[0].tolist()
    info["scoped_e5m7"]["per_layer_counts_by_hand"] = per_layer
    emit("traj_path", model=cfg.name, n_layers=n, d_model=cfg.d_model,
         dtype=cfg.dtype, batch=[1, seq], threshold=threshold,
         plain_ms=plain_ms, plain_loss=float(plain), policies=info,
         launches=path_counts)

    for name, i in info.items():
        check(i["bit_equal_to_truncate"] and i["bit_equal_to_memtrace"],
              name, "profile_trajectory loss != truncate / memtrace", i)
        check(i["totals_equal_memtrace"], name, "totals != memtrace's")
        check(i["steps_seen"] == n and i["rows"] == n + 1, name, i)
        check(i["step_counts_sum_to_totals"], name, "step counts vs totals")
        check(i["launches"]["quantize_em_static"]
              == i["truncate_launches"]["quantize_em_static"]
              == i["memtrace_launches"]["quantize_em_static"], name, i)
        check(i["launches"]["quantize_em_dynamic"] == 0, name, i)
        check(i["n_traces"] == 1 and i["on_card"], name, i)
        check(np.isfinite(i["loss"]), name, i)
        check(i["tail_row_is_post_loop"]
              and i["loop_rows_hold_no_post_loop_op"], name,
              "post-loop ops outside the row after the last step", i)
    sc_info = info["scoped_e5m7"]
    check(sc_info["launches"]["quantize_em_static"] == 5 * n, sc_info)
    check(sc.scopes == ("layer/mlp",) * 5, sc.scopes)
    check(all(s_ops[r].tolist() == per_layer for r in range(n))
          and s_ops[n].tolist() == [0] * 5, "scoped rows", s_ops.tolist())
    ev = info["everywhere_e8m3"]
    check(set(s.split("/")[0] for s in ev["tail_row_scopes"])
          == set(tail_scopes), ev["tail_row_scopes"])
    check(ev["rows_with_counts"] == n + 1, ev["rows_with_counts"])
    del params
    torch.cuda.empty_cache()
    return path_counts



def phase_artifact_path(device, layers, seq):
    """The profile -> warm start -> publish -> deploy loop of the
    reference's acceptance test, on the card: the cold ``autosearch`` of the
    full-width model at depth ``layers``, a trajectory profile of its
    frontier at e8m5, ``ladder_hints`` calibrated by the joint metric, the
    artifact published to a registry in a temporary directory and deployed
    by ``resolve_policy("danube@v1")``, and a re-search warm-started from
    the artifact's hints (the cold assignments in at most 4 dispatches).
    Then the three mini-apps: a search warm-started from ``warm_hints()``
    within the FP64-oracle budget, the cold result with its oracle verdict
    through the registry, and a re-search from its hints."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.apps import APPS, get_app, oracle
    from repro_torch.artifacts import Registry
    from repro_torch.configs import get_config
    from repro_torch.core import (FPFormat, TruncationPolicy, TruncationRule,
                                  profile_trajectory, resolve_policy,
                                  truncate, truncate_sweep)
    from repro_torch.models import Model
    from repro_torch.profile import ladder_hints
    from repro_torch.search import (DEFAULT_WIDTHS, autosearch,
                                    loss_degradation)

    cfg = get_config("h2o-danube-1.8b").replace(n_layers=layers)
    model = Model(cfg)
    params = model.init(seed=0)
    batch = make_batch(cfg, 1, seq, device)
    torch.cuda.synchronize()

    def searched(fn, args, **kw):
        """``autosearch`` with its dynamic-quantizer launches and wall s."""
        before = kernels.launch_counts()["quantize_em_dynamic"]
        t0 = time.perf_counter()
        res = autosearch(fn, args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dyn = kernels.launch_counts()["quantize_em_dynamic"] - before
        return res, dyn, wall

    def site_executions(fn, args, res):
        return truncate_sweep(fn, search_site_policy(res))(
            *args).site_executions

    kernels.reset_launch_counts()               # the artifact path starts
    with tempfile.TemporaryDirectory() as root:
        # ---- the loop on the model ------------------------------------------
        kw = dict(metric=loss_degradation, budget=SEARCH_BUDGET,
                  threshold=SEARCH_THRESHOLD)
        args = (params, batch)
        r0, dyn0, wall0 = searched(model.loss, args, **kw)
        probe = TruncationPolicy(rules=tuple(
            TruncationRule(fmt=FPFormat(8, 5), scope=p)
            for p in r0.assignments))
        with torch.no_grad():
            plain = model.loss(params, batch)
            t0 = time.perf_counter()
            out_lo, traj = sync_free(lambda: profile_trajectory(
                model.loss, probe, threshold=SEARCH_THRESHOLD,
                n_steps=layers + 1)(params, batch))
            torch.cuda.synchronize()
            profile_s = time.perf_counter() - t0
        joint = loss_degradation(plain.cpu().numpy(), out_lo.cpu().numpy())
        hints = ladder_hints(traj, DEFAULT_WIDTHS, SEARCH_THRESHOLD, 5,
                             joint_metric=joint)
        saved = Registry(root).save(r0.to_artifact("danube", hints=hints))
        deployed = resolve_policy("danube@v1", registry=root)
        art = deployed.artifact
        with torch.no_grad():
            cold_loss = truncate(model.loss, r0.policy())(params, batch)
            dep_loss = truncate(model.loss, deployed.policy)(params, batch)
        r1, dyn1, wall1 = searched(model.loss, args, warm_start=art.hints,
                                   **kw)
        r2, dyn2, wall2 = searched(model.loss, args, warm_start=art, **kw)
        execs = site_executions(model.loss, args, r0)
        model_info = dict(
            n_layers=layers, frontier=list(r0.assignments),
            cold=dict(evals=r0.evals_used, dispatches=r0.n_dispatches,
                      s=wall0, assignments=assigns_of(r0)),
            profile=dict(steps_seen=int(traj.steps_seen), s=profile_s,
                         joint_metric=joint,
                         blame=[(b.scope, b.onset, b.peak_rel)
                                for b in traj.blame(SEARCH_THRESHOLD)]),
            hints=hints, saved=saved.to_json(),
            deployed_ref=deployed.ref.to_json(),
            deployed_loss_bit_equal=same_bits(dep_loss, cold_loss),
            warm_hints=dict(evals=r1.evals_used, dispatches=r1.n_dispatches,
                            s=wall1, same=assigns_of(r1) == assigns_of(r0)),
            warm_artifact=dict(evals=r2.evals_used,
                               dispatches=r2.n_dispatches, s=wall2,
                               same=assigns_of(r2) == assigns_of(r0)),
            site_executions=execs, dynamic_launches=[dyn0, dyn1, dyn2])
        check(r0.converged and int(traj.steps_seen) == layers, model_info)
        check(model_info["deployed_loss_bit_equal"],
              "deployed policy's loss != the cold result's",
              float(dep_loss), float(cold_loss))
        check(art.digest == saved.digest == deployed.ref.digest
              and deployed.ref.ref == "danube@v1", "digests", model_info)
        check(art.hints == hints and deployed.policy == r0.policy(),
              "artifact round trip")
        check(model_info["warm_hints"]["same"]
              and model_info["warm_artifact"]["same"]
              and r1.n_dispatches <= 4 and r2.n_dispatches <= 4,
              "warm re-search", model_info)
        for res, dyn in ((r0, dyn0), (r1, dyn1), (r2, dyn2)):
            check(dyn == (res.evals_used + 1) * execs, "launches", dyn,
                  res.evals_used, execs)
        del params, batch, args
        torch.cuda.empty_cache()

        # ---- the three mini-apps ---------------------------------------------
        apps = {}
        for name in sorted(APPS):
            app = get_app(name)
            state = app.init_state()
            ref64 = oracle.fp64_reference(app)
            kw = dict(metric=app.error_metric, budget=APP_BUDGET,
                      threshold=app.search_threshold)
            c0, d0, s0 = searched(app.run_observables, (state,), **kw)
            t0 = time.perf_counter()
            app_hints = app.warm_hints(state)
            hints_s = time.perf_counter() - t0
            ch, dh, sh = searched(app.run_observables, (state,),
                                  warm_start=app_hints, **kw)
            with torch.no_grad():
                mixed0 = truncate(app.run_observables, c0.policy())(state)
                mixedh = truncate(app.run_observables, ch.policy())(state)
            v0 = oracle.verdict(app, mixed0, ref64)
            vh = oracle.verdict(app, mixedh, ref64)
            reg = Registry(root)
            ref = reg.save(v0.attach(c0.to_artifact(name)))
            loaded = Registry(root).load(name)
            cr, dr, sr = searched(app.run_observables, (state,),
                                  warm_start=loaded.hints, **kw)
            execs = site_executions(app.run_observables, (state,), c0)
            apps[name] = dict(
                cold=dict(evals=c0.evals_used, dispatches=c0.n_dispatches,
                          s=s0, oracle_error=v0.error),
                warm_hints=dict(hints=app_hints, s=hints_s,
                                evals=ch.evals_used,
                                dispatches=ch.n_dispatches, search_s=sh,
                                oracle_error=vh.error,
                                same=assigns_of(ch) == assigns_of(c0)),
                from_artifact=dict(evals=cr.evals_used,
                                   dispatches=cr.n_dispatches, s=sr,
                                   same=assigns_of(cr) == assigns_of(c0)),
                budget=app.error_budget, digest=ref.digest,
                site_executions=execs, dynamic_launches=[d0, dh, dr])
            check(c0.converged and ch.converged and cr.converged, name,
                  c0.table(), ch.table(), cr.table())
            check(v0.passed and vh.passed, name, str(v0), str(vh))
            check(loaded.digest == ref.digest and loaded.oracle == v0.to_json()
                  and loaded.policy == c0.policy(), name, "registry trip")
            check(assigns_of(cr) == assigns_of(c0), name, "re-search",
                  c0.table(), cr.table())
            if name == "sod":
                check(cr.n_dispatches < c0.n_dispatches, name,
                      cr.n_dispatches, c0.n_dispatches)
            else:
                check(cr.n_dispatches <= c0.n_dispatches, name,
                      cr.n_dispatches, c0.n_dispatches)
            for res, dyn in ((c0, d0), (ch, dh), (cr, dr)):
                check(dyn == (res.evals_used + 1) * execs, name, "launches",
                      dyn, res.evals_used, execs)
    counts = kernels.launch_counts()            # ... and ends here
    emit("artifact_path", model=cfg.name, d_model=cfg.d_model,
         batch=[1, seq], budget=SEARCH_BUDGET, threshold=SEARCH_THRESHOLD,
         model_loop=model_info, apps=apps, launches=counts)
    return counts


# --------------------------------------------------------------------------
# the train path: loss and gradients truncated under their forward scopes
# --------------------------------------------------------------------------

TRAIN_SEQ = 2048
# AdamW's first steps move every weight by about the learning rate: at
# 1e-3 and 3e-4 the second step overshoots on the one batch (PERF.md)
TRAIN_LR = 1e-4
TRAIN_STEPS = 3
# the default run's depth: the steps at 8 layers keep the run under its
# 600 s budget beside the fp8 and guard paths; --layers 24 runs them whole
TRAIN_LAYERS = 8
TRAIN_IO_LAYERS = 2        # the CLI run and its checkpoint
TRAIN_POLICY = "scope:**/mlp=e5m7"
TRAIN_SWAP = "scope:**/attn/**=e8m3"
# the CPU enumeration the card's sites are held to: the same depth and
# sequence, the smoke config's widths (sites do not depend on widths)
TRAIN_CPU_WIDTHS = dict(d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
                        d_ff=160, vocab=256)
# CUDA ops whose default kernels add with atomics
NONDETERMINISTIC = {"index_put_", "_index_put_impl_", "index_add_",
                    "index_add", "scatter_add", "scatter_add_",
                    "scatter_reduce", "embedding_dense_backward"}
ROOT = os.path.dirname(os.path.abspath(__file__))


def site_split(index):
    """Executions of an enumeration's sites, (forward, recomputed in the
    backward pass, backward)."""
    out = [0, 0, 0]
    for key, n in zip(index.site_keys(), index.counts):
        out[2 if "#grad" in key[0] else 1 if "#remat" in key[0] else 0] += n
    return tuple(out)


def site_list(index):
    """Each site's key, stack, primitive and dtype; the input signature a
    ``shared_body`` frame carries in its path (``#silu((1, 2048, 6912)
    torch.bfloat16)``) holds widths, and is left out."""
    return [((re.sub(r"#(\w+)\((?:\([\d, ]*\)torch\.\w+,?)+\)",
                     r"#\1(...)", k[0]),) + k[1:], s.stack, s.prim,
             str(s.dtype))
            for k, s in zip(index.site_keys(), index.sites)]


def tree_mismatches(a, b) -> int:
    from repro_torch.optim import tree as T
    la, lb = T.leaves(a), T.leaves(b)
    check(len(la) == len(lb), "tree sizes", len(la), len(lb))
    return sum(bit_mismatches(x, y) if x.is_floating_point()
               else int((x != y).sum()) for x, y in zip(la, lb))


def aten_names(fn) -> set:
    """Names of the aten ops ``fn()`` dispatches, backward ops included."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = set()

    class Names(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.add(func._schema.name.split("::")[-1])
            return func(*args, **(kwargs or {}))
    with Names():
        fn()
    return seen


def phase_train_path(device, layers):
    """Training: h2o-danube-1.8b at full width, depth cut to
    ``TRAIN_LAYERS`` (``--layers`` sets it; 24 is full depth), bf16
    parameters with the f32 master copy, B = 1 x 2048 tokens
    from the synthetic pipeline. Three plain steps (twice: the backward must
    be deterministic); three ``make_train_step`` steps under the scoped
    e5m7 policy held bit for bit to ``impl='ref'``, the static quantizer's
    launches to the matched forward + recompute + backward executions; the
    hot-swap step over two tables held bit for bit to the static steps of
    the same policies, one enumeration, the dynamic quantizer's launches to
    the site executions, its site list to the CPU's; ``launch.train
    --production`` with one restore, its checkpoint restored bit for bit,
    at ``TRAIN_IO_LAYERS`` unless ``--layers`` is given (through
    ``main``'s ``n_layers``). No step synchronises with the host."""
    from repro_torch import kernels
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core import TruncationPolicy, truncate_sweep
    from repro_torch.core.policy import parse_policy
    from repro_torch.data import DataConfig, Pipeline, to_device
    from repro_torch.launch import train as train_cli
    from repro_torch.models import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import (TrainConfig, init_opt_state,
                                   make_hotswap_train_step, make_train_step,
                                   value_and_grad)

    cfg = get_config("h2o-danube-1.8b").replace(
        n_layers=layers or TRAIN_LAYERS)
    model = Model(cfg)
    batch = to_device(Pipeline(DataConfig(
        seq_len=TRAIN_SEQ, global_batch=1, vocab=cfg.vocab)).next())
    mlp, attn = parse_policy(TRAIN_POLICY), parse_policy(TRAIN_SWAP)
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    tc = TrainConfig(optimizer=opt_cfg)

    def fresh():
        params = model.init(seed=0)
        return params, init_opt_state(model, params, tc)

    def run(steps, tables=None, sync=True):
        """``steps`` (one step function per step) from the seed-0 state on
        the one batch: (params, losses, grad norms, ms a step, launches by
        kernel)."""
        p, o = fresh()
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        losses, norms, ms = [], [], []
        for i, fn in enumerate(steps):
            extra = (tables[i],) if tables else ()

            def call():
                return fn(p, o, batch, i, *extra)
            t0 = time.perf_counter()
            p, o, m = sync_free(call) if sync else call()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        after = kernels.launch_counts()
        emit("train_path_run", steps=len(steps), ms=ms,
             allocated_gb=round(torch.cuda.memory_allocated() / 2**30, 2),
             peak_gb=round(torch.cuda.max_memory_allocated() / 2**30, 2))
        return (p, torch.stack(losses),
                torch.stack(norms), ms,
                {k: after[k] - before[k] for k in after})

    def equal(a, b):
        return tree_mismatches(a, b) == 0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()               # the train path starts here
    t_start = time.perf_counter()

    # ---- 1. plain steps; the backward must be deterministic ---------------
    plain = make_train_step(model, tc)
    p1, l1, n1, ms_plain, _ = run([plain] * TRAIN_STEPS)
    p2, l2, n2, _, _ = run([plain] * TRAIN_STEPS)
    deterministic = {"default": equal(p1, p2) and equal(l1, l2)
                     and equal(n1, n2)}
    forced_by = []
    if not deterministic["default"]:
        names = aten_names(lambda: plain(*fresh(), batch, 0))
        forced_by = sorted(names & NONDETERMINISTIC)
        torch.use_deterministic_algorithms(True)
        p1, l1, n1, ms_plain, _ = run([plain] * TRAIN_STEPS)
        p2, l2, n2, _, _ = run([plain] * TRAIN_STEPS)
        deterministic["forced"] = equal(p1, p2) and equal(l1, l2)
    check(deterministic.get("forced", deterministic["default"]),
          "train path: two plain runs differ", deterministic)
    plain_losses = [float(x) for x in l1]
    check(all(math.isfinite(x) for x in plain_losses)
          and plain_losses[-1] < plain_losses[0],
          "train path: plain loss not finite and falling", plain_losses)
    del p1, p2

    # ---- 2. make_train_step under the scoped policy, against impl='ref' ---
    static = make_train_step(model, TrainConfig(optimizer=opt_cfg,
                                                policy=mlp))
    pt, lt, nt, ms_trunc, ct = run([static] * TRAIN_STEPS)
    ref = make_train_step(model, TrainConfig(optimizer=opt_cfg, policy=mlp,
                                             policy_impl="ref"))
    # the plain quantizer builds its constants from the host: no sync check
    pr, lr_, nr, _, _ = run([ref] * TRAIN_STEPS, sync=False)
    static_bits = dict(loss=tree_mismatches(lt, lr_),
                       grad_norm=tree_mismatches(nt, nr),
                       params=tree_mismatches(pt, pr))
    del pr, pt
    matched = truncate_sweep(value_and_grad(model.loss), mlp)(
        model.init(seed=0), batch).index
    fwd, remat_, bwd = site_split(matched)
    static_launches = ct["quantize_em_static"]
    check(sum(static_bits.values()) == 0, "train path: truncate vs ref",
          static_bits)
    check(static_launches == TRAIN_STEPS * matched.executions and bwd > 0,
          "train path: static launches", static_launches, fwd, remat_, bwd)
    check(float(lt[-1]) != plain_losses[-1], "train path: the policy bit")
    check(bool(torch.isfinite(lt).all() & torch.isfinite(nt).all()),
          "train path: truncated steps not finite", lt, nt)

    # ---- 3. the hot-swap step over two tables --------------------------------
    site = TruncationPolicy(rules=mlp.rules + attn.rules)
    hot, sites = make_hotswap_train_step(model, tc, site, model.init(seed=0),
                                         batch)
    pols = [mlp, attn, mlp][:TRAIN_STEPS]
    tables = [hot.device_table(sites.table_for(p)) for p in pols]
    ph, lh, nh, ms_hot, ch = run([hot] * TRAIN_STEPS, tables)
    by_pol = {id(mlp): static,
              id(attn): make_train_step(model, TrainConfig(
                  optimizer=opt_cfg, policy=attn))}
    ps, ls, ns, _, _ = run([by_pol[id(p)] for p in pols])
    hot_bits = dict(loss=tree_mismatches(lh, ls),
                    grad_norm=tree_mismatches(nh, ns),
                    params=tree_mismatches(ph, ps))
    del ps, ph
    dyn_launches = ch["quantize_em_dynamic"]
    check(sum(hot_bits.values()) == 0, "train path: hot vs static",
          hot_bits)
    check(bool(torch.isfinite(lh).all()), "train path: hot steps", lh)
    check(hot.sweep.n_traces == 1, "train path: n_traces",
          hot.sweep.n_traces)
    check(dyn_launches == TRAIN_STEPS * sites.executions,
          "train path: dynamic launches", dyn_launches, sites.executions)
    # the thread check: the card's backward runs on autograd's device
    # thread, the CPU's on the caller's; the sites must be the same
    t0 = time.perf_counter()
    # the sites of the layers are one set at any depth: two layers suffice
    small = Model(cfg.replace(**TRAIN_CPU_WIDTHS, n_layers=2))
    cpu_params = small.init(seed=0, device="cpu")
    cpu_batch = {k: v.cpu() % TRAIN_CPU_WIDTHS["vocab"]
                 for k, v in batch.items()}
    cpu_sites = truncate_sweep(value_and_grad(small.loss), site,
                               device="cpu")(cpu_params, cpu_batch).index
    cpu_s = time.perf_counter() - t0
    card_list, cpu_list = site_list(sites), site_list(cpu_sites)
    same_sites = card_list == cpu_list
    check(same_sites, "train path: card and CPU sites differ",
          len(cpu_sites), len(sites), [
              (a, b) for a, b in zip(card_list, cpu_list) if a != b][:6])
    del cpu_params
    sites_by_scope = {}
    for s_ in sites.sites:
        sites_by_scope[s_.scope] = sites_by_scope.get(s_.scope, 0) + 1
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # ---- 4. launch.train --production, one restore; the checkpoint of its
    # first run restored bit for bit -----------------------------------------
    # the full-depth state is 25.6 GB: its writes and reads would not fit
    # the default run's time, so there this part runs at a cut depth
    io_layers = TRAIN_IO_LAYERS if layers is None else cfg.n_layers
    cli_dir = os.path.join(ROOT, "build", "train_cli")
    if os.path.exists(cli_dir):
        shutil.rmtree(cli_dir)
    argv = ["--production", "--arch", "h2o-danube-1.8b", "--policy",
            TRAIN_POLICY, "--device", "cuda", "--seq", str(TRAIN_SEQ),
            "--global-batch", "4", "--save-every", "2", "--ckpt", cli_dir]
    t0 = time.perf_counter()
    first = train_cli.main(argv + ["--steps", "2"], n_layers=io_layers)
    cli_s = time.perf_counter() - t0
    saved = (first["state"]["params"], first["state"]["opt"])
    ck_gb = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(cli_dir) for f in fs) / 2**30
    t0 = time.perf_counter()
    restored, manifest = Checkpointer(cli_dir).restore(saved)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    ck_bits = tree_mismatches(saved, restored)
    check(ck_bits == 0 and manifest["step"] == 2,
          "train path: checkpoint round trip", ck_bits)
    del first["state"], saved, restored
    t0 = time.perf_counter()
    second = train_cli.main(argv + ["--steps", "4"], n_layers=io_layers)
    cli_s += time.perf_counter() - t0
    del second["state"]
    shutil.rmtree(cli_dir)
    cli_ok = (first["final_step"] == 2 and second["final_step"] == 4
              and sorted(second["losses"]) == [2, 3]
              and all(math.isfinite(v) for v in second["losses"].values()))
    check(cli_ok, "train path: launch.train", first["losses"],
          second["losses"])
    counts = kernels.launch_counts()            # ... and ends here
    torch.cuda.empty_cache()

    def med(xs):
        return statistics.median(xs[1:]) if len(xs) > 1 else xs[0]
    emit("train_path", model=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab,
         n_params=model.n_params(), dtype=cfg.dtype, batch=[1, TRAIN_SEQ],
         remat=cfg.remat, lr=TRAIN_LR, steps=TRAIN_STEPS,
         policy=TRAIN_POLICY, swap_policy=TRAIN_SWAP,
         grad_norms=dict(plain=[float(x) for x in n1],
                         truncated=[float(x) for x in nt],
                         hotswap=[float(x) for x in nh]),
         plain_losses=plain_losses,
         truncated_losses=[float(x) for x in lt],
         hotswap_losses=[float(x) for x in lh],
         deterministic=deterministic, deterministic_forced_by=forced_by,
         truncate_vs_ref_mismatches=static_bits,
         hotswap_vs_static_mismatches=hot_bits,
         matched_site_executions=dict(forward=fwd, recompute=remat_,
                                      backward=bwd,
                                      total=matched.executions),
         static_launches=static_launches,
         hotswap_sites=len(sites), hotswap_site_executions=sites.executions,
         hotswap_site_split=site_split(sites), dynamic_launches=dyn_launches,
         n_traces=hot.sweep.n_traces, sites_by_scope=sites_by_scope,
         cpu_sites_equal=same_sites, cpu_enumeration_s=round(cpu_s, 1),
         ms_plain_step=med(ms_plain), ms_truncated_step=med(ms_trunc),
         ms_hotswap_step=med(ms_hot), ms_steps=dict(
             plain=ms_plain, truncated=ms_trunc, hotswap=ms_hot),
         peak_gb=round(peak_gb, 2), io_layers=io_layers,
         checkpoint_gb=round(ck_gb, 2),
         checkpoint_restore_s=round(restore_s, 1),
         cli_s=round(cli_s, 1), cli_losses={
             **{str(k): v for k, v in first["losses"].items()},
             **{str(k): v for k, v in second["losses"].items()}},
         seconds=round(time.perf_counter() - t_start, 1))
    return {k: counts[k] for k in counts}


GRAD_PROFILE_STEPS = 16        # the trajectory's ring: 8 layers, twice


def phase_grad_profile_path(device, layers):
    """Profiling a training loss: ``profile_counts``, ``memtrace`` and
    ``profile_trajectory`` of ``value_and_grad(model.loss)`` for
    h2o-danube-1.8b at full width, the train path's depth
    (``TRAIN_LAYERS``; ``--layers`` sets it) and batch (1 x 2048, ``remat``
    on), under the train path's ``scope:**/mlp=e5m7``. The counts: forward
    and backward FLOPs beside the loss forward's, no launch. ``memtrace``:
    the loss and every gradient bit for bit ``truncate``'s, the static
    quantizer's launches = the matched forward + recompute + backward site
    executions (the train path's per-step count), forward, recompute and
    backward locations, no host synchronisation, one walk of the policy
    over two calls; its peak memory and time over the plain step's. The
    trajectory: a step per layer, forward then backward, its totals
    ``memtrace``'s."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import (memtrace, profile_counts,
                                  profile_trajectory, truncate,
                                  truncate_sweep)
    from repro_torch.core.memmode import BACKWARD_PREFIX, RECOMPUTE_PREFIX
    from repro_torch.core.policy import parse_policy
    from repro_torch.data import DataConfig, Pipeline, to_device
    from repro_torch.models import Model
    from repro_torch.optim import tree as T
    from repro_torch.train import value_and_grad

    t_start = time.perf_counter()
    cfg = get_config("h2o-danube-1.8b").replace(
        n_layers=layers or TRAIN_LAYERS)
    model = Model(cfg)
    params = model.init(seed=0)
    batch = to_device(Pipeline(DataConfig(
        seq_len=TRAIN_SEQ, global_batch=1, vocab=cfg.vocab)).next())
    policy = parse_policy(TRAIN_POLICY)
    step = value_and_grad(model.loss)
    torch.cuda.synchronize()

    # ---- the counts: one plain run each, no quantizer --------------------
    counted, count_launches = launches_of(
        lambda: profile_counts(step, policy)(params, batch))
    fwd_counted = profile_counts(model.loss, policy)(params, batch)
    n_tokens = TRAIN_SEQ
    counts = dict(
        step_gflop=counted.total_flops / 1e9,
        forward_gflop=fwd_counted.total_flops / 1e9,
        step_over_forward=counted.total_flops / fwd_counted.total_flops,
        gflop_by_fmt={k: v / 1e9 for k, v in counted.flops_by_fmt.items()},
        model_flops_step_over_forward=(6.0 * model.n_active_params()
                                       * n_tokens)
        / (2.0 * model.n_active_params() * n_tokens),
        launches=count_launches)

    # ---- truncate, the plain step and the matched site executions --------
    torch.cuda.reset_peak_memory_stats()
    plain_ms = timed(lambda: step(params, batch), reps=2)
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    (t_loss, t_grads), t_launches = launches_of(
        lambda: truncate(step, policy)(params, batch))
    matched = truncate_sweep(step, policy)(params, batch).index
    fwd, rem, bwd = site_split(matched)

    # ---- memtrace ---------------------------------------------------------
    kernels.reset_launch_counts()         # the grad profile path starts here
    mt = memtrace(step, policy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ((m_loss, m_grads), rep), m_launches = launches_of(
        lambda: sync_free(lambda: mt(params, batch)))
    first_ms = (time.perf_counter() - t0) * 1e3
    mem_peak = torch.cuda.max_memory_allocated() / 2**30
    mem_ms = timed(lambda: sync_free(lambda: mt(params, batch)), reps=1)
    grad_bits = sum(bit_mismatches(a, b) for a, b in
                    zip(T.leaves(m_grads), T.leaves(t_grads)))
    kinds = {"forward": 0, "recompute": 0, "backward": 0}
    for loc in rep.locations:
        kinds["recompute" if loc.startswith(RECOMPUTE_PREFIX) else
              "backward" if loc.startswith(BACKWARD_PREFIX)
              else "forward"] += 1

    # ---- the trajectory ---------------------------------------------------
    (_, traj), tr_launches = launches_of(lambda: sync_free(
        lambda: profile_trajectory(step, policy, n_steps=GRAD_PROFILE_STEPS)(
            params, batch)))
    path_counts = kernels.launch_counts()         # ... and ends here
    totals_equal = traj.totals.locations == rep.locations and all(
        torch.equal(getattr(traj.totals, k), getattr(rep, k))
        for k in ("flags", "max_rel", "op_counts"))
    steps_seen = int(traj.steps_seen)
    flags = rep.flags.cpu()
    info = dict(
        model=cfg.name, n_layers=cfg.n_layers, batch=[1, TRAIN_SEQ],
        remat=cfg.remat, policy=TRAIN_POLICY, counts=counts,
        plain_step_ms=plain_ms, plain_peak_gb=round(plain_peak, 2),
        memtrace_first_ms=first_ms, memtrace_ms=mem_ms,
        memtrace_over_plain=mem_ms / plain_ms,
        memtrace_peak_gb=round(mem_peak, 2),
        memtrace_peak_over_plain=mem_peak / plain_peak,
        loss=float(m_loss), loss_bit_equal=same_bits(m_loss, t_loss),
        grad_mismatching_bits=grad_bits,
        static_launches=m_launches["quantize_em_static"],
        truncate_static_launches=t_launches["quantize_em_static"],
        matched_site_executions=dict(forward=fwd, recompute=rem,
                                     backward=bwd, total=matched.executions),
        n_locations=len(rep.locations), locations_by_kind=kinds,
        total_flags=int(flags.sum()), n_traces=mt.n_traces,
        top5=[[loc, f, m] for loc, f, m in rep.top(5)],
        trajectory=dict(steps_seen=steps_seen, n_steps=GRAD_PROFILE_STEPS,
                        totals_equal_memtrace=totals_equal,
                        launches=tr_launches),
        launches=path_counts,
        seconds=round(time.perf_counter() - t_start, 1))
    emit("grad_profile_path", **info)
    check(counts["step_over_forward"] > 3.0 and sum(
        count_launches.values()) == 0, "grad profile: counts", counts)
    check(info["loss_bit_equal"] and grad_bits == 0,
          "grad profile: memtrace != truncate", info)
    check(info["static_launches"] == matched.executions
          == info["truncate_static_launches"] and bwd > 0 and rem > 0,
          "grad profile: static launches", info)
    check(m_launches["quantize_em_dynamic"] == 0, m_launches)
    check(all(n > 0 for n in kinds.values()), "grad profile: kinds", kinds)
    check(mt.n_traces == 1, "grad profile: n_traces", mt.n_traces)
    check(steps_seen == 2 * cfg.n_layers and totals_equal,
          "grad profile: trajectory", info["trajectory"])
    check(math.isfinite(info["loss"]), info)
    return path_counts


# the learning rates and depths of phase ``train_lr``
TRAIN_LRS = (1e-3, 3e-4, 1e-4)
TRAIN_LR_DEPTHS = (1, 2, 4, 8, 24)


def phase_train_lr(device, layers):
    """The train path's plain steps at each of ``TRAIN_LRS``: its batch,
    ``Model.init(seed=0)``, bf16 parameters with the f32 master copy, at
    each depth of ``TRAIN_LR_DEPTHS`` (``--layers`` alone if given), and in
    f32 at the deepest. Shows where AdamW's second step overshoots on the
    one batch; ``tests/torch_lr_witness.py`` runs the reference beside the
    port on the CPU for the same question."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, Pipeline, to_device
    from repro_torch.models import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import (TrainConfig, init_opt_state,
                                   make_train_step)

    cfg = get_config("h2o-danube-1.8b")
    batch = to_device(Pipeline(DataConfig(
        seq_len=TRAIN_SEQ, global_batch=1, vocab=cfg.vocab)).next())
    depths = (layers,) if layers is not None else TRAIN_LR_DEPTHS
    runs = [(d, cfg.dtype) for d in depths] + [(depths[-1], "float32")]
    for depth, dtype in runs:
        model = Model(cfg.replace(n_layers=depth, dtype=dtype))
        for lr in TRAIN_LRS:
            tc = TrainConfig(optimizer=AdamWConfig(lr=lr))
            params = model.init(seed=0)
            opt = init_opt_state(model, params, tc)
            step = make_train_step(model, tc)
            losses, norms = [], []
            for i in range(TRAIN_STEPS):
                params, opt, m = step(params, opt, batch, i)
                losses.append(m["loss"])
                norms.append(m["grad_norm"])
            emit("train_lr", n_layers=depth, dtype=dtype, lr=lr,
                 batch=[1, TRAIN_SEQ], losses=[float(x) for x in losses],
                 grad_norms=[float(x) for x in norms])
            del params, opt, step
        torch.cuda.empty_cache()


def event_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_times(device, seq):
    """Each kernel at the largest shapes the main path gives it, beside its
    bound, its plain version and the library call of the same function."""
    from repro_torch.core.formats import parse_format
    from repro_torch.kernels.quantize_em import kernel as qk, ops, ref

    g = torch.Generator(device=device)
    g.manual_seed(0)
    shapes = {
        "wi_out_bf16": ((1, seq, 13824), torch.bfloat16),
        "logits_f32": ((1, seq, 32000), torch.float32),
    }
    rows = []
    for label, (shape, dt) in shapes.items():
        x = (torch.randn(shape, generator=g, device=device,
                         dtype=torch.float32) * 4).to(dt)
        n = x.numel()
        bytes_ms = 2 * x.element_size() * n / PEAK_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_ELEMENT * n / PEAK_F32_OPS_PER_S * 1e3
        for spec in ("e5m7", "e8m7"):
            fmt = parse_format(spec)
            row = torch.tensor(ops.format_row(fmt), device=device)
            lib = None
            if spec == "e8m7" and dt == torch.float32:
                # the one library call that computes the same function
                lib = event_ms(lambda: x.to(torch.bfloat16).to(dt))
            k1 = qk.quantize_em_static(x, fmt)
            k2 = qk.quantize_em_dynamic(x, row)
            p1 = ref.quantize_ref_fmt(x.to(torch.float32), fmt).to(dt)
            for name, out, run, plain in (
                    ("quantize_em_static", k1,
                     lambda: qk.quantize_em_static(x, fmt),
                     lambda: ref.quantize_ref_fmt(
                         x.to(torch.float32), fmt).to(dt)),
                    ("quantize_em_dynamic", k2,
                     lambda: qk.quantize_em_dynamic(x, row),
                     lambda: ops.quantize_dynamic(x, row, impl="ref"))):
                rows.append(dict(
                    name=name, shape=list(shape), dtype=str(dt), fmt=spec,
                    label=label, mismatches=bit_mismatches(out, p1),
                    max_abs_err=max_abs_err(out, p1),
                    ms=event_ms(run), plain_ms=event_ms(plain, reps=5),
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=lib))
            del k1, k2, p1
        del x
        torch.cuda.empty_cache()
    check(all(r["mismatches"] == 0 for r in rows), rows)
    emit("times", peak_bytes_per_s=PEAK_BYTES_PER_S,
         peak_f32_ops_per_s=PEAK_F32_OPS_PER_S,
         ops_per_element=OPS_PER_ELEMENT, kernels=rows)
    return rows


def phase_fused_times(device, seq, wkv_seq):
    """The flash-attention and WKV6 kernels at the fused path's shapes,
    beside their bounds, their plain versions and the library call of the
    same function (SDPA for attention; none computes the WKV6 recurrence)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk, ops as fops
    from repro_torch.kernels.rwkv6 import kernel as wk, ref as wref

    # flash attention at the path's shape, bf16 (the tensor-core kernel) and
    # f32 (the CUDA-core kernel), each beside SDPA on the same inputs. The
    # bound counts what the function needs: 2 (D + Dv) flop an unmasked
    # pair (flops), at the tensor-core rate for bf16 and at the f32 rate,
    # the f32 floor, for f32; kernel_flops is what the bf16 kernel gives the
    # tensor cores: S = Q K^T and P V three times (P split in three bf16
    # terms)
    rows = []
    W = 4096
    pairs = 32 * flash_pairs(seq, W)
    i = torch.arange(seq, device=device)
    mask = (i[:, None] >= i[None, :]) & ((i[:, None] - i[None, :]) < W)
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = flash_path_inputs(device, seq, dt)
        D, Dv = q.shape[-1], v.shape[-1]
        scale = 1.0 / float(np.sqrt(D))
        flops = pairs * 2 * (D + Dv)
        kernel_flops = pairs * 2 * (D + 3 * Dv) if dt == torch.bfloat16 \
            else flops
        nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                     + q.numel())
        peak = PEAK_BF16_OPS_PER_S if dt == torch.bfloat16 \
            else PEAK_F32_OPS_PER_S
        ops_ms = flops / peak * 1e3
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        with torch.no_grad():
            lib_out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                     enable_gqa=True)
            ours = fk.flash_attention_cuda(q, k, v, None, True, W, scale)
            rows.append(dict(
                name="flash_attention", label=f"path_{str(dt)[6:]}", fmt=None,
                shape=[list(q.shape), list(k.shape)], dtype=str(q.dtype),
                window=W,
                ms=event_ms(lambda: fk.flash_attention_cuda(
                    q, k, v, None, True, W, scale)),
                plain_ms=event_ms(lambda: fops.flash_attention(
                    q, k, v, window=W, impl="ref"), reps=5, warmup=1),
                library_ms=event_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True), reps=10),
                library_vs_kernel_max_abs_err=max_abs_err(lib_out, ours),
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                unmasked_pairs=pairs, flops=flops, kernel_flops=kernel_flops,
                bytes=nbytes,
                f32_cuda_core_floor_ms=flops / PEAK_F32_OPS_PER_S * 1e3))
        rows[-1]["bound_share"] = rows[-1]["bound_ms"] / rows[-1]["ms"]
        del q, k, v, lib_out, ours
        torch.cuda.empty_cache()
    del mask

    B, H, hd = WKV_PATH["B"], WKV_PATH["H"], WKV_PATH["hd"]
    r, k, v, w, u, s0 = wkv_inputs(device, B, H, wkv_seq, hd)
    tokens = B * H * wkv_seq
    # what the function needs a token and head: r S (2 hd^2), w * S, k^T v
    # and their sum (3 hd^2); the bonus r diag(u) k^T v has rank one,
    # v_j * sum_i r_i u_i k_i (3 hd), added to y (2 hd)
    flops = (5 * hd * hd + 5 * hd) * tokens
    nbytes = (sum(t.numel() * t.element_size() for t in (r, k, v, w, u, s0))
              + 4 * (r.numel() + s0.numel()))         # y and sT written
    ops_ms = flops / PEAK_F32_OPS_PER_S * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    # the least the contract lets the kernel issue: 4 f32 instructions per
    # state element and token (k v, the fma of r with S, w * S, + k v; w * S
    # + k v may not be contracted), one warp instruction per 32 elements, on
    # 132 SMs x 4 schedulers at the 1.98 GHz of the data-sheet f32 rate
    warp_instr = 4 * hd * hd * tokens / 32
    floor_ms = warp_instr / (132 * 4 * 1.98e9) * 1e3
    with torch.no_grad():
        rows.append(dict(
            name="wkv6", shape=[B, H, wkv_seq, hd],
            dtype=f"r/k/v {r.dtype}, w {w.dtype}",
            ms=event_ms(lambda: wk.wkv6_cuda(r, k, v, w, u, s0, None, 64)),
            plain_ms=event_ms(lambda: wref.wkv6_ref(r, k, v, w, u, s0),
                              reps=3, warmup=1),
            library_ms=None, bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            instruction_floor_ms=floor_ms, flops=flops, bytes=nbytes))
        rows[-1]["bound_share"] = rows[-1]["bound_ms"] / rows[-1]["ms"]
        rows[-1]["instruction_floor_share"] = floor_ms / rows[-1]["ms"]
    emit("fused_times", peak_bf16_ops_per_s=PEAK_BF16_OPS_PER_S,
         peak_f32_ops_per_s=PEAK_F32_OPS_PER_S,
         peak_bytes_per_s=PEAK_BYTES_PER_S, kernels=rows)
    return rows


def profile_runs(phase, runs, reps=1, **extra):
    """Device time by kernel name of each run in ``runs`` (name -> a call
    that ends in a host read-back or is synchronised here), its wall time
    unprofiled and under the profiler, and the device's busy time: one JSON
    line ``phase`` per run. Each run is called ``reps`` times inside the
    profiled window."""
    from torch.profiler import ProfilerActivity, profile
    for name, fn in runs.items():
        fn()                              # warm-up: a wrapper's first walk
        wall_ms = timed(fn)               # unprofiled
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / reps
        # device-side events only: host-side op events carry their
        # kernels' time a second time
        rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        emit(phase, run=name, **extra, wall_ms=wall_ms,
             wall_ms_under_profiler=profiled_ms, device_busy_ms=busy,
             device_idle_share_under_profiler=1 - busy / profiled_ms,
             n_device_kernels=sum(r[2] for r in rows),
             top=[dict(kernel=k[:80], ms=round(ms, 3), calls=c)
                  for k, ms, c in rows[:14]])


def phase_profile(device, layers, seq):
    """Where the time goes: device time by kernel name for the plain
    forward, one swept forward (every float result a site, e8m7 table) and
    one ``memtrace`` forward under the same policy; then one glm4-9b decode
    tick at full width and depth (4 slots at cursor 32, the logits read
    back) plain, under ``truncate`` scoped to ``**/mlp`` and under
    ``memtrace``. Not part of the default run: ``--phases profile``."""
    from repro_torch.configs import get_config
    from repro_torch.core import (TruncationPolicy, memtrace, truncate,
                                  truncate_sweep)
    from repro_torch.core.policy import parse_policy
    from repro_torch.models import Model

    cfg = get_config("h2o-danube-1.8b")
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    model = Model(cfg)
    params = model.init(seed=0)
    batch = make_batch(cfg, 1, seq, device)
    everywhere = TruncationPolicy.everywhere("e8m7")
    with torch.no_grad():
        handle = truncate_sweep(model.loss, everywhere)(params, batch)
        table = handle.device_table(handle.table(everywhere))
        traced = memtrace(model.loss, everywhere)
        profile_runs("profile", {
            "plain": lambda: model.loss(params, batch),
            "sweep_e8m7": lambda: handle(table),
            "memtrace_e8m7": lambda: traced(params, batch)},
            n_layers=cfg.n_layers)
    del params, handle, table, traced
    torch.cuda.empty_cache()

    cfg = get_config("glm4-9b")
    model = Model(cfg)
    params = model.init(seed=0)
    policy = parse_policy(SERVE_POLICY)
    tokens = torch.arange(1, SERVE_BATCH + 1, dtype=torch.int32,
                          device=device)
    with torch.no_grad():
        cache = model.init_cache(SERVE_BATCH, SERVE_SEQ)
        cache["pos"].fill_(32)
        calls = aten_calls(lambda: model.decode_step(params, cache, tokens))
        lossy = truncate(model.decode_step, policy)
        shadowed = memtrace(model.decode_step, policy)
        profile_runs("profile_decode", {
            "plain": lambda: model.decode_step(
                params, cache, tokens)[0].cpu(),
            "truncate_mlp_e5m7": lambda: lossy(
                params, cache, tokens)[0].cpu(),
            "memtrace_mlp_e5m7": lambda: shadowed(
                params, cache, tokens)[0][0].cpu()},
            reps=5, model=cfg.name, n_layers=cfg.n_layers,
            batch=SERVE_BATCH, max_seq=SERVE_SEQ, aten_calls_plain=calls)
    del params, cache, lossy, shadowed
    torch.cuda.empty_cache()
    phase_profile_train(device, layers)


def phase_profile_train(device, layers):
    """One train step of h2o-danube-1.8b at the train path's shape, plain
    and under ``make_train_step`` scoped to ``**/mlp`` e5m7: device busy
    against wall time (``profile_train`` lines)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import parse_policy
    from repro_torch.data import DataConfig, Pipeline, to_device
    from repro_torch.models import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import TrainConfig, init_opt_state, make_train_step

    cfg = get_config("h2o-danube-1.8b")
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    model = Model(cfg)
    params = model.init(seed=0)
    tc = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR))
    opt = init_opt_state(model, params, tc)
    batch = to_device(Pipeline(DataConfig(
        seq_len=TRAIN_SEQ, global_batch=1, vocab=cfg.vocab)).next())
    plain = make_train_step(model, tc)
    lossy = make_train_step(model, TrainConfig(
        optimizer=tc.optimizer, policy=parse_policy(TRAIN_POLICY)))
    calls = aten_calls(lambda: plain(params, opt, batch, 0))
    profile_runs("profile_train", {
        "plain": lambda: plain(params, opt, batch, 0)[2]["loss"].cpu(),
        "truncate_mlp": lambda: lossy(
            params, opt, batch, 0)[2]["loss"].cpu()},
        model=cfg.name, n_layers=cfg.n_layers, batch=[1, TRAIN_SEQ],
        policy=TRAIN_POLICY,
        aten_calls_plain=calls)


def aten_calls(fn) -> int:
    """The aten calls ``fn()`` dispatches (what the walk intercepts)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return Count.n


def phase_isa():
    """Registers and spills of every WKV6 kernel and of the fp8 dot kernel
    (``nvcc -Xptxas -v`` with each library's own flags), which no profiler
    on the card's machine shows. Fails if the main path's WKV6 kernel (bf16
    r/k/v, f32 w, hd 64) or an fp8 dot kernel spills. Not part of the
    default run: ``--phases isa``."""
    import re
    import tempfile
    from repro_torch.kernels import _build
    from repro_torch.kernels import fp8_dot as f8
    from repro_torch.kernels.quantize_em.kernel import _FLAGS
    from repro_torch.kernels.rwkv6 import kernel as wk

    with tempfile.TemporaryDirectory() as tmp:
        log = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, *_FLAGS,
             "-I", str(_build.INCLUDE_DIR), "-Xptxas", "-v",
             "-o", os.path.join(tmp, "wkv6.so"), str(wk._SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=600,
            check=True).stdout.decode()
        fp8_log = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS,
             "-I", str(_build.INCLUDE_DIR), "-Xptxas", "-v",
             "-o", os.path.join(tmp, "fp8_dot.so"), str(f8._SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=600,
            check=True).stdout.decode()
    # keyed by the mangled template arguments: r/k/v type, w type, HD, R,
    # JT, JB, e.g. 13__nv_bfloat16fLi64ELi4ELi2ELi16
    kernels = {m.group(1): dict(spill_store_bytes=int(m.group(2)),
                                registers=int(m.group(3)))
               for m in re.finditer(
                   r"Function properties for \S*wkv6_kernelI(\w+?)"
                   r"EEEvNS_4ArgsE\n[^\n]*?(\d+) bytes spill stores"
                   r"[^\n]*\n[^\n]*?Used (\d+) registers", log)}
    path = kernels.get("13__nv_bfloat16fLi64ELi4ELi2ELi16")
    # the fp8 dot kernel, one instance per output type (f, 13__nv_bfloat16,
    # 6__half)
    fp8_kernels = {m.group(1): dict(spill_store_bytes=int(m.group(2)),
                                    registers=int(m.group(3)))
                   for m in re.finditer(
                       r"Function properties for \S*?(fp8_dot_sm90I\w+?E)"
                       r"\S*\n[^\n]*?(\d+) bytes spill stores[^\n]*\n"
                       r"[^\n]*?Used (\d+) registers", fp8_log)}
    emit("isa", kernels=kernels, fp8_kernels=fp8_kernels)
    check(len(kernels) == 4 * len(wk.HEAD_DIMS), "isa: kernels found",
          sorted(kernels))
    check(path is not None and path["spill_store_bytes"] == 0,
          "isa: the path kernel spills", path)
    check(len(fp8_kernels) == 3 and all(v["spill_store_bytes"] == 0
                                         for v in fp8_kernels.values()),
          "isa: the fp8 dot kernel spills", fp8_kernels)


# ---------------------------------------------------------------------------
# the fp8 dot kernel: against its plain version, timed, and on its path
# ---------------------------------------------------------------------------

# h2o-danube-1.8b's MLP products at S = 8192: x @ wi (gate and up fused),
# h @ wo
FP8_MLP_SHAPES = {"mlp_wi": (8192, 2560, 13824), "mlp_wo": (8192, 6912, 2560)}
# native against emulated loss on the fp8 path: both sum the same exact
# products of e4m3 values in f32 (the kernel per k-tile of 128 on the
# tensor cores, then across k-tiles in order; cuBLAS's bf16 GEMM in its
# own order) and round each MLP product once to bf16, so an element may
# land one bf16 step (2^-8 relative) apart; the mean loss over 8192 tokens
# moves far less
FP8_LOSS_RTOL = 1e-3
# the fp8 path's default depth, for the default run's 600 s budget (24
# layers took 24.8 s); --layers 24 runs it whole
FP8_LAYERS = 12


def fp8_operand(g, shape, device, scale, saturate=True, spread=0):
    """An operand on the e4m3 grid. ``spread`` scales each element by a
    random power of two in [2^-spread, 2^spread): over a wide exponent
    range the f32 sums of the products are no longer exact, and the
    summation order shows."""
    from repro_torch.kernels import fp8_dot as f8
    x = randn(g, shape, device, scale=scale)
    if spread:
        x = x * torch.exp2(torch.randint(-spread, spread, shape, generator=g,
                                         device=device).to(torch.float32))
    return f8.encode_e4m3(f8.quantize_dot_operand(x, saturate=saturate))


def fp8_hold(a, b, label):
    """The kernel against its plain version on fp8 operands ``a`` (batch,
    M, K) and ``b`` (batch, K, N): NaNs where the plain version has them,
    every finite element within ``K * 2^-23 * (|a| @ |b|)`` (both sum exact
    products in f32, each within ``K * 2^-24`` of the exact dot), and the
    bf16 result the f32 one rounded once."""
    from repro_torch.kernels import fp8_dot as f8
    got = f8.fp8_dot_cuda(a, b, torch.float32)
    want = f8.fp8_dot_ref(a, b, torch.float32)
    scale = f8.fp8_dot_ref(a.to(torch.float32).abs().to(f8.F8_DTYPE),
                           b.to(torch.float32).abs().to(f8.F8_DTYPE))
    bound = a.shape[-1] * 2.0 ** -23 * scale
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    fin = ~nan_want
    err = (got - want).abs()[fin]
    over = float((err / bound[fin].clamp_min(1e-30)).max()) if err.numel() \
        else 0.0
    within = bool((err <= bound[fin]).all())
    got16 = f8.fp8_dot_cuda(a, b, torch.bfloat16)
    bf16_once = bit_mismatches(got16, got.to(torch.bfloat16))
    torch.cuda.synchronize()
    return dict(label=label, a=list(a.shape), b=list(b.shape),
                b_strides=list(b.stride()),
                max_abs_err=float(err.max()) if err.numel() else 0.0,
                max_err_over_bound=over, within_bound=within,
                nan_equal=bool(torch.equal(nan_got, nan_want)),
                nans=int(nan_want.sum()), bf16_mismatches=bf16_once)


def phase_fp8_kernels(device):
    """The fp8 dot kernel against its plain version on the card: the MLP
    products of h2o-danube-1.8b, a ragged small shape, a batched one with a
    transposed right operand, and operands out of e4m3's range, saturated
    and not (NaN storage where the reference stores NaN)."""
    from repro_torch.kernels import fp8_dot as f8
    g = torch.Generator(device=device)
    g.manual_seed(0)
    cases = []
    for label, (m, k, n) in FP8_MLP_SHAPES.items():
        a = fp8_operand(g, (1, m, k), device, 2.0, spread=4)
        b = fp8_operand(g, (1, k, n), device, 0.05, spread=4)
        cases.append(fp8_hold(a, b, label))
        del a, b
        torch.cuda.empty_cache()
    cases.append(fp8_hold(fp8_operand(g, (1, 77, 131), device, 3.0),
                          fp8_operand(g, (1, 131, 45), device, 3.0),
                          "ragged"))
    bt = fp8_operand(g, (6, 130, 96), device, 1.0, spread=4)
    cases.append(fp8_hold(fp8_operand(g, (6, 200, 96), device, 1.0,
                                      spread=4),
                          bt.transpose(1, 2), "batched_rhs_transposed"))
    # out of range: |x| up to 1e4 and infinities, through fp8_dot_general
    specials = []
    for sat in (True, False):
        # in e4m3's range (|x| <= 448) but for the planted values
        x = randn(g, (3, 64, 96), device, scale=60.0)
        y = randn(g, (3, 96, 40), device, scale=60.0)
        x[:, ::7, ::5] = 1e4
        x[0, 3, 3] = float("inf")
        y[1, 5, 7] = -float("inf")
        enc = f8.encode_e4m3(f8.quantize_dot_operand(x, saturate=sat))
        enc_cpu = f8.encode_e4m3(f8.quantize_dot_operand(x.cpu(),
                                                         saturate=sat))
        card_bytes = enc.view(torch.uint8).cpu()
        cpu_bytes = enc_cpu.view(torch.uint8)
        nan = (cpu_bytes & 0x7F) == 0x7F
        dn = (((2,), (1,)), ((0,), (0,)))
        got = f8.fp8_dot_general(x, y, dn, saturate=sat)
        want = f8.fp8_dot_general(x, y, dn, saturate=sat, impl="ref")
        held = fp8_hold(enc, f8.encode_e4m3(
            f8.quantize_dot_operand(y, saturate=sat)),
            f"out_of_range_saturate_{sat}")
        specials.append(dict(
            held, saturate=sat,
            storage_bytes_equal_cpu=bool(torch.equal(card_bytes[~nan],
                                                     cpu_bytes[~nan])),
            nan_storage_equal_cpu=bool(torch.equal(
                (card_bytes & 0x7F) == 0x7F, nan)),
            stored_nans=int(nan.sum()),
            general_equal_held=bool(torch.equal(torch.isnan(got),
                                                torch.isnan(want)))))
    torch.cuda.synchronize()
    emit("fp8_kernels", cases=cases + specials,
         tolerance="NaN where the plain version has NaN; elementwise "
                   "|kernel - plain| <= K * 2^-23 * (|Aq| @ |Bq|); the "
                   "bf16 result = the f32 result rounded once")
    bad = [c for c in cases + specials
           if not (c["within_bound"] and c["nan_equal"]
                   and c["bf16_mismatches"] == 0
                   and c.get("storage_bytes_equal_cpu", True)
                   and c.get("nan_storage_equal_cpu", True)
                   and c.get("general_equal_held", True))]
    check(not bad, "fp8 kernel against its plain version", bad)
    check(all(c["nans"] > 0 for c in specials if not c["saturate"]),
          "fp8: the non-saturating case stores no NaN", specials)
    return {"fp8_dot": max(c["max_abs_err"] for c in cases)}


# the design's step 0: (route, instructions between promotions of the
# tensor core's sum into f32 registers; 0: one promotion, at the end) on
# fp8_hold's operands with spread 4, and the depths measured
FP8_PROBE_ROUTES = (("fp8", 1), ("fp8", 4), ("f16", 1), ("f16", 8),
                    ("f16", 0), ("bf16", 8))
FP8_PROBE_K = (32, 131, 2560, 6912)


def phase_fp8_probe(device):
    """Which tensor-core route holds the fp8 kernel's contract: a 128 x 128
    block of each depth through every route of ``FP8_PROBE_ROUTES``
    (``fp8_dot.mma_probe``: one warpgroup per 64 x 64, the sum promoted
    into f32 registers every P instructions), its largest error over
    ``fp8_hold``'s bound ``K * 2^-23 * (|Aq| @ |Bq|)`` against the plain
    version and against the exact (f64) sums. Fails if the shipped route
    does not hold the bound."""
    from repro_torch.kernels import fp8_dot as f8
    g = torch.Generator(device=device)
    g.manual_seed(2)
    rows = []
    for k in FP8_PROBE_K:
        a = fp8_operand(g, (1, 128, k), device, 2.0, spread=4)
        b = fp8_operand(g, (1, k, 128), device, 0.05, spread=4)
        want = f8.fp8_dot_ref(a, b)[0]
        exact = (a.to(torch.float32).double()
                 @ b.to(torch.float32).double())[0]
        bound = k * 2.0 ** -23 * f8.fp8_dot_ref(
            a.to(torch.float32).abs(), b.to(torch.float32).abs())[0]
        ap = f8.pack_k_major(a)[0]
        bp = f8.pack_k_major(b.transpose(1, 2))[0]
        for route, every in FP8_PROBE_ROUTES:
            got = f8.mma_probe(ap, bp, route, every)
            rows.append(dict(
                route=route, promote_every=every, k=k,
                max_err_over_bound=float(((got - want).abs() / bound)
                                         .max()),
                max_err_over_bound_exact=float(
                    ((got.double() - exact).abs() / bound.double()).max())))
    torch.cuda.synchronize()
    emit("fp8_probe", shipped={"route": f8.ROUTE[0],
                               "promote_every": f8.ROUTE[1]},
         tolerance="max_err_over_bound <= 1", rows=rows)
    shipped = [r for r in rows
               if (r["route"], r["promote_every"]) == f8.ROUTE]
    check(all(r["max_err_over_bound"] <= 1.0 for r in shipped),
          "fp8 probe: the kernel's route misses the bound", shipped)


def phase_fp8_times(device):
    """The fp8 kernel at the MLP shapes (bf16 result, as the path writes
    it) on packed operands, as the path hands them over, beside its bound
    (at the fp8 rate, and at the f16 rate its route runs at), its plain
    version, ``torch._scaled_mm`` (the one library call of the same
    function, unit scales), the bf16 ``torch.matmul`` of the same shape,
    and ``fp8_dot_cuda`` on the unpacked operands (the pack included)."""
    from repro_torch.kernels import fp8_dot as f8
    g = torch.Generator(device=device)
    g.manual_seed(1)
    rows = []
    one = torch.ones((), dtype=torch.float32, device=device)
    for label, (m, k, n) in FP8_MLP_SHAPES.items():
        a = fp8_operand(g, (1, m, k), device, 2.0)
        b = fp8_operand(g, (1, k, n), device, 0.05)
        bcol = b[0].t().contiguous().t()        # column-major, as it takes
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ap, bp = f8.pack_k_major(a), f8.pack_k_major(b.transpose(1, 2))
        got = f8.fp8_dot_packed(ap, bp, torch.bfloat16)
        want = f8.fp8_dot_ref(a, b, torch.bfloat16)
        lib = torch._scaled_mm(a[0], bcol, scale_a=one, scale_b=one,
                               out_dtype=torch.bfloat16)
        ops_ms = 2.0 * m * n * k / PEAK_FP8_OPS_PER_S * 1e3
        route_ms = 2.0 * m * n * k / PEAK_BF16_OPS_PER_S * 1e3
        bytes_ms = (m * k + k * n + 2 * m * n) / PEAK_BYTES_PER_S * 1e3
        rows.append(dict(
            name="fp8_dot", label=label, shape=[m, k, n], dtype="float8_e4m3fn",
            out_dtype="bfloat16", gflop=2.0 * m * n * k / 1e9,
            max_abs_err=max_abs_err(got, want),
            bf16_ulps_vs_plain=bf16_ulps(got, want),
            scaled_mm_max_abs_diff=max_abs_err(lib, want[0]),
            ms=event_ms(lambda: f8.fp8_dot_packed(ap, bp, torch.bfloat16),
                        reps=10),
            with_pack_ms=event_ms(
                lambda: f8.fp8_dot_cuda(a, b, torch.bfloat16), reps=10),
            plain_ms=event_ms(lambda: f8.fp8_dot_ref(a, b, torch.bfloat16),
                              reps=5),
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            route=f"{f8.ROUTE[0]} wgmma", route_bound_ms=max(route_ms,
                                                              bytes_ms),
            library_ms=event_ms(lambda: torch._scaled_mm(
                a[0], bcol, scale_a=one, scale_b=one,
                out_dtype=torch.bfloat16), reps=10),
            bf16_matmul_ms=event_ms(lambda: a16[0] @ b16[0], reps=10)))
        del a, b, ap, bp, bcol, a16, b16, got, want, lib
        torch.cuda.empty_cache()
    emit("fp8_times", peak_fp8_ops_per_s=PEAK_FP8_OPS_PER_S,
         peak_f16_ops_per_s=PEAK_BF16_OPS_PER_S, kernels=rows)
    return rows


def phase_fp8_path(device, layers, seq):
    """``truncate(model.loss, P, native_fp8=True)`` of h2o-danube-1.8b at
    full width, depth cut to ``FP8_LAYERS`` (``--layers`` sets it), 1 x
    ``seq`` tokens, ``P`` an e4m3 dot-input rule on ``**/mlp``: every MLP
    product through the fp8 kernel, against the emulated
    ``truncate(model.loss, P)``; fp8 launches = the matched dot sites'
    executions; one walk per signature. Each program is timed once after
    its first call."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import (E4M3, TruncationPolicy, TruncationRule,
                                  truncate, truncate_sweep)
    from repro_torch.models import Model

    cfg = get_config("h2o-danube-1.8b").replace(
        n_layers=layers or FP8_LAYERS)
    model = Model(cfg)
    params = model.init(seed=0)
    batch = make_batch(cfg, 1, seq, device)
    pol = TruncationPolicy(rules=(TruncationRule(
        fmt=E4M3, scope="**/mlp", ops=("dot_general",),
        quantize_dot_inputs=True),))
    native = truncate(model.loss, pol, native_fp8=True)
    emulated = truncate(model.loss, pol)
    t_start = time.perf_counter()
    with torch.no_grad():
        dots = truncate_sweep(model.loss, TruncationPolicy.scoped(
            "**/mlp", "e8m7", ops=("dot_general",)))(params, batch).index
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()           # the fp8 path starts here
        ln = native(params, batch)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()        # ... and ends here
        le = emulated(params, batch)
        lp = model.loss(params, batch)
        out = {}
        ms = {k: timed(lambda k=k, f=f: out.__setitem__(k, f(params, batch)),
                       reps=1)
              for k, f in (("plain", model.loss), ("emulated", emulated),
                           ("native", native))}
        again = out["native"]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    ln, le, lp = float(ln), float(le), float(lp)
    emit("fp8_path", model=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, d_ff=cfg.d_ff, batch=[1, seq],
         policy="e4m3 quantize_dot_inputs on **/mlp dot_general",
         loss_native=ln, loss_emulated=le, loss_plain=lp,
         rel_diff_native_emulated=abs(ln - le) / abs(le),
         tolerance=FP8_LOSS_RTOL, fp8_launches=counts["fp8_dot"],
         matched_dot_site_executions=dots.executions,
         matched_dot_sites=len(dots), n_traces=native.n_traces,
         repeat_bit_equal=float(again) == ln, ms=ms,
         factor_native_over_emulated=ms["native"] / ms["emulated"],
         peak_gb=round(peak_gb, 2), launches=counts,
         seconds=round(time.perf_counter() - t_start, 1))
    check(math.isfinite(ln) and abs(ln - le) <= FP8_LOSS_RTOL * abs(le),
          "fp8 path: native vs emulated loss", ln, le)
    check(counts["fp8_dot"] == dots.executions > 0,
          "fp8 path: launches != matched dot site executions",
          counts["fp8_dot"], dots.executions)
    check(native.n_traces == 1 and float(again) == ln, "fp8 path: n_traces",
          native.n_traces)
    check(ln != lp, "fp8 path: the policy changed nothing", ln, lp)
    del params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the guard path: faults, monitor, escalation ladder, rollback
# ---------------------------------------------------------------------------

# a save after every step: the fault at step 1 rolls back to the save of
# step 1, still being written when the alarm comes
GUARD_STEPS, GUARD_FAULT_STEP = 2, 1
GUARD_FAULT = f"0:{GUARD_FAULT_STEP}:bitflip"     # site 0: the first MLP
GUARD_TRAINER_STEPS = 3


def phase_guard_path(device, layers):
    """Runtime guardrails on h2o-danube-1.8b at full width, depth cut to
    ``TRAIN_IO_LAYERS`` (``--layers`` sets it), 1 x 2048 tokens a
    microbatch: (i) ``launch.train --production --guardrails
    --policy-artifact ... --inject-fault 0:1:bitflip``: the bit flip is
    caught at the injected step or the next, escalated, rolled back to the
    saved step and the run finishes finite under the escalated table with
    one enumeration; (ii) ``GuardedTrainer`` fault-free: no interventions,
    bit-equal to the unguarded hot-swap step; (iii) ``make_guarded_app_loop``
    on Sod with an overflow fault at its top blamed sites, recovered within
    10 % of the fault-free run (``tests/test_chaos.py``'s budget)."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.apps import get_app
    from repro_torch.artifacts import PolicyArtifact, Registry
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core.policy import parse_policy
    from repro_torch.data import DataConfig, Pipeline, to_device
    from repro_torch.guardrails import (
        FaultPlan, FaultSpec, GuardedTrainer, GuardrailConfig,
        make_guarded_app_loop, sites_for_scope,
    )
    from repro_torch.kernels.quantize_em.ops import IDENTITY_ROW
    from repro_torch.launch import train as train_cli
    from repro_torch.models import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import (TrainConfig, init_opt_state,
                                   make_hotswap_train_step)

    n_layers = layers if layers is not None else TRAIN_IO_LAYERS
    mlp = parse_policy(TRAIN_POLICY)
    work = os.path.join(ROOT, "build", "guard_path")
    if os.path.exists(work):
        shutil.rmtree(work)
    os.makedirs(work)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()               # the guard path starts here
    t_start = time.perf_counter()

    # ---- (i) the train CLI with an injected bit flip ----------------------
    reg = Registry(os.path.join(work, "registry"))
    reg.save(PolicyArtifact(name="danube_mlp", policy=mlp))
    argv = ["--production", "--arch", "h2o-danube-1.8b", "--device", "cuda",
            "--seq", str(TRAIN_SEQ), "--global-batch", "4", "--lr",
            str(TRAIN_LR), "--save-every", "1", "--steps", str(GUARD_STEPS),
            "--ckpt", os.path.join(work, "ck"), "--policy-artifact",
            "danube_mlp", "--registry", os.path.join(work, "registry"),
            "--guardrails", "--inject-fault", GUARD_FAULT]
    t0 = time.perf_counter()
    out = train_cli.main(argv, n_layers=n_layers)
    cli_s = time.perf_counter() - t0
    log = out["guardrail_log"]
    events = [(iv.step, iv.kind) for iv in log]
    alarm = log.by_kind("alarm")
    esc = log.by_kind("escalate_sites")
    with open(os.path.join(work, "ck", "guardrail_log.json")) as f:
        saved_log = json.load(f)
    cli = dict(argv=argv, n_layers=n_layers, log=log.to_json(),
               events=events, final_step=out["final_step"],
               restarts=out["restarts"],
               losses={str(k): v for k, v in out["losses"].items()},
               n_traces=out["step_fn"].sweep.n_traces,
               fault_row_widened=out["table"][0].tolist(),
               seconds=round(cli_s, 1))
    del out
    check(log.kinds().get("fault_injected") == 1
          and alarm and alarm[0].step in (GUARD_FAULT_STEP,
                                          GUARD_FAULT_STEP + 1)
          and esc and esc[0].detail["sites"] == [0]
          and esc[0].detail["scopes"] == ["layer/mlp"]
          and len(log.by_kind("rollback")) == 1 and cli["restarts"] == 1,
          "guard path: fault, alarm, escalation, rollback", cli)
    check(cli["final_step"] == GUARD_STEPS
          and sorted(cli["losses"]) == [str(s) for s in range(GUARD_STEPS)]
          and all(math.isfinite(v) for v in cli["losses"].values()),
          "guard path: the run did not finish finite", cli)
    check(cli["n_traces"] == 1 and saved_log == log.to_json()
          and cli["fault_row_widened"] == IDENTITY_ROW.tolist(),
          "guard path: enumerations, saved log, widened row", cli)
    # the faulted step's loss (the alarm's reason) against its clean replay
    faulted_nonfinite = "non-finite" in alarm[0].detail["reason"]
    check(faulted_nonfinite, "guard path: the bit flip did not reach the loss",
          alarm[0].detail)

    # ---- (ii) GuardedTrainer fault-free against the unguarded step -------
    cfg = get_config("h2o-danube-1.8b").replace(n_layers=n_layers)
    model = Model(cfg)
    batch = to_device(Pipeline(DataConfig(
        seq_len=TRAIN_SEQ, global_batch=1, vocab=cfg.vocab)).next())
    tc = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR))
    t0 = time.perf_counter()
    gt = GuardedTrainer(model, tc, mlp, model.init(seed=0),
                        lambda step: batch,
                        cfg=GuardrailConfig(save_every=100))
    res = gt.run(GUARD_TRAINER_STEPS)
    trainer_s = time.perf_counter() - t0
    step, sites = make_hotswap_train_step(model, tc, mlp, model.init(seed=0),
                                          batch)
    table = step.device_table(sites.table_for(mlp))
    p = model.init(seed=0)
    o = init_opt_state(model, p, tc)
    for i in range(GUARD_TRAINER_STEPS):
        p, o, m = step(p, o, batch, i, table)
    trainer = dict(steps=GUARD_TRAINER_STEPS, interventions=len(res.log),
                   rollbacks=res.rollbacks, final_loss=res.final_loss,
                   unguarded_final_loss=float(m["loss"]),
                   params_mismatches=tree_mismatches(res.state["params"], p),
                   n_traces=gt.cache_size(), sites=len(gt.sites),
                   seconds=round(trainer_s, 1))
    del gt, res, p, o, step
    torch.cuda.empty_cache()
    check(trainer["interventions"] == 0 and trainer["rollbacks"] == 0
          and trainer["final_loss"] == trainer["unguarded_final_loss"]
          and trainer["params_mismatches"] == 0 and trainer["n_traces"] == 1,
          "guard path: fault-free GuardedTrainer", trainer)

    # ---- (iii) the guarded Sod loop with overflow faults ------------------
    t0 = time.perf_counter()
    app = get_app("sod", n_cells=32, t_end=0.2)
    policy = app.uniform_policy("e8m5")
    _obs, traj = app.profile_trajectory(policy=policy, threshold=1e-6)
    blame = traj.blame(1e-6)

    def build(fault_plan, name):
        ck = Checkpointer(os.path.join(work, name), async_save=False)
        return make_guarded_app_loop(
            app, policy, checkpointer=ck, fault_plan=fault_plan,
            cfg=GuardrailConfig(save_every=5, warmup=4, window=8),
            device=device)

    loop0, sweep = build(None, "sod_ff")
    handle0 = sweep(app.init_state())
    # the rows of the top two blamed scopes, as tests/test_chaos.py picks
    fault_sites, scopes = [], []
    for b in blame:
        rows = sites_for_scope(handle0, b.scope) if b.scope else []
        if rows:
            scopes.append(b.scope)
            fault_sites += [r for r in rows if r not in fault_sites]
        if len(scopes) >= 2:
            break
    fault_sites = fault_sites or [0, 1]

    def plan():
        return FaultPlan([FaultSpec(site=s, step=10, kind="overflow")
                          for s in fault_sites])

    table = np.asarray(handle0.table(policy), np.int32)
    fp = plan()
    state = app.init_state()
    for i in range(app.n_steps):
        table, _ = fp.apply(table, i)
        state = sweep(state)(table)
    unguarded = max(float(t.abs().max()) for t in state)
    res0 = loop0.run(app.n_steps)
    loopg, _ = build(plan(), "sod_guarded")
    resg = loopg.run(app.n_steps)
    err = app.error_metric(app.observables(res0.state),
                           app.observables(resg.state))
    sod = dict(fault_sites=fault_sites, fault_scopes=scopes,
               unguarded_max_abs=unguarded, guarded_final=resg.final_loss,
               error_vs_fault_free=err, kinds=resg.log.kinds(),
               rollbacks=resg.rollbacks, n_traces=sweep.n_traces,
               seconds=round(time.perf_counter() - t0, 1))
    check(not math.isfinite(unguarded) and math.isfinite(resg.final_loss)
          and err <= 0.10 and sod["kinds"].get("rollback", 0) >= 1
          and sod["kinds"]["fault_injected"] == len(fault_sites)
          and all(np.array_equal(resg.table[s], IDENTITY_ROW)
                  for s in fault_sites) and sweep.n_traces == 1,
          "guard path: guarded Sod", sod)
    counts = kernels.launch_counts()            # ... and ends here
    shutil.rmtree(work)
    emit("guard_path", model=cfg.name, n_layers=n_layers, d_model=cfg.d_model,
         batch=[1, TRAIN_SEQ], policy=TRAIN_POLICY, fault=GUARD_FAULT,
         cli=cli, trainer=trainer, sod=sod, launches=counts,
         seconds=round(time.perf_counter() - t_start, 1))
    # the ladder's rungs, as the CLI's log holds them
    print("\n".join(f"[guard_path] step {iv['step']:>3d}  {iv['kind']:<15s} "
                    + " ".join(f"{k}={v}" for k, v in iv["detail"].items())
                    for iv in cli["log"]), flush=True)
    check(counts["quantize_em_dynamic"] > 0, "guard path: no dynamic launch",
          counts)
    return counts


# the sharded path: parameters that stay DTensor shards on two ranks
# --------------------------------------------------------------------------

SHARDED_SERVE_ARGV = ["--arch", "glm4-9b", "--production", "--batch", "4",
                      "--requests", "8", "--prompt-len", "32",
                      "--new-tokens", "16", "--max-seq", "128",
                      "--policy", SERVE_POLICY, "--device", "cuda"]
SHARDED_SERVE_LAYERS = 2
SHARDED_TRAIN_LAYERS = 2
SHARDED_STEPS = 3       # train steps of each kind on each mesh
SHARDED_FORCED = 8      # teacher-forced decode steps
# the meshes trained on: (1, 2), the reference's smoke mesh, by default;
# (2, 1) with ``--phases sharded_fsdp``
SHARDED_MESHES = ((1, 2),)
FSDP_MESH = (2, 1)


def local_bytes(tree):
    """Bytes this rank holds of ``tree``'s tensors (a DTensor's local
    shard)."""
    from repro_torch.distributed import sharding as shd
    return sum(shd.local_parts(t)[0].numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def global_bytes(tree):
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def layout_bytes(params, shardings=None):
    """Per leaf of sharded parameters (or of a tree laid out as them):
    whether a rule shards it, its local and global bytes; the replicated
    remainder named. With ``shardings`` (the rules' ``NamedSharding`` of
    each leaf), ``as_rules``: whether the leaves the rules split over an
    axis of more than one rank are exactly the sharded ones."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.optim import tree as T

    def name(path):
        return "/".join(k.strip("[]'.") for k in map(str, path))

    def split(placements, mesh):
        # an axis of one rank splits nothing
        return any(p.is_shard() and mesh.size(md) > 1
                   for md, p in enumerate(placements))
    sharded, replicated = [], {}
    for path, t in T.leaves_with_path(params):
        mine = shd.local_parts(t)[0].numel() * t.element_size()
        whole = t.numel() * t.element_size()
        if split(t.placements, t.device_mesh):
            sharded.append((mine, whole))
        else:
            replicated[name(path)] = whole
    out = dict(sharded_local=sum(m for m, _ in sharded),
               sharded_global=sum(w for _, w in sharded),
               sharded_leaves=len(sharded),
               halves=all(2 * m == w for m, w in sharded),
               replicated=replicated,
               replicated_bytes=sum(replicated.values()))
    if shardings is not None:
        whole_by_rules = {name(path) for path, ns in
                          T.leaves_with_path(shardings)
                          if not split(ns.placements(), ns.mesh)}
        out["as_rules"] = whole_by_rules == set(replicated)
    return out


def host_syncs(fn):
    """``fn()``, the host synchronisations it made on this thread (the
    card's sync debug mode, set to warn) and where each was made: the
    innermost line of the port (or of this script) on the stack."""
    import traceback
    import warnings
    where = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if "repro_torch" in f.filename
                or f.filename.endswith("chip_smoke.py")]
        f = ours[-1] if ours else None
        where.append(f"{os.path.relpath(f.filename)}:{f.lineno}" if f
                     else f"{filename}:{lineno}")
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, len(where), where


def rank_note(*what):
    """A progress line on stderr from rank 0 of a spawned group."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_rank() == 0:
        print("[sharded_path]", *what, file=sys.stderr, flush=True)


def sharded_serve(layers):
    """glm4-9b at full width, ``layers`` deep, served by ``launch.serve``
    on the (1, 2) mesh of both ranks under ``SERVE_PARAM_RULES``; the same
    model on this rank alone beside it."""
    from repro_torch import kernels
    from repro_torch.core import truncate
    from repro_torch.core.policy import parse_policy
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import serve
    from repro_torch.serving import Engine

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        eng = serve.main(SHARDED_SERVE_ARGV, n_layers=layers)
    rank_note("served", eng.ticks, "ticks in", round(eng.served_seconds, 1),
              "s")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cli_s = time.perf_counter() - t0
    model, params, cfg = eng.model, eng.params, eng.model.cfg
    policy = parse_policy(SERVE_POLICY)
    done = eng.run()
    mesh = torch.utils._pytree.tree_leaves(params)[0].device_mesh
    with torch.no_grad():
        cache = model.place_cache(model.init_cache(SERVE_BATCH, SERVE_SEQ, device="cuda"),
                                  mesh)
        per_tick = matched_executions(
            model.decode_step, policy,
            (params, cache, torch.zeros(SERVE_BATCH, dtype=torch.int32,
                                        device="cuda")))
    res = dict(ticks=eng.ticks, requests=len(done),
               statuses=sorted({r.status for r in done.values()}),
               tokens=sum(len(r.out_tokens) for r in done.values()),
               served_seconds=eng.served_seconds, command_seconds=cli_s,
               matched_site_executions_per_tick=per_tick,
               static_launches=counts["quantize_em_static"],
               dynamic_launches=counts["quantize_em_dynamic"],
               cache_sizes=eng.cache_sizes(),
               mesh=dict(shd.mesh_shape(mesh)),
               bytes=layout_bytes(params, shd.param_shardings(
                   model.param_defs(), mesh, shd.SERVE_PARAM_RULES)))

    # the same draws on this rank alone; teacher-forced: the first
    # requests' prompts, then the one-rank step's own tokens, through both
    # decode steps, logits against logits
    plain = model.init(seed=0, device="cuda")
    res["one_rank_param_bytes"] = global_bytes(plain)
    res["rank_param_bytes"] = local_bytes(params)
    prompts = serve.workload(cfg.vocab, SERVE_BATCH, 32)
    step_sh = truncate(model.decode_step, policy)
    step_one = truncate(model.decode_step, policy)
    c_sh = cache
    c_one = model.init_cache(SERVE_BATCH, SERVE_SEQ, device="cuda")
    tok = torch.tensor([p[0] for p in prompts], dtype=torch.int32,
                       device="cuda")
    worst = scale = 0.0
    agree = 0
    with torch.no_grad():
        for t in range(SHARDED_FORCED):
            l_sh, c_sh = step_sh(params, c_sh, tok)
            l_one, c_one = step_one(plain, c_one, tok)
            l_sh = shd.gather(l_sh)
            worst = max(worst, float((l_sh - l_one).abs().max()))
            scale = max(scale, float(l_one.abs().max()))
            nxt = l_one.argmax(-1)
            agree += int((l_sh.argmax(-1) == nxt).sum())
            tok = torch.tensor([p[t + 1] if t + 1 < len(p) else int(n)
                                for p, n in zip(prompts, nxt.tolist())],
                               dtype=torch.int32, device="cuda")
    res["forced"] = dict(steps=SHARDED_FORCED, max_abs_diff=worst,
                         max_abs_logit=scale, ratio=worst / scale,
                         argmax_agree=agree,
                         argmax_total=SHARDED_FORCED * SERVE_BATCH)
    one = Engine(model, plain, batch_size=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                 policy=policy)

    # a tick's time and its host synchronisations, sharded and one-rank;
    # the debug mode turned on and off once around nothing first (what it
    # reports then is no tick's)
    _, res["host_syncs_idle"], res["host_syncs_at_idle"] = host_syncs(
        lambda: None)
    for name, e in (("sharded", Engine(model, params, batch_size=SERVE_BATCH,
                                       max_seq_len=SERVE_SEQ,
                                       policy=policy)),
                    ("one_rank", one)):
        with torch.no_grad():
            res[f"ms_per_tick_{name}"] = ms_per_tick(e, cfg.vocab)
            torch.cuda.synchronize()
            (_, res[f"host_syncs_per_tick_{name}"],
             res[f"host_syncs_at_{name}"]) = host_syncs(e.step)
    del plain, one, eng, params
    torch.cuda.empty_cache()
    return res


def sharded_train(layers, meshes):
    """h2o-danube-1.8b at full width, ``layers`` deep, bf16 with the f32
    master, 1 x 2048 tokens a data rank, ``remat``: three steps of each
    kind on each of ``meshes`` (of both ranks), and on this rank alone on
    the same global batch."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.policy import parse_policy
    from repro_torch.data import DataConfig, Pipeline, to_device
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import (TrainConfig, init_opt_state,
                                   make_hotswap_train_step, make_train_step)

    cfg = get_config("h2o-danube-1.8b").replace(n_layers=layers)
    model = Model(cfg)
    mlp = parse_policy(TRAIN_POLICY)
    tc = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR))

    def batch_of(data_ranks):
        return to_device(Pipeline(DataConfig(
            seq_len=TRAIN_SEQ, global_batch=data_ranks,
            vocab=cfg.vocab)).next(), device="cuda")

    def steps_of(kind, params, b, impl="auto"):
        if kind == "hotswap":
            fn, index = make_hotswap_train_step(model, tc, mlp, params, b)
            return fn, (fn.device_table(index.table_for(mlp)),)
        return make_train_step(model, TrainConfig(
            optimizer=tc.optimizer, policy=mlp if kind == "policy" else None,
            policy_impl=impl)), ()

    def run(kind, params, b, n=SHARDED_STEPS, impl="auto", after=None):
        """``n`` steps of ``kind``: (params, state, losses, ms a step,
        enumerations); ``after[i]`` keeps the parameters after step i."""
        fn, extra = steps_of(kind, params, b, impl)
        o = init_opt_state(model, params, tc, device="cuda")
        losses, ms = [], []
        p = params
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = fn(p, o, b, i, *extra)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            rank_note("train", kind, impl, "step", i, round(ms[-1]), "ms",
                      losses[-1])
            if after is not None:
                after.append(p)
        traces = (fn.sweep.n_traces if kind == "hotswap"
                  else getattr(getattr(fn, "grad_fn", None), "n_traces", 0))
        return p, o, losses, ms, traces

    res = {}
    for shape in meshes:
        key = "x".join(map(str, shape))
        batch = batch_of(shape[0])
        one = res["one_rank_" + key] = {}
        plain = model.init(seed=0, device="cuda")
        for kind in ("plain", "policy", "hotswap"):
            p, o, losses, ms, _ = run(kind, plain, batch)
            one[kind] = dict(losses=losses, ms=ms)
        one["state_bytes"] = global_bytes((p, o["m"], o["v"], o["master"]))
        del p, o, plain
        rank_note("train on", shape)
        mesh = device_mesh(shape, ("data", "model"), device="cuda")
        sp = model.place_params(model.init(seed=0, device="cuda"), mesh)
        sb = {k: shd.place(v, shd.batch_sharding(mesh))
              for k, v in batch.items()}
        out = {}
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        for kind in ("plain", "policy", "hotswap"):
            after = []
            p, o, losses, ms, traces = run(kind, sp, sb, after=after)
            out[kind] = dict(losses=losses, ms=ms, n_traces=traces)
            if kind == "policy":
                # its first step, the kernel's, against the plain version's
                # on the same shards
                ref = run(kind, sp, sb, n=1, impl="ref")
                out["cuda_vs_ref_mismatches"] = tree_mismatches(
                    [shd.local_parts(t)[0] for t in
                     torch.utils._pytree.tree_leaves(after[0])],
                    [shd.local_parts(t)[0] for t in
                     torch.utils._pytree.tree_leaves(ref[0])])
                out["cuda_vs_ref_loss"] = [losses[0], ref[2][0]]
            del after
        after = kernels.launch_counts()
        out["launches"] = {k: after[k] - before[k] for k in after}
        out["rank_state_bytes"] = local_bytes((p, o["m"], o["v"],
                                               o["master"]))
        rules = shd.param_shardings(model.param_defs(), mesh)
        out["state_layout"] = {k: layout_bytes(v, rules) for k, v in (
            ("params", p), ("m", o["m"]), ("v", o["v"]),
            ("master", o["master"]))}
        res[key] = out
        del p, o, sp
        torch.cuda.empty_cache()
    return res


def sharded_rank(rank, world, store, out, serve_layers, train_layers,
                 meshes):
    """One of the two ranks of ``sharded_path``, both on ``cuda:0`` over
    gloo (NCCL refuses two ranks on one device). Writes ``rank<r>.json``."""
    import torch.distributed as dist
    from repro_torch import kernels
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        res = {"serve": sharded_serve(serve_layers)}
        res["serve_seconds"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        res["train"] = sharded_train(train_layers, meshes)
        res["train_seconds"] = time.perf_counter() - t1
        res["launches"] = kernels.launch_counts()
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_sharded_path(layers, meshes):
    """Sharded parameters on two ranks of the one card (gloo, the
    ``mesh_rank`` pattern): glm4-9b served tensor-parallel on (1, 2)
    (``SERVE_PARAM_RULES``, ``SHARDED_SERVE_LAYERS`` deep unless
    ``--layers``), and h2o-danube-1.8b trained on ``meshes``
    (``DEFAULT_PARAM_RULES``, ``SHARDED_TRAIN_LAYERS`` deep), each beside
    the same model on one rank. Each rank holds half of every leaf the
    rules split over an axis of two, the rest whole, in the parameters,
    the moments and the master; teacher-forced logits within
    ``LOGIT_TOL`` of the one-rank engine's; the static quantizer's
    launches a rank = ticks x matched site executions; a tick's host
    syncs on the calling thread: the one read-back, and on a mesh the
    gather of the vocab-sharded logits before it; the train steps' losses
    within 1e-3 of one rank's, the truncated step bit-equal to
    ``impl='ref'`` on the same shards; one enumeration a hot-swap step. A
    collective that cannot run raises in its rank, and this call raises."""
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="sharded_path_")
    world = 2
    try:
        mp.start_processes(sharded_rank, args=(
            world, os.path.join(tmp, "store"), tmp,
            layers or SHARDED_SERVE_LAYERS, layers or SHARDED_TRAIN_LAYERS,
            meshes), nprocs=world, join=True, start_method="spawn")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = {}
    for r in ranks:
        for k, v in r["launches"].items():
            counts[k] = counts.get(k, 0) + v
    for i, r in enumerate(ranks):
        sv, tr = r["serve"], r["train"]
        b = sv["bytes"]
        check(sv["requests"] == 8 and sv["statuses"] == ["ok"]
              and sv["mesh"] == {"data": 1, "model": 2} and b["halves"]
              and b["as_rules"] and b["sharded_local"] * 2
              == b["sharded_global"]
              and sv["rank_param_bytes"] == b["sharded_local"]
              + b["replicated_bytes"]
              and sv["one_rank_param_bytes"] == b["sharded_global"]
              + b["replicated_bytes"], "sharded serve: layout", i, sv)
        check(sv["static_launches"] == sv["ticks"]
              * sv["matched_site_executions_per_tick"] > 0
              and sv["dynamic_launches"] == 0,
              "sharded serve: launches", i, sv)
        check(sv["forced"]["ratio"] <= LOGIT_TOL,
              "sharded serve: teacher-forced logits", i, sv["forced"])
        check(sv["host_syncs_per_tick_one_rank"] == 1
              and sv["host_syncs_per_tick_sharded"] == 1,
              "sharded serve: a tick's host syncs", i, sv)
        for shape in meshes:
            key = "x".join(map(str, shape))
            t, one = tr[key], tr["one_rank_" + key]
            for kind in ("plain", "policy", "hotswap"):
                want = one[kind]["losses"]
                check(len(t[kind]["losses"]) == SHARDED_STEPS
                      and all(abs(a - w) <= 1e-3 * abs(w) for a, w in
                              zip(t[kind]["losses"], want)),
                      "sharded train: losses", i, shape, kind, t[kind], want)
            check(t["hotswap"]["n_traces"] == 1
                  and t["policy"]["n_traces"] == 1
                  and t["cuda_vs_ref_mismatches"] == 0
                  and t["cuda_vs_ref_loss"][0] == t["cuda_vs_ref_loss"][1]
                  and t["launches"]["quantize_em_static"] > 0
                  and t["launches"]["quantize_em_dynamic"] > 0,
                  "sharded train: traces, kernel against plain", i, shape, t)
            lay = t["state_layout"]
            check(all(v["halves"] and v["as_rules"] and v["sharded_leaves"]
                      for v in lay.values())
                  and t["rank_state_bytes"] == sum(
                      v["sharded_local"] + v["replicated_bytes"]
                      for v in lay.values())
                  and one["state_bytes"] == sum(
                      v["sharded_global"] + v["replicated_bytes"]
                      for v in lay.values()),
                  "sharded train: state layout", i, shape, lay)
    emit("sharded_path", world=world, backend="gloo", device="cuda:0",
         meshes=[list(m) for m in meshes],
         serve=[r["serve"] for r in ranks],
         train=[r["train"] for r in ranks],
         rank_seconds=[[r["serve_seconds"], r["train_seconds"]]
                       for r in ranks],
         peak_gb=[r["peak_gb"] for r in ranks], launches=counts,
         seconds=round(time.perf_counter() - t0, 1))
    return counts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--wkv-seq", type=int, default=4096)
    ap.add_argument("--phases", default="kernels,fused_kernels,main_path,"
                                        "mem_path,traj_path,fused_path,"
                                        "small_ref,times,reconcile,"
                                        "search_path,mesh_path,apps_path,"
                                        "artifact_path,models_path,"
                                        "serve_path,train_path,"
                                        "grad_profile_path,fp8_path,"
                                        "guard_path,sharded_path")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device only", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here if the checkout is missing)
    from repro_torch.kernels import fp8_dot as f8
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.quantize_em import kernel as qk
    from repro_torch.kernels.rwkv6 import kernel as wk

    device = torch.device("cuda")
    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    errs = dict.fromkeys(REPLACES)
    if "kernels" in phases:
        errs.update(phase_kernels(device))
        errs.update(phase_fp8_kernels(device))
    if "fp8_probe" in phases:
        phase_fp8_probe(device)
    if "fused_kernels" in phases:
        errs.update(phase_fused_kernels(device, args.seq, args.wkv_seq))
    counts = dict.fromkeys(REPLACES, 0)
    by_path = {}                  # launches of each path's own run
    forward_times = {}
    if "main_path" in phases:
        c, forward_times = phase_main_path(device, args.layers, args.seq)
        counts.update({k: c[k] for k in ("quantize_em_static",
                                         "quantize_em_dynamic")})
        by_path["main_path"] = c
    if "mem_path" in phases:
        by_path["mem_path"] = phase_mem_path(
            device, args.layers or MEM_LAYERS, args.seq)
    if "traj_path" in phases:
        by_path["traj_path"] = phase_traj_path(device, args.layers, args.seq)
    if "fused_path" in phases:
        by_path["fused_path"] = phase_fused_path(device, args.seq,
                                                 args.wkv_seq)
        counts.update(by_path["fused_path"])
    if "search_path" in phases:
        by_path["search_path"] = phase_search_path(
            device, args.layers or SEARCH_LAYERS, args.seq)
    if "mesh_path" in phases:
        by_path["mesh_path"] = phase_mesh_path(
            device, args.layers or SEARCH_LAYERS, args.seq)
    if "apps_path" in phases:
        by_path["apps_path"] = phase_apps_path(device)
    if "artifact_path" in phases:
        by_path["artifact_path"] = phase_artifact_path(
            device, args.layers or SEARCH_LAYERS, args.seq)
    if "models_path" in phases:
        by_path["models_path"] = phase_models_path(device, args.layers)
    if "serve_path" in phases:
        by_path["serve_path"] = phase_serve_path(
            device, args.layers or SERVE_LAYERS)
    if "train_path" in phases:
        by_path["train_path"] = phase_train_path(device, args.layers)
    if "grad_profile_path" in phases:
        by_path["grad_profile_path"] = phase_grad_profile_path(device,
                                                               args.layers)
    if "fp8_path" in phases:
        by_path["fp8_path"] = phase_fp8_path(device, args.layers, args.seq)
        counts["fp8_dot"] = by_path["fp8_path"]["fp8_dot"]
    if "guard_path" in phases:
        by_path["guard_path"] = phase_guard_path(device, args.layers)
    if "sharded_path" in phases:
        by_path["sharded_path"] = phase_sharded_path(
            args.layers, SHARDED_MESHES
            + ((FSDP_MESH,) if "sharded_fsdp" in phases else ()))
    if "train_lr" in phases:
        phase_train_lr(device, args.layers)
    if "small_ref" in phases:
        phase_small_ref(device)
    if "reconcile" in phases:
        phase_reconcile(device, args.seq)
    rows = []
    if "times" in phases:
        rows = phase_times(device, args.seq) + phase_fp8_times(device)
    elif "fp8_times" in phases:
        rows = phase_fp8_times(device)
    if "times" in phases or "fused_times" in phases:
        rows += phase_fused_times(device, args.seq, args.wkv_seq)
    if "profile" in phases:
        phase_profile(device, args.layers, args.seq)
    elif "profile_train" in phases:
        phase_profile_train(device, args.layers)
    if "isa" in phases:
        phase_isa()
    if forward_times:
        emit("forward_times", **forward_times,
             overhead_truncate_scoped=forward_times[
                 "forward_truncate_scoped_e5m7_ms"]
             / forward_times["forward_plain_ms"],
             overhead_table_e8m7=forward_times["forward_table_e8m7_ms"]
             / forward_times["forward_plain_ms"])

    # the shapes each path gives each kernel: the static kernel runs on the
    # bf16 MLP tensors (scoped e5m7 policy), the dynamic one on every float
    # result up to the f32 logits (e8m7 is one of its six tables); flash
    # attention (bf16, as the fused path runs it) and WKV6 at the fused
    # path's shapes
    pick = {"quantize_em_static": ("wi_out_bf16", "e5m7"),
            "quantize_em_dynamic": ("logits_f32", "e8m7"),
            "flash_attention": ("path_bfloat16", None),
            "fp8_dot": ("mlp_wi", None)}
    sources = {"quantize_em_static": qk.SOURCE,
               "quantize_em_dynamic": qk.SOURCE,
               "flash_attention": fk.SOURCE, "wkv6": wk.SOURCE,
               "fp8_dot": f8.SOURCE}
    summary = []
    for name in REPLACES:
        r = next((r for r in rows if r["name"] == name
                  and (name not in pick
                       or (r.get("label"), r.get("fmt")) == pick[name])), {})
        err = errs[name] if errs[name] is not None else r.get("max_abs_err")
        summary.append(dict(
            name=name, route="cuda", source=sources[name],
            replaces=REPLACES[name], launches=counts[name],
            launches_by_path={p: c.get(name, 0) for p, c in by_path.items()},
            max_abs_err=err,
            ms=r.get("ms"), plain_ms=r.get("plain_ms"),
            bound_ms=r.get("bound_ms"), bound_by=r.get("bound_by"),
            library_ms=r.get("library_ms"), shape=r.get("shape"),
            dtype=r.get("dtype"), fmt=r.get("fmt")))
    emit("total", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    # every kernel of each path that ran was launched on it
    path_kernels = {"main_path": ("quantize_em_static", "quantize_em_dynamic"),
                    "mem_path": ("quantize_em_static",),
                    "traj_path": ("quantize_em_static",),
                    "fused_path": ("flash_attention", "wkv6"),
                    "search_path": ("quantize_em_dynamic",),
                    "mesh_path": ("quantize_em_dynamic",),
                    "apps_path": ("quantize_em_static",
                                  "quantize_em_dynamic"),
                    "artifact_path": ("quantize_em_static",
                                      "quantize_em_dynamic"),
                    "models_path": ("quantize_em_static",
                                    "quantize_em_dynamic"),
                    "serve_path": ("quantize_em_static",),
                    "train_path": ("quantize_em_static",
                                   "quantize_em_dynamic"),
                    "grad_profile_path": ("quantize_em_static",),
                    "fp8_path": ("fp8_dot",),
                    "guard_path": ("quantize_em_dynamic",),
                    "sharded_path": ("quantize_em_static",
                                     "quantize_em_dynamic")}
    for path, names in path_kernels.items():
        if path in phases:
            check(all(by_path[path][n] > 0 for n in names), path, summary)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
