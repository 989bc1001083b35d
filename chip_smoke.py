#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and nothing else; exits non-zero without a
device. Builds the port's CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card bit for bit, then
drives the port's main path — op-mode truncation (``truncate`` and
``truncate_sweep``) of h2o-danube-1.8b at full width and depth, bf16, one
batch of 1 x 8192 tokens, random weights from a seed — and times the
kernels and the forward. Nothing is caught: any failed phase ends the run
with a traceback and a non-zero exit code.

Every phase prints one JSON line. The line before the last lists every
kernel with its launches on the main path, its error against the plain
version, its time, its bound, the plain version's time and the time of the
one library call that computes the same function (where there is one). The
last line is ``{"ok": true, "device": {...}}``.

Options (for debugging at a smaller size; the defaults are the full run):
``--layers N`` cuts the depth, ``--seq S`` the sequence length, ``--phases
a,b`` runs only some of ``kernels,main_path,small_ref,times`` or adds
``profile`` (device time by kernel name for one plain and one swept forward).
"""
from __future__ import annotations

import argparse
import json
import os
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
# instructions one element costs in quantize_one (integer and f32, counted
# from the source: ~8 for the mantissa trick, ~6 subnormal branch, ~6
# overflow, ~4 specials and fault, ~8 widen/narrow/address)
OPS_PER_ELEMENT = 32

RUNG_M = (23, 15, 10, 7, 5, 3, 2, 1)
RUNG_E = (8, 5, 4, 2)
FAULT_BITS = (0, 1, 24, 31, 32)
STORAGE = (torch.float32, torch.bfloat16, torch.float16)


def check(cond, *why):
    """A failed check ends the run (and survives ``python -O``)."""
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + " ".join(
            str(w) for w in why))


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    both = torch.isfinite(a) & torch.isfinite(b)
    if not bool(both.any()):
        return 0.0
    return float((a[both] - b[both]).abs().max())


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
    from repro_torch.kernels.quantize_em import kernel as qk
    t0 = time.perf_counter()
    build = qk.start_build()          # one nvcc per source, started together
    path = build.wait()
    qk._lib()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         libraries=[os.path.relpath(str(path))], sources=[qk.SOURCE])


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

    def same_bits(a, b):
        return bool(a.view(torch.int32) == b.view(torch.int32))

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

    def timed(fn, reps=3):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    times = {}
    with torch.no_grad():
        times["forward_plain_ms"] = timed(lambda: model.loss(params, batch))
        times["forward_truncate_scoped_e5m7_ms"] = timed(
            lambda: lossy(params, batch))
        for (n, _), t in zip(ladder, tables):
            times[f"forward_table_{n}_ms"] = timed(lambda: handle(t))
    del params
    torch.cuda.empty_cache()
    return counts, times


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


def phase_profile(device, layers, seq):
    """Where a forward's time goes: device time by kernel name for the plain
    forward and for one swept forward (every float result a site, e8m7
    table). Not part of the default run: ``--phases profile``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import TruncationPolicy, truncate_sweep
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
        runs = {"plain": lambda: model.loss(params, batch),
                "sweep_e8m7": lambda: handle(table)}
        for name, fn in runs.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            # device-side events only: host-side op events carry their
            # kernels' time a second time
            rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            rows.sort(key=lambda r: -r[1])
            busy = sum(r[1] for r in rows)
            emit("profile", run=name, n_layers=cfg.n_layers,
                 wall_ms_under_profiler=wall_ms, device_busy_ms=busy,
                 n_device_kernels=sum(r[2] for r in rows),
                 top=[dict(kernel=k[:80], ms=round(ms, 2), calls=c)
                      for k, ms, c in rows[:14]])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--phases", default="kernels,main_path,small_ref,times")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device only", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here if the checkout is missing)
    from repro_torch.kernels.quantize_em import kernel as qk

    device = torch.device("cuda")
    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    errs = {"quantize_em_static": None, "quantize_em_dynamic": None}
    if "kernels" in phases:
        errs = phase_kernels(device)
    counts = {k: 0 for k in errs}
    forward_times = {}
    if "main_path" in phases:
        counts, forward_times = phase_main_path(device, args.layers, args.seq)
    if "small_ref" in phases:
        phase_small_ref(device)
    rows = phase_times(device, args.seq) if "times" in phases else []
    if "profile" in phases:
        phase_profile(device, args.layers, args.seq)
    if forward_times:
        emit("forward_times", **forward_times,
             overhead_truncate_scoped=forward_times[
                 "forward_truncate_scoped_e5m7_ms"]
             / forward_times["forward_plain_ms"],
             overhead_table_e8m7=forward_times["forward_table_e8m7_ms"]
             / forward_times["forward_plain_ms"])

    # the shapes the main path gives each kernel: the static kernel runs on
    # the bf16 MLP tensors (scoped e5m7 policy), the dynamic one on every
    # float result up to the f32 logits (e8m7 is one of its six tables)
    pick = {"quantize_em_static": ("wi_out_bf16", "e5m7"),
            "quantize_em_dynamic": ("logits_f32", "e8m7")}
    replaces = {"quantize_em_static": "src/repro/kernels/quantize_em/kernel.py:88",
                "quantize_em_dynamic": "src/repro/kernels/quantize_em/kernel.py:121"}
    summary = []
    for name in ("quantize_em_static", "quantize_em_dynamic"):
        r = next((r for r in rows if r["name"] == name
                  and (r["label"], r["fmt"]) == pick[name]), {})
        err = errs[name] if errs[name] is not None else r.get("max_abs_err")
        summary.append(dict(
            name=name, route="cuda", source=qk.SOURCE, replaces=replaces[name],
            launches=counts[name], max_abs_err=err,
            ms=r.get("ms"), plain_ms=r.get("plain_ms"),
            bound_ms=r.get("bound_ms"), bound_by=r.get("bound_by"),
            library_ms=r.get("library_ms"), shape=r.get("shape"),
            dtype=r.get("dtype"), fmt=r.get("fmt")))
    emit("total", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    if "main_path" in phases:
        check(all(k["launches"] > 0 for k in summary), summary)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
