#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and nothing else; exits non-zero without a
device. Builds the port's CUDA kernels from the sources in this checkout
(one ``nvcc`` per library, all started together), holds each against its
plain PyTorch version on the card, then drives the port's seven paths:

  * the main path — op-mode truncation (``truncate`` and ``truncate_sweep``)
    of h2o-danube-1.8b at full width and depth, bf16, one batch of 1 x 8192
    tokens, random weights from a seed;
  * the mem path — mem-mode (``memtrace``) of the same model and batch under
    three policies, held bit for bit to op-mode, with the counters
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
  * the apps path — the Sod, heat and Poisson mini-apps at their default
    sizes: ``autosearch`` against each app's FP64 oracle and budget, the
    uniform-low strawman, a swept ladder against ``truncate``, and the same
    search on the CPU (``device="cpu"``) with the same assignments;
  * the trajectory path — ``profile_trajectory`` of h2o-danube-1.8b at full
    width and depth (one layer a step) under the main path's policy and
    with every float result at e8m3, held to ``truncate`` and ``memtrace``;
  * the artifact path — the profile -> warm start -> publish -> deploy
    loop: the cold search of the depth-4 model, a trajectory profile of its
    frontier lowered to ``ladder_hints``, the artifact through a registry in
    a temporary directory and ``resolve_policy("danube@v1")``, a
    warm-started re-search (the cold assignments in at most 4 dispatches);
    and the three mini-apps warm-started from ``warm_hints()`` and from
    their cold result's artifact —

and times the kernels and the forward. Nothing is caught: any failed phase
ends the run with a traceback and a non-zero exit code.

Every phase prints one JSON line. The line before the last lists every
kernel with its launches on the main path (and on each path that ran, in
``launches_by_path``), its error against the plain
version, its time, its bound, the plain version's time and the time of the
one library call that computes the same function (where there is one). The
last line is ``{"ok": true, "device": {...}}``.

Options (for debugging at a smaller size; the defaults are the full run):
``--layers N`` cuts the depth (the search and artifact paths' is 4 unless
given),
``--seq S`` the sequence length of the
h2o-danube paths (``--wkv-seq`` that of the WKV6 program), ``--phases a,b``
runs only some of
``kernels,fused_kernels,main_path,mem_path,traj_path,fused_path,small_ref,
times,reconcile,search_path,apps_path,artifact_path`` or adds
``profile`` (device time by kernel name for one plain and one swept forward)
or ``isa`` (registers and spills of every WKV6 kernel, from ``nvcc -Xptxas
-v``); ``fused_times`` alone times the flash-attention and WKV6 kernels
without the quantizers (``times`` includes it).
"""
from __future__ import annotations

import argparse
import json
import math
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
PEAK_BF16_OPS_PER_S = 989e12        # dense tensor-core rate
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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two f32 scalars (losses) with the same bit pattern."""
    return bool(a.view(torch.int32) == b.view(torch.int32))


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
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.quantize_em import kernel as qk
    from repro_torch.kernels.rwkv6 import kernel as wk
    t0 = time.perf_counter()
    builds = kernels.start_builds()   # one nvcc per library, all together
    paths = [b.wait() for b in builds]
    for m in (qk, fk, wk):
        m._lib()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         libraries=[os.path.relpath(str(p)) for p in paths],
         sources=[qk.SOURCE, fk.SOURCE, wk.SOURCE])


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
        for (n, _), t in zip(ladder, tables):
            times[f"forward_table_{n}_ms"] = timed(lambda: handle(t))
    del params
    torch.cuda.empty_cache()
    return counts, times


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
    if layers is None and seq == 8192:
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


def check_search_runs(res, calls, what):
    """The program ran once to discover scopes, once to enumerate sites, then
    once per evaluated row (the reference row and each candidate: identity
    padding never runs), every row with host synchronisation an error."""
    runs = res.evals_used + 1 if res.n_dispatches else 0
    check(len(calls) == 2 + runs, what, "program runs", len(calls), runs)
    check(all(m == 0 for _, m in calls[:2])
          and all(m == 2 for _, m in calls[2:]), what, "sync debug modes",
          sorted({m for _, m in calls}))


def search_site_policy(res):
    from repro_torch.core import FPFormat, TruncationPolicy, TruncationRule
    return TruncationPolicy(rules=tuple(
        TruncationRule(fmt=FPFormat(res.exp_bits, 0), scope=p)
        for p in res.assignments))


SEARCH_LAYERS = 4       # sites under scope("layer") are one set at any depth
SEARCH_BUDGET = 128     # non-binding at this frontier
SEARCH_THRESHOLD = 5e-3


def phase_search_path(device, layers, seq):
    """``autosearch(model.loss, (params, batch), loss_degradation,
    budget=128, threshold=5e-3)`` of h2o-danube-1.8b at full width, depth
    cut to ``layers``: every candidate is a swept forward through the
    dynamic quantizer. Held to the hand count of launches, to ``truncate``
    of the searched policy (bit for bit) and to a search with no host
    synchronisation inside a candidate."""
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
    t0 = time.perf_counter()
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
    counts = kernels.launch_counts()            # ... and ends here

    check_search_runs(res, loss.calls, "search_path")
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
    del params
    torch.cuda.empty_cache()
    return counts


APP_BUDGET = 32
APP_LADDER = (10, 5, 3)


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



def phase_traj_path(device, layers, seq):
    """Trajectory profiling: ``profile_trajectory(model.loss, ·)`` of the
    full-width model (one layer a step: the layer loop is the model's
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

    cfg = get_config("h2o-danube-1.8b")
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
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


def phase_profile(device, layers, seq):
    """Where a forward's time goes: device time by kernel name for the plain
    forward, one swept forward (every float result a site, e8m7 table) and
    one ``memtrace`` forward under the same policy. Not part of the default
    run: ``--phases profile``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import TruncationPolicy, memtrace, truncate_sweep
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
        runs = {"plain": lambda: model.loss(params, batch),
                "sweep_e8m7": lambda: handle(table),
                "memtrace_e8m7": lambda: traced(params, batch)}
        for name, fn in runs.items():
            wall_ms = timed(fn, reps=1)       # the first call, unprofiled
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
            # device-side events only: host-side op events carry their
            # kernels' time a second time
            rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            rows.sort(key=lambda r: -r[1])
            busy = sum(r[1] for r in rows)
            emit("profile", run=name, n_layers=cfg.n_layers,
                 wall_ms=wall_ms, wall_ms_under_profiler=profiled_ms,
                 device_busy_ms=busy,
                 n_device_kernels=sum(r[2] for r in rows),
                 top=[dict(kernel=k[:80], ms=round(ms, 2), calls=c)
                      for k, ms, c in rows[:14]])


def phase_isa():
    """Registers and spills of every WKV6 kernel (``nvcc -Xptxas -v`` with
    the library's own flags), which no profiler on the card's machine
    shows. Fails if the main path's kernel (bf16 r/k/v, f32 w, hd 64)
    spills. Not part of the default run: ``--phases isa``."""
    import re
    import tempfile
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize_em.kernel import _FLAGS
    from repro_torch.kernels.rwkv6 import kernel as wk

    with tempfile.TemporaryDirectory() as tmp:
        log = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, *_FLAGS,
             "-I", str(_build.INCLUDE_DIR), "-Xptxas", "-v",
             "-o", os.path.join(tmp, "wkv6.so"), str(wk._SOURCE)],
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
    emit("isa", kernels=kernels)
    check(len(kernels) == 4 * len(wk.HEAD_DIMS), "isa: kernels found",
          sorted(kernels))
    check(path is not None and path["spill_store_bytes"] == 0,
          "isa: the path kernel spills", path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--wkv-seq", type=int, default=4096)
    ap.add_argument("--phases", default="kernels,fused_kernels,main_path,"
                                        "mem_path,traj_path,fused_path,"
                                        "small_ref,times,reconcile,"
                                        "search_path,apps_path,"
                                        "artifact_path")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device only", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here if the checkout is missing)
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
        by_path["mem_path"] = phase_mem_path(device, args.layers, args.seq)
    if "traj_path" in phases:
        by_path["traj_path"] = phase_traj_path(device, args.layers, args.seq)
    if "fused_path" in phases:
        by_path["fused_path"] = phase_fused_path(device, args.seq,
                                                 args.wkv_seq)
        counts.update(by_path["fused_path"])
    if "search_path" in phases:
        by_path["search_path"] = phase_search_path(
            device, args.layers or SEARCH_LAYERS, args.seq)
    if "apps_path" in phases:
        by_path["apps_path"] = phase_apps_path(device)
    if "artifact_path" in phases:
        by_path["artifact_path"] = phase_artifact_path(
            device, args.layers or SEARCH_LAYERS, args.seq)
    if "small_ref" in phases:
        phase_small_ref(device)
    if "reconcile" in phases:
        phase_reconcile(device, args.seq)
    rows = []
    if "times" in phases:
        rows = phase_times(device, args.seq)
    if "times" in phases or "fused_times" in phases:
        rows += phase_fused_times(device, args.seq, args.wkv_seq)
    if "profile" in phases:
        phase_profile(device, args.layers, args.seq)
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
            "flash_attention": ("path_bfloat16", None)}
    sources = {"quantize_em_static": qk.SOURCE,
               "quantize_em_dynamic": qk.SOURCE,
               "flash_attention": fk.SOURCE, "wkv6": wk.SOURCE}
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
                    "apps_path": ("quantize_em_static",
                                  "quantize_em_dynamic"),
                    "artifact_path": ("quantize_em_static",
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
