"""The port's counters (``profile_counts``) and speedup model against the
reference's, on the same programs and numpy inputs.

Tolerances. FLOPs per (scope, format): equal, once two known differences of
the reference are taken out (ROADMAP Queue C): its ``jnp`` indexing adds
B·S integer FLOPs of index arithmetic under ``embed``, and it traces the
attention mask's NEG_INF constant as one float ``convert_element_type`` FLOP
per layer (``test_torch_model.py`` shows the same site). Bytes: the total
and each truncated format's within 1 %. The reference materialises a
broadcast operand at full shape before an elementwise op and counts its
bytes there; aten passes the small operand, and the integer index
arithmetic differs as above, so the port's byte counts differ by a fraction
of a per cent. The speedup model is the reference's with the H100's
constants: its formulas are held to hand-computed numbers, the
data-sheet-independent parts (``fpu_area_model``, ``reconcile``) to the
reference's values exactly.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
import torch

import repro.core as jc
from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import get_config as jget_config
from repro.core import speedup as jspeedup
from repro.models import Model as JModel

import repro_torch.core as tc
from repro_torch.configs import ArchConfig, get_config
from repro_torch.core import speedup as tspeedup
from repro_torch.core.counters import CountReport
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax

BENCH = dict(name="bench", family="dense", n_layers=4, d_model=128, n_heads=8,
             n_kv_heads=4, d_ff=512, vocab=512, dtype="float32", remat=False,
             scan_layers=False)
# tests/test_system.py's model
SYS = dict(name="sys", family="dense", n_layers=3, d_model=48, n_heads=4,
           n_kv_heads=2, head_dim=12, d_ff=96, vocab=64, dtype="float32",
           remat=False, scan_layers=False)

_CACHE = {}


def setup(kind, B=2, S=32):
    if kind not in _CACHE:
        if kind == "smoke":
            jcfg = jget_config("h2o-danube-1.8b", "smoke")
            tcfg = get_config("h2o-danube-1.8b", "smoke")
        else:
            over = BENCH if kind == "bench" else SYS
            jcfg, tcfg = JArchConfig(**over), ArchConfig(**over)
        jm, tm = JModel(jcfg), Model(tcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             "cpu")
        toks = np.random.RandomState(0).randint(0, jcfg.vocab, (B, S + 1))
        jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
        tb = {"tokens": torch.from_numpy(toks[:, :-1]).to(torch.int32),
              "labels": torch.from_numpy(toks[:, 1:]).to(torch.int32)}
        _CACHE[kind] = (jm, jp, jb, tm, tp, tb)
    return _CACHE[kind]


def policies(name):
    if name == "everywhere":
        return (jc.TruncationPolicy.everywhere("e8m3"),
                tc.TruncationPolicy.everywhere("e8m3"), "e8m3")
    return (jc.TruncationPolicy.scoped("**/mlp", "e5m7"),
            tc.TruncationPolicy.scoped("**/mlp", "e5m7"), "full")


@pytest.mark.parametrize("pol", ["everywhere", "scoped_mlp"])
@pytest.mark.parametrize("kind", ["smoke", "bench"])
def test_flops_by_scope_and_format_match_the_reference(kind, pol):
    jm, jp, jb, tm, tp, tb = setup(kind)
    jpol, tpol, mix_fmt = policies(pol)
    jr = jc.profile_counts(jm.loss, jpol)(jp, jb)
    wrapped = tc.profile_counts(tm.loss, tpol)
    tr = wrapped(tp, tb)
    # the two differences of the reference, taken out
    want = dict(jr.by_scope)
    assert want.pop(("embed", "full")) == tb["tokens"].numel()
    layers = {"layer": tm.cfg.n_layers} if tm.cfg.scan_layers else \
        {f"layer{i}": 1 for i in range(tm.cfg.n_layers)}
    for scope_key, n in layers.items():
        want[(scope_key, mix_fmt)] -= n
    assert tr.by_scope == want
    want_fmt = {}
    for (_, fmt), f in want.items():
        want_fmt[fmt] = want_fmt.get(fmt, 0.0) + f
    assert tr.flops_by_fmt == want_fmt
    assert tr.truncated_fraction == pytest.approx(jr.truncated_fraction,
                                                  rel=1e-5)
    # bytes
    total_t = sum(tr.bytes_by_fmt.values())
    total_j = sum(jr.bytes_by_fmt.values())
    assert total_t == pytest.approx(total_j, rel=1e-2)
    for fmt in tr.bytes_by_fmt:
        if fmt != "full":
            assert tr.bytes_by_fmt[fmt] == pytest.approx(jr.bytes_by_fmt[fmt],
                                                         rel=1e-2)
    # cached per input signature: the program does not run again
    assert wrapped(tp, tb) is tr and wrapped.n_traces == 1


@pytest.mark.parametrize("pol", ["everywhere", "scoped_mlp"])
@pytest.mark.parametrize("kind", ["smoke", "bench"])
def test_fused_byte_model_matches_the_reference(kind, pol):
    """``fused=True`` (elementwise operands free, outputs once) against the
    reference's ``count_jaxpr(..., fused=True)``: bytes within 1 % as for
    the raw census, FLOPs the same as without it."""
    from repro.core import counters as jcounters
    from repro_torch.core import counters as tcounters
    jm, jp, jb, tm, tp, tb = setup(kind)
    jpol, tpol, _ = policies(pol)
    jr = jcounters.count_jaxpr(jax.make_jaxpr(jm.loss)(jp, jb).jaxpr, jpol,
                               fused=True)
    tr = tcounters.count_ops(tm.loss, (tp, tb), {}, tpol, fused=True)
    raw = tcounters.count_ops(tm.loss, (tp, tb), {}, tpol)
    assert tr.flops_by_fmt == raw.flops_by_fmt
    assert tr.by_scope == raw.by_scope
    assert sum(tr.bytes_by_fmt.values()) == pytest.approx(
        sum(jr.bytes_by_fmt.values()), rel=1e-2)
    for fmt in tr.bytes_by_fmt:
        if fmt != "full":
            assert tr.bytes_by_fmt[fmt] == pytest.approx(jr.bytes_by_fmt[fmt],
                                                         rel=1e-2)
        assert tr.bytes_by_fmt[fmt] < raw.bytes_by_fmt[fmt]


def test_counters_scan_multiplier():
    def jf(x):
        def body(c, _):
            return c @ c, None
        y, _ = lax.scan(body, x, None, length=5)
        return y

    def tf(x):
        for _ in range(5):
            with tc.loop_body("scan"):
                x = x @ x
        return x

    x = np.eye(8, dtype=np.float32)
    jr = jc.profile_counts(jf, jc.TruncationPolicy.everywhere(jc.E5M2))(
        jnp.asarray(x))
    tr = tc.profile_counts(tf, tc.TruncationPolicy.everywhere(tc.E5M2))(
        torch.from_numpy(x))
    # 5 iterations x (2 * 8^3) flops
    assert tr.total_flops == pytest.approx(5 * 2 * 8 ** 3) == jr.total_flops
    assert tr.truncated_fraction == pytest.approx(1.0)
    assert tr.flops_by_fmt == jr.flops_by_fmt
    assert tr.bytes_by_fmt == jr.bytes_by_fmt
    assert tr.by_scope == jr.by_scope


def test_counts_follow_the_trips_a_loop_makes():
    """What an eager count sees and a static one cannot: every trip of a
    while loop and the branch that ran (the reference counts one trip of a
    ``while`` and the larger branch of a ``cond``; ROADMAP Queue C)."""
    def f(x, trips):
        i = 0
        while i < trips:
            with tc.loop_body("while"):
                x = torch.exp(x) if i % 2 else x * 0.5
            i += 1
        return x

    x = torch.ones(16)
    pol = tc.TruncationPolicy.everywhere("e5m2")
    every_call = tc.profile_counts(f, pol, cache=False)
    for trips in (1, 4):
        rep = every_call(x, trips)
        n_exp, n_mul = trips // 2, trips - trips // 2
        assert rep.total_flops == 16 * (4 * n_exp + n_mul)
    assert every_call.n_traces == 2
    # a Python int is keyed on its type: one signature, the first count
    cached = tc.profile_counts(f, pol)
    assert cached(x, 1) is cached(x, 4) and cached.n_traces == 1


def test_counting_launches_no_quantizer_and_rounds_nothing():
    from repro_torch.kernels.quantize_em import ref
    calls = []
    orig = ref.quantize_ref_fmt
    ref.quantize_ref_fmt = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        jm, jp, jb, tm, tp, tb = setup("smoke")
        tc.profile_counts(tm.loss, tc.TruncationPolicy.everywhere("e8m3"))(
            tp, tb)
    finally:
        ref.quantize_ref_fmt = orig
    assert calls == []


# --------------------------------------------------------------------------
# the speedup model (tests/test_system.py:101-122 and the H100 constants)
# --------------------------------------------------------------------------

def test_speedup_model_paper_numbers():
    """Table 4 / Fig. 8: with the paper's Sod M-0 profile (86.3 % truncated
    ops) the FPNew-density model lands near the paper's compute-bound
    predictions (~3.7x for half, ~2.2x for single)."""
    sod = {"full": 13.7}
    sp16 = tc.fpu_area_model({**sod, "fp16": 86.3})["fp16"]
    assert 2.8 < sp16 < 4.2, sp16
    sp32 = tc.fpu_area_model({**sod, "fp32": 86.3})["fp32"]
    assert 1.4 < sp32 < 2.6, sp32
    pure = tc.fpu_area_model({"full": 0.0, "fp16": 100.0})["fp16"]
    assert sp16 < pure


@pytest.mark.parametrize("counts,ratio", [
    ({"full": 13.7, "fp16": 86.3}, None),
    ({"full": 13.7, "fp32": 86.3}, None),
    ({"full": 40.0, "e5m2": 60.0}, 2.0),
    ({"full": 0.0, "fp16": 100.0}, 0.5),
])
def test_fpu_area_model_and_reconcile_equal_the_reference(counts, ratio):
    assert tc.fpu_area_model(counts, area_ratio_dbl_low=ratio) == \
        jspeedup.fpu_area_model(counts, area_ratio_dbl_low=ratio)
    assert tspeedup.FPNEW_PERF_DENSITY == jspeedup.FPNEW_PERF_DENSITY
    for measured, modeled in ((1.9, 2.4), (3.0, 3.0), (0.5, 1e-40)):
        t = tspeedup.reconcile(measured, modeled)
        j = jspeedup.reconcile(measured, modeled)
        assert (t.measured, t.modeled, t.gap) == (j.measured, j.modeled,
                                                  j.gap)
        assert t.within(0.3) == j.within(0.3)


def test_estimate_speedup_bounds():
    jm, jp, jb, tm, tp, tb = setup("sys")
    jrep = jc.profile_counts(jm.loss, jc.TruncationPolicy.everywhere("e5m2"))(
        jp, jb)
    trep = tc.profile_counts(tm.loss, tc.TruncationPolicy.everywhere("e5m2"))(
        tp, tb)
    for est in (jc.estimate_speedup(jrep), tc.estimate_speedup(trep)):
        assert est.compute_bound >= 1.0
        assert est.memory_bound >= 1.0
        assert est.bound in ("compute", "memory")
    # the port's model on the reference's counts says what it says on its own
    est_t = tc.estimate_speedup(trep)
    est_j = tc.estimate_speedup(CountReport(jrep.flops_by_fmt,
                                            jrep.bytes_by_fmt,
                                            jrep.by_scope))
    # (the reference's B·S index FLOPs run at the f32 rate: 2e-4 of it)
    assert est_t.compute_bound == pytest.approx(est_j.compute_bound, rel=1e-3)
    assert est_t.memory_bound == pytest.approx(est_j.memory_bound, rel=1e-2)
    assert est_t.bound == est_j.bound


def test_estimate_speedup_with_the_h100_data_sheet_by_hand():
    """1 TFLOP left in f32, 1 TFLOP in e4m3 (fp8 rung), 2 TFLOP in e8m7
    (bf16 rung), against an all-f32 baseline, with the data sheet's dense
    rates: bf16 989 TFLOP/s, fp8 2x, f32 67 TFLOP/s, 3.35 TB/s."""
    rep = CountReport({"full": 1e12, "e4m3": 1e12, "e8m7": 2e12},
                      {"full": 4e9, "e4m3": 1e9, "e8m7": 2e9}, {})
    est = tc.estimate_speedup(rep, baseline_fmt="fp32")
    bf16, fp8, f32, bw = 989e12, 2 * 989e12, 67e12, 3.35e12
    t_base = 4e12 / f32
    t_mix = 1e12 / f32 + 1e12 / fp8 + 2e12 / bf16
    assert est.compute_bound == pytest.approx(t_base / t_mix, rel=1e-12)
    # bytes scale with the container: 4 -> 1 (fp8) and 4 -> 2 (bf16)
    assert est.memory_bound == pytest.approx(7e9 / (4e9 + 1e9 / 4 + 2e9 / 2),
                                             rel=1e-12)
    assert est.operational_intensity == pytest.approx(4e12 / 7e9)
    assert est.bound == "compute"          # 571 flop/byte > ridge 20
    assert est.predicted == est.compute_bound
    # no TPU constant is left in the port's model
    assert (tspeedup.PEAK_BF16_FLOPS, tspeedup.PEAK_F32_FLOPS,
            tspeedup.HBM_BW) == (bf16, f32, bw)
    assert not hasattr(tspeedup, "ICI_BW")
    assert not hasattr(tspeedup, "tpu_relative_throughput")
    # the rungs
    for spec, want in (("e4m3", 2.0), ("e5m2", 2.0), ("e8m7", 1.0),
                       ("e5m10", 1.0), ("fp32", 67 / 989)):
        assert tspeedup.h100_relative_throughput(tc.parse_format(spec)) == \
            pytest.approx(want)
    # a memory-bound profile picks the memory side
    low_oi = CountReport({"full": 1e9, "e8m7": 1e9},
                         {"full": 1e9, "e8m7": 1e9}, {})
    est = tc.estimate_speedup(low_oi)
    assert est.bound == "memory" and est.predicted == est.memory_bound
    assert est.memory_bound == pytest.approx(2e9 / (1e9 + 1e9 / 2))
