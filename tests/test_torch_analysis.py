"""The port's static analysis (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the same numpy inputs: the cases of
``tests/test_analysis.py`` in both packages, and the port's own verdicts
confirmed by concrete runs.

  * ``from_concrete``'s facts equal the reference's on the same arrays
    (subnormals, NaN, infinities, integers, booleans, bfloat16);
  * the lattice and the grid exactness, equal to the reference's;
  * output envelopes sound against concrete runs (the reference's scan
    becomes a Python loop under ``loop_body``); a growing loop widens;
  * rung verdicts: Sod in bf16 and the smoke h2o-danube in bf16 equal to
    the reference's tables, the synthetic overflow, the overflow that
    needs criticality, and a data-dependent loop (the program reads a
    tensor on the host) whose sites are never critical;
  * every rung the port decides is confirmed by a concrete ``truncate``
    under its solo policy: bit-identical outputs for EXACT, a non-finite
    output for OVERFLOW_CERTAIN;
  * the analysis runs to its end on every smoke config (the reference's
    slow cases stay slow), and launches no quantizer.

``autosearch(static_prune=...)`` is held to the reference in
``test_torch_analysis_search.py``.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils import _pytree as pytree

import repro.analysis as ja
from repro.core import interpreter as jinterp
from repro.core.formats import FPFormat as JFormat
from repro.core.policy import TruncationPolicy as JPolicy
from repro.core.policy import TruncationRule as JRule

import repro_torch.analysis as ta
import repro_torch.core as tc
from repro_torch.analysis.verdicts import rne_overflow_boundary
from repro_torch.core import interpreter as tinterp
from repro_torch.core.formats import FPFormat
from repro_torch.core.interpreter import loop_body
from repro_torch.core.policy import TruncationPolicy, TruncationRule
from repro_torch.kernels.quantize_em import ops as qops

from test_torch_families import setup

EVERYWHERE = TruncationPolicy(rules=(
    TruncationRule(fmt=FPFormat(8, 0), scope="**"),))
J_EVERYWHERE = JPolicy(rules=(JRule(fmt=JFormat(8, 0), scope="**"),))
WIDTHS = [15, 10, 7, 5, 3, 2]


def facts(v):
    return (v.hi, v.lo, v.min_nz, v.ulp_exp, v.rel_bits, v.nonneg)


def tensor_leaves(tree):
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


# --------------------------------------------------------------------------
# abstract domain
# --------------------------------------------------------------------------

ARRAYS = [
    np.float32([0.5, 2.0, -1.5]),
    np.float32([0.0, 4.0]),
    np.float32([1.0, np.nan]),
    np.float32([np.inf, -2.0]),
    np.float32([1e-45, -3e-39, 2.5, 7.0]),          # f32 subnormals
    np.float64([5e-324, 1.0, -0.1]),                 # an f64 subnormal
    np.float16([6e-8, 0.333, -65504.0]),             # f16 subnormal, max
    np.float32([0.0, -0.0]),
    np.float32([]),
    np.int32([3, -8, 0]),
    np.int64([0, 0]),
    np.uint8([0, 7, 255]),
    np.array([True, False]),
    np.random.RandomState(0).randn(64).astype(np.float32),
]


@pytest.mark.parametrize("i", range(len(ARRAYS)))
def test_from_concrete_facts_equal_the_reference(i):
    a = ARRAYS[i]
    assert facts(ta.from_concrete(a)) == facts(ja.from_concrete(a))
    # a tensor gives the array's facts
    assert facts(ta.from_concrete(torch.from_numpy(a))) == facts(
        ja.from_concrete(a))


def test_from_concrete_bfloat16_equals_the_reference():
    x = np.float32([0.1, -3.0, 1e-40, 65504.0])
    ref = ja.from_concrete(jnp.asarray(x, jnp.bfloat16))
    assert facts(ta.from_concrete(torch.from_numpy(x).bfloat16())) == facts(
        ref)
    assert facts(ta.from_concrete(np.asarray(jnp.asarray(
        x, jnp.bfloat16)))) == facts(ref)
    nan = np.float32([1.0, np.nan])
    assert facts(ta.from_concrete(torch.from_numpy(nan).bfloat16())) == facts(
        ja.from_concrete(jnp.asarray(nan, jnp.bfloat16)))


def test_join_and_leq_equal_the_reference():
    a = np.float32([0.5])
    b = np.float32([-8.0, 3.0])
    tj = ta.join(ta.from_concrete(a), ta.from_concrete(b))
    jj = ja.join(ja.from_concrete(a), ja.from_concrete(b))
    assert facts(tj) == facts(jj)
    assert ta.leq(ta.from_concrete(a), tj) and ta.leq(ta.from_concrete(b), tj)
    assert ta.leq(tj, ta.join(tj, tj)) and ta.leq(ta.join(tj, tj), tj)
    for d_t, d_j in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16),
                     (torch.float16, jnp.float16), (torch.int32, jnp.int32),
                     (torch.bool, jnp.bool_)):
        assert facts(ta.top_for_dtype(d_t)) == facts(ja.top_for_dtype(d_j))


@pytest.mark.parametrize("e,m", [(8, m) for m in (2, 3, 5, 7, 10, 15, 23)]
                         + [(5, 10), (5, 7), (4, 3)])
def test_universal_exactness_equals_the_reference(e, m):
    for d_t, d_j in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float16, jnp.float16),
                     (torch.float32, jnp.float32)):
        assert ta.universally_exact(FPFormat(e, m), d_t) == \
            ja.universally_exact(JFormat(e, m), d_j), (e, m, d_t)
    assert ta.universally_exact(FPFormat(8, 7), torch.bfloat16)
    assert not ta.universally_exact(FPFormat(8, 5), torch.bfloat16)


def _abs_check(v, arr):
    """The concrete array lies inside the abstract value."""
    a = np.abs(np.asarray(arr, np.float64))
    if not np.all(np.isfinite(a)):
        assert v.hi == np.inf
        return
    amax = float(a.max()) if a.size else 0.0
    assert amax <= v.hi * (1 + 1e-9) + 1e-300, (amax, v.hi)
    assert v.lo <= amax * (1 + 1e-9) + 1e-300, (v.lo, amax)
    nz = a[a != 0]
    if nz.size:
        assert v.min_nz <= float(nz.min()) * (1 + 1e-9), (v.min_nz, nz.min())
    if np.isfinite(v.ulp_exp) and v.ulp_exp > -1000:
        q = np.asarray(arr, np.float64) / 2.0 ** v.ulp_exp
        assert np.allclose(q, np.round(q), rtol=0, atol=0), v.ulp_exp


def _carry_loop(x):
    c = 0.0 * x[0]
    ys = []
    for t in range(x.shape[0]):
        with loop_body("scan"):
            ys.append(c)
            c = c * 0.5 + x[t]
    return torch.stack(ys)


@pytest.mark.parametrize("fn,args", [
    (lambda x: torch.exp(-x * x) + 1.0, (np.float32([0.5, -2.0, 3.0]),)),
    (lambda x: torch.sum(x ** 2) / 4.0, (np.float32([1.0, 2.0]),)),
    (lambda x, w: torch.tanh(x @ w),
     (np.float32(np.arange(6).reshape(2, 3)) / 8,
      np.float32(np.ones((3, 2))) * 0.25)),
    (_carry_loop, (np.float32([1.0, 0.5, 0.25, 2.0]),)),
])
def test_outputs_sound_vs_concrete_eval(fn, args):
    targs = tuple(torch.from_numpy(a) for a in args)
    res = ta.analyze(fn, targs, calib=list(args))
    leaves = tensor_leaves(fn(*targs))
    assert len(leaves) == len(res.out_vals)
    for v, out in zip(res.out_vals, leaves):
        _abs_check(v, out.numpy())


def test_growing_loop_terminates_and_widens():
    """A strictly growing carry: the port widens its sites to the carrier
    top after ``warm_iters`` growing trips, as the reference's fixpoint
    does, and stays sound."""
    def f(x):
        c = x[0]
        for t in range(x.shape[0]):
            with loop_body("scan"):
                c = c * 2.0 + x[t]
        return c

    x = np.float32([1.0, 1.0, 1.0, 1.0])
    res = ta.analyze(f, (torch.from_numpy(x),), calib=[x])
    ref = ja.analyze_closed(
        jax.make_jaxpr(lambda x: jax.lax.scan(
            lambda c, t: (c * 2.0 + t, c), x[0], x)[0])(x), [x])
    assert res.n_widened >= 1 and ref.n_widened >= 1
    _abs_check(res.out_vals[0], f(torch.from_numpy(x)).numpy())


# --------------------------------------------------------------------------
# per-rung verdicts
# --------------------------------------------------------------------------

def _sod(dtype=torch.bfloat16):
    from repro_torch.apps import get_app
    app = get_app("sod")
    return app, app.init_state(dtype, device="cpu")


def _verdicts_port(fn, args, paths, calib=True):
    with torch.no_grad():
        res = ta.analyze(fn, args, calib=tensor_leaves(args) if calib
                         else None)
        index = tinterp.enumerate_sites(fn, args, {}, EVERYWHERE)
    return res, index, ta.scope_rung_verdicts(res, index, paths, WIDTHS, 8)


def test_sod_bf16_rung_verdicts_equal_the_reference():
    """Every e8m>=7 rung statically EXACT (and universally so), narrower
    rungs dynamic: the reference's table, rung for rung."""
    from repro.apps import get_app as jget_app
    from repro.search.scopes import discover_scopes as jdiscover
    from repro_torch.search.scopes import discover_scopes

    app, state = _sod()
    paths = [s.path for s in discover_scopes(app.run_observables, (state,))]
    _, _, sv = _verdicts_port(app.run_observables, (state,), paths)

    japp = jget_app("sod")
    jstate = japp.init_state(jnp.bfloat16)
    closed = jax.make_jaxpr(japp.run_observables)(jstate)
    jres = ja.analyze_closed(closed, jax.tree_util.tree_leaves(((jstate,),
                                                                {})))
    jpaths = [s.path for s in jdiscover(closed)]
    jsv = ja.scope_rung_verdicts(
        jres, jinterp.enumerate_sites(closed, J_EVERYWHERE), jpaths, WIDTHS,
        8)
    assert paths == jpaths
    assert sv.to_json() == jsv.to_json()
    for p in paths:
        for w in (15, 10, 7):
            assert sv.get(p, w) == ta.Verdict.EXACT and sv.is_universal(p, w)
        for w in (5, 3, 2):
            assert sv.get(p, w) == ta.Verdict.UNKNOWN
    assert sv.n_decided == jsv.n_decided == 3 * len(paths)


def _dense_bf16():
    jm, jp, jb, tm, tp, tb = setup("h2o-danube-1.8b", B=2, S=16,
                                   dtype="bfloat16")
    return jm, jp, jb, tm, tp, tb


def test_dense_bf16_rung_verdicts_equal_the_reference():
    from repro.search.scopes import discover_scopes as jdiscover
    from repro_torch.search.scopes import discover_scopes

    jm, jp, jb, tm, tp, tb = _dense_bf16()
    with torch.no_grad():
        paths = [s.path for s in discover_scopes(tm.loss, (tp, tb))]
    _, _, sv = _verdicts_port(tm.loss, (tp, tb), paths)
    closed = jax.make_jaxpr(jm.loss)(jp, jb)
    jres = ja.analyze_closed(closed, jax.tree_util.tree_leaves(((jp, jb),
                                                                {})))
    jpaths = [s.path for s in jdiscover(closed)]
    jsv = ja.scope_rung_verdicts(
        jres, jinterp.enumerate_sites(closed, J_EVERYWHERE), jpaths, WIDTHS,
        8)
    assert paths == jpaths
    assert sv.to_json() == jsv.to_json()
    assert sv.n_decided > 0


def _solo(path, w):
    return TruncationPolicy(rules=(
        TruncationRule(fmt=FPFormat(8, w), scope=path),))


def _confirm(fn, args, sv, paths):
    """Every decided rung against a concrete run under its solo policy."""
    with torch.no_grad():
        ref = tensor_leaves(fn(*args))
        n = 0
        for p in paths:
            for w in WIDTHS:
                v = sv.get(p, w)
                if v == ta.Verdict.UNKNOWN:
                    continue
                out = tensor_leaves(tc.truncate(fn, _solo(p, w))(*args))
                if v == ta.Verdict.EXACT:
                    for a, b in zip(ref, out):
                        assert torch.equal(a, b), (p, w)
                else:
                    assert not all(bool(torch.isfinite(b).all())
                                   for b in out), (p, w)
                n += 1
    return n


def test_sod_bf16_decided_rungs_hold_on_concrete_runs():
    from repro_torch.search.scopes import discover_scopes
    app, state = _sod()
    paths = [s.path for s in discover_scopes(app.run_observables, (state,))]
    _, _, sv = _verdicts_port(app.run_observables, (state,), paths)
    assert _confirm(app.run_observables, (state,), sv, paths) == sv.n_decided


def test_dense_bf16_decided_rungs_hold_on_concrete_runs():
    from repro_torch.search.scopes import discover_scopes
    jm, jp, jb, tm, tp, tb = _dense_bf16()
    with torch.no_grad():
        paths = [s.path for s in discover_scopes(tm.loss, (tp, tb))]
    _, _, sv = _verdicts_port(tm.loss, (tp, tb), paths)
    assert _confirm(tm.loss, (tp, tb), sv, paths) == sv.n_decided > 0


BIG = 3.3e38


def test_synthetic_overflow_splits_ladder():
    """A value provably at 3.3e38 overflows e8m2 / e8m3 (RNE boundaries
    3.19e38 / 3.296e38) but not e8m5 (3.378e38), as in the reference; the
    OVERFLOW_CERTAIN rungs give a non-finite output when run."""
    assert rne_overflow_boundary(FPFormat(8, 2)) < BIG
    assert rne_overflow_boundary(FPFormat(8, 3)) < BIG
    assert rne_overflow_boundary(FPFormat(8, 5)) > BIG

    def f(x):
        return x * BIG

    x = torch.tensor([1.0, -1.0])
    res = ta.analyze(f, (x,), calib=[x])
    index = tinterp.enumerate_sites(f, (x,), {}, EVERYWHERE)
    sv = ta.scope_rung_verdicts(res, index, ["**"], [5, 3, 2], 8)
    assert sv.get("**", 2) == ta.Verdict.OVERFLOW_CERTAIN
    assert sv.get("**", 3) == ta.Verdict.OVERFLOW_CERTAIN
    assert sv.get("**", 5) == ta.Verdict.UNKNOWN
    closed = jax.make_jaxpr(lambda x: x * np.float32(BIG))(x.numpy())
    jsv = ja.scope_rung_verdicts(
        ja.analyze_closed(closed, [x.numpy()]),
        jinterp.enumerate_sites(closed, J_EVERYWHERE), ["**"], [5, 3, 2], 8)
    assert sv.to_json() == jsv.to_json()
    for w in (2, 3):
        out = tc.truncate(f, _solo("**", w))(x)
        assert not torch.isfinite(out).any()


def test_overflow_needs_criticality():
    """The same overflowing site feeding only a bounded output (tanh) is
    not certain to surface: UNKNOWN."""
    def f(x):
        return torch.tanh(x * BIG)

    x = torch.tensor([1.0])
    res = ta.analyze(f, (x,), calib=[x])
    index = tinterp.enumerate_sites(f, (x,), {}, EVERYWHERE)
    sv = ta.scope_rung_verdicts(res, index, ["**"], [2], 8)
    assert sv.get("**", 2) == ta.Verdict.UNKNOWN


def test_a_loop_on_a_tensor_value_has_no_critical_site():
    """A Python ``while`` on a tensor's value (the host reads it: the
    port's ``while``): the overflowing site before it is no longer
    certain to surface, as the reference's ``lax.while_loop`` makes it."""
    def f(x):
        y = x * BIG
        n = 0
        while bool((y != 0).any()) and n < 2:
            with loop_body("w"):
                y = y * 1.0
            n += 1
        return y

    def jf(x):
        y = x * np.float32(BIG)
        return jax.lax.while_loop(
            lambda c: jnp.any(c[0] != 0) & (c[1] < 2),
            lambda c: (c[0] * 1.0, c[1] + 1), (y, 0))[0]

    x = torch.tensor([1.0, -1.0])
    res = ta.analyze(f, (x,), calib=[x])
    assert not res.critical
    index = tinterp.enumerate_sites(f, (x,), {}, EVERYWHERE)
    sv = ta.scope_rung_verdicts(res, index, ["**"], [3, 2], 8)
    closed = jax.make_jaxpr(jf)(x.numpy())
    jsv = ja.scope_rung_verdicts(
        ja.analyze_closed(closed, [x.numpy()]),
        jinterp.enumerate_sites(closed, J_EVERYWHERE), ["**"], [3, 2], 8)
    assert sv.to_json() == jsv.to_json() == {"**": {"m3": "UNKNOWN",
                                                     "m2": "UNKNOWN"}}
    # without the loop the same site is critical
    assert ta.analyze(lambda x: x * BIG, (x,), calib=[x]).critical


def test_the_analysis_launches_no_quantizer(monkeypatch):
    calls = []
    for name in ("quantize", "quantize_dynamic", "quantize_prepared"):
        real = getattr(qops, name)

        def spy(*a, _real=real, **k):
            calls.append(1)
            return _real(*a, **k)
        monkeypatch.setattr(qops, name, spy)
    app, state = _sod()
    with torch.no_grad():
        ta.analyze(app.run_observables, (state,),
                   calib=tensor_leaves(state))
    assert not calls


# --------------------------------------------------------------------------
# the analysis runs to its end across the config zoo
# --------------------------------------------------------------------------

from repro_torch.configs.base import ARCH_IDS  # noqa: E402

_FAST_ARCHS = {"h2o-danube-1.8b", "olmoe-1b-7b"}
_ARCH_PARAMS = [
    a if a in _FAST_ARCHS else pytest.param(a, marks=pytest.mark.slow)
    for a in ARCH_IDS
]


@pytest.mark.parametrize("arch_id", _ARCH_PARAMS)
def test_analysis_terminates_on_arch_configs(arch_id):
    """Each smoke config's loss from dtype tops: records for every site an
    enumeration gives, one envelope per output."""
    jm, jp, jb, tm, tp, tb = setup(arch_id, B=2, S=16)
    with torch.no_grad():
        res = ta.analyze(tm.loss, (tp, tb))
        index = tinterp.enumerate_sites(tm.loss, (tp, tb), {}, EVERYWHERE)
    assert len(res.records) > 0
    assert all(k in res.records for k in index.site_keys())
    assert len(res.out_vals) == 1 and not math.isnan(res.out_vals[0].hi)
