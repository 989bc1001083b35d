"""The port's PDE mini-apps (``repro_torch.apps``) and their FP64 oracle
against the reference's, at the reference's small sizes
(``tests/test_apps.py``), JAX on the CPU.

Tolerances. Initial states: bit-equal (both are the same numpy f64 data
rounded through f32). Plain f32 observables: within 1e-5 (the runs differ
in the last bits: XLA contracts ``a*b+c`` to an fma in the Rusanov flux
and the CG axpys, and sums in another order; ROADMAP Queue C). FP64 oracle
observables: within 1e-12. A field compares by relative L2, a scalar
relative to ``max(|value|, 1)``: Poisson's relative residual is a
normalised norm at the solver's noise floor (1e-6 in f32, 1e-11 in f64),
whose relative change says nothing. ``observable_error`` and the
oracle verdict on the same numpy observables: equal. Searches: as in
``test_torch_search.py``. Inside the port, a swept table is bit-equal to
``truncate`` of the same policy.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import search as js
from repro.apps import get_app as jget_app
from repro.apps import observable_error as jobservable_error
from repro.apps import oracle as joracle
from repro.compat import enable_x64
from repro.core import interpreter as jinterp
from repro.core.formats import FPFormat as JFPFormat
from repro.core.policy import TruncationPolicy as JPolicy
from repro.core.policy import TruncationRule as JRule

from repro_torch import search as ts
from repro_torch.apps import (
    APPS, HeatDiffusion, PoissonCG, SodShockTube, get_app, observable_error,
    oracle,
)
from repro_torch.core import (
    FPFormat, TruncationPolicy, TruncationRule, memtrace, profile_counts,
    truncate, truncate_sweep,
)
from repro_torch.search.metrics import tree_leaves

from test_torch_search import assert_same_search

SMALL = {
    "sod": dict(n_cells=32, t_end=0.04),
    "heat": dict(n=8, n_explicit=8, n_implicit=1, cg_iters=6),
    "poisson": dict(n=8, cg_iters=12),
}
NAMES = sorted(APPS)


def apps(name):
    return jget_app(name, **SMALL[name]), get_app(name, **SMALL[name])


def states(name):
    ja, ta = apps(name)
    return ja, ja.init_state(jnp.float32), ta, ta.init_state(device="cpu")


def host(obs):
    return {k: np.asarray(jax.device_get(v)) if not torch.is_tensor(v)
            else v.numpy() for k, v in obs.items()}


def obs_close(want, got, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k], np.float64), np.asarray(got[k], np.float64)
        if w.size == 1:
            d = abs(g.item() - w.item()) / max(abs(w.item()), 1.0)
        else:
            d = np.linalg.norm((g - w).ravel()) / np.linalg.norm(w.ravel())
        assert d <= tol, (k, d)


def site_policy(app, cls=TruncationPolicy, rule=TruncationRule, fmt=FPFormat):
    return cls(rules=tuple(rule(fmt=fmt(8, 0), scope=s)
                           for s in app.default_policy_scopes()))


@pytest.mark.parametrize("name", NAMES)
def test_init_state_is_bit_equal_to_the_reference(name):
    ja, ta = apps(name)
    for dt in (torch.float32, torch.float64):
        got = tree_leaves(ta.init_state(dt, device="cpu"))
        with enable_x64():
            want = jax.tree_util.tree_leaves(
                ja.init_state(jnp.float32 if dt == torch.float32
                              else jnp.float64))
            want = [np.asarray(w) for w in want]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == dt and g.device.type == "cpu"
            assert g.numpy().dtype == w.dtype
            assert np.array_equal(g.numpy().view(np.uint8),
                                  w.view(np.uint8))


@pytest.mark.parametrize("name", NAMES)
def test_plain_observables_match_the_reference(name):
    ja, js_, ta, ts_ = states(name)
    jo, to = host(ja.run_observables(js_)), host(ta.run_observables(ts_))
    assert sorted(to) == sorted(jo)
    assert all(to[k].dtype == np.float32 for k in to)
    obs_close(jo, to, 1e-5)
    assert ta.error_metric(to, to) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_sites_match_the_reference(name):
    """Each scope has the reference's sites in the reference's order: one
    hidden loop body per trajectory loop (and for the second entries into
    ``coeffs`` / ``update`` of a CG iteration) keeps every trip on one set
    of sites, as a scanned body is there. The one difference: ``jnp.pad``
    traces its zero as a float ``convert_element_type`` under
    ``poisson/matvec`` (a constant; rounding it moves nothing), which
    ``F.pad`` never materialises."""
    ja, js_, ta, ts_ = states(name)
    closed = jax.make_jaxpr(ja.run_observables)(js_)
    index = jinterp.enumerate_sites(
        closed, site_policy(ja, JPolicy, JRule, JFPFormat))
    want = [(s.scope, s.prim) for s in index.sites]
    handle = truncate_sweep(ta.run_observables, site_policy(ta))(ts_)
    got = [(s.scope, s.prim) for s in handle.sites]
    if name == "poisson":
        want.remove(("poisson/matvec", "convert_element_type"))
        assert handle.num_sites == len(index.sites) - 1
    else:
        assert handle.num_sites == len(index.sites)
    assert got == want
    # every trip of every loop runs every site
    assert handle.site_executions > handle.num_sites


@pytest.mark.parametrize("name", NAMES)
def test_sweep_is_bit_equal_to_truncate(name):
    """The runtime-table path against per-policy truncate on each app, for
    a ladder of uniform policies over the app's scopes."""
    _, _, ta, ts_ = states(name)
    handle = truncate_sweep(ta.run_observables, site_policy(ta))(ts_)
    ladder = [ta.uniform_policy(f"e8m{m}") for m in (10, 5, 3)]
    batched = handle.batch(handle.tables(ladder))
    plain = ta.run_observables(ts_)
    for k, pol in enumerate(ladder):
        direct = truncate(ta.run_observables, pol)(ts_)
        swept = handle(handle.table(pol))
        for key in direct:
            d = direct[key].view(torch.int32)
            assert torch.equal(swept[key].view(torch.int32), d), key
            assert torch.equal(batched[key][k].view(torch.int32), d), key
        assert observable_error(plain, direct) > 0.0


@pytest.mark.parametrize("name", NAMES)
def test_oracle_matches_the_reference(name):
    """The FP64 trajectory, ``observable_error`` and the verdict of the same
    numpy observables in both packages."""
    ja, js_, ta, ts_ = states(name)
    ref_t = oracle.fp64_reference(ta, device="cpu")
    ref_j = joracle.fp64_reference(ja)
    assert sorted(ref_t) == sorted(ref_j)
    assert all(v.dtype == np.float64 for v in ref_t.values())
    obs_close(ref_j, ref_t, 1e-12)
    cand = host(truncate(ta.run_observables, ta.uniform_policy())(ts_))
    assert observable_error(ref_j, cand) == jobservable_error(ref_j, cand)
    assert ta.error_metric(ref_j, cand) == ja.error_metric(ref_j, cand)
    vt = oracle.verdict(ta, cand, ref_j, device="cpu")
    vj = joracle.verdict(ja, cand, ref_j)
    assert vt.error == vj.error and vt.budget == vj.budget
    assert vt.passed == vj.passed and vt.app == vj.app == name
    assert vt.floor == pytest.approx(vj.floor, rel=1e-2, abs=1e-7)
    assert vt.floor <= vt.budget / 10.0
    assert oracle.OracleVerdict.from_json(vt.to_json()) == vt
    assert vt.to_json()["passed"] == vt.passed and str(vt).startswith(
        f"[{name}]")
    # the plain f32 run is its own floor
    f32 = oracle.fp32_observables(ta, device="cpu")
    assert oracle.oracle_error(ta, f32, ref_t) == \
        oracle.fp32_floor(ta, ref_t, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_search_matches_the_reference(name):
    ja, js_, ta, ts_ = states(name)
    kw = dict(budget=32, threshold=ja.search_threshold)
    rj = js.autosearch(ja.run_observables, (js_,), metric=ja.error_metric,
                       **kw)
    rt = ts.autosearch(ta.run_observables, (ts_,), metric=ta.error_metric,
                       **kw)
    assert_same_search(rj, rt)
    assert [s.path for s in (a.scope for a in rt.assignments.values())] == \
        [s.path for s in (a.scope for a in rj.assignments.values())]
    assert rt.converged and len(rt.policy().rules) >= 1
    obs = truncate(ta.run_observables, rt.policy())(ts_)
    assert ta.error_metric(host(ta.run_observables(ts_)), host(obs)) == \
        rt.final_error


@pytest.mark.parametrize("name", NAMES)
def test_memtrace_flags_land_in_the_app_scopes(name):
    _, _, ta, ts_ = states(name)
    out, rep = memtrace(ta.run_observables, ta.uniform_policy(),
                        threshold=1e-3)(ts_)
    assert int(rep.flags.sum()) > 0
    root = ta.default_policy_scopes()[0].split("/")[0]
    flagged = [loc for loc, n, _ in rep.top(len(rep.locations)) if n > 0]
    assert flagged and all(loc.startswith(root + "/") for loc in flagged)
    direct = truncate(ta.run_observables, ta.uniform_policy())(ts_)
    for key in direct:
        assert torch.equal(out[key].view(torch.int32),
                           direct[key].view(torch.int32))


@pytest.mark.parametrize("name", NAMES)
def test_profile_counts_split_the_app(name):
    _, _, ta, ts_ = states(name)
    rep = profile_counts(ta.run_observables, ta.uniform_policy())(ts_)
    # the solver scopes carry truncated work; the harness (observables)
    # must not be matched by the scoped policy
    assert 0.0 < rep.truncated_fraction < 1.0
    tree = ts.scope_tree(ta.run_observables, (ts_,))
    for s in ta.default_policy_scopes():
        assert s in tree


@pytest.mark.parametrize("name", NAMES)
def test_entry_points_do_not_pick_the_cpu_on_their_own(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ta = apps(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.init_state()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.init_state(torch.float64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oracle.fp64_reference(ta)


def test_registry_and_what_is_not_ported():
    assert sorted(APPS) == ["heat", "poisson", "sod"]
    assert isinstance(get_app("sod", n_cells=16), SodShockTube)
    assert isinstance(get_app("heat"), HeatDiffusion)
    assert isinstance(get_app("poisson"), PoissonCG)
    with pytest.raises(ValueError):
        get_app("navier-stokes")
    for name in NAMES:
        ja, ta = jget_app(name), get_app(name)
        for attr in ("n_steps", "error_budget", "search_threshold",
                     "uniform_low", "probe_format", "name"):
            assert getattr(ta, attr) == getattr(ja, attr), (name, attr)
        assert ta.default_policy_scopes() == ja.default_policy_scopes()
    ta = get_app("sod", **SMALL["sod"])
    with pytest.raises(NotImplementedError, match="item 4"):
        ta.profile_trajectory()
    with pytest.raises(NotImplementedError, match="item 4"):
        ta.warm_hints()
    v = oracle.OracleVerdict("sod", 1e-3, 2e-2, 1e-5)
    with pytest.raises(NotImplementedError, match="item 6"):
        v.attach(object())


def test_observable_error_edges():
    a = {"x": torch.tensor(2.0), "f": torch.ones(4)}
    assert observable_error(a, a) == 0.0
    bad = {"x": torch.tensor(float("nan")), "f": torch.ones(4)}
    assert observable_error(a, bad) == float("inf")
    with pytest.raises(ValueError):
        observable_error(a, {"x": torch.tensor(1.0)})
    an = {k: v.numpy() for k, v in a.items()}
    assert observable_error(an, {"x": np.float32(3.0), "f": np.ones(4)}) == \
        jobservable_error(an, {"x": np.float32(3.0), "f": np.ones(4)})
