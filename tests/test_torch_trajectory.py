"""Trajectory profiling of the port (``repro_torch.profile``,
``profile_trajectory``) against the reference's, case by case: each case of
``tests/test_trajectory.py`` runs through both packages on the same numpy
inputs, plus the two places where the port must decide what a step is (a
model's layer loop, a one-trip frame).

The reference's ``lax.scan`` / ``while_loop`` become Python loops under
``loop_body``; a step is one trip of an outermost loop in both packages.

Tolerances. Within the port, the trajectory's whole-run totals are bit for
bit ``memtrace``'s and its outputs ``truncate``'s. Between packages:
``steps_seen``, per-step ``op_counts``, onsets and blame order equal;
per-step ``max_rel`` bit-equal on the small programs and, on the model,
within ``test_torch_memmode.py``'s tolerance (2 % relative, 1e-6 absolute);
the |error| and |shadow| sums within 1e-5 relative (summation order).
"""
import contextlib
import math
from collections import OrderedDict

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
import torch

import repro.core as jc
from repro.apps import get_app as jget_app
from repro.apps.base import cg_iteration as jcg_iteration
from repro.configs.base import get_config as jget_config
from repro.core.memmode import RaptorReport as JRaptorReport
from repro.models import Model as JModel
from repro.profile import TrajectoryReport as JTrajectoryReport
from repro.profile import ladder_hints as jladder_hints

import repro_torch.core as tc
from repro_torch.apps import get_app
from repro_torch.apps.base import cg_iteration
from repro_torch.configs import get_config
from repro_torch.core import loop_body, scope
from repro_torch.core.memmode import NO_LOCATIONS, RaptorReport
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.profile import (
    TrajectoryReport, fit_log2_trend, ladder_hints, scope_of_location,
)

from test_torch_distributed import one_rank  # noqa: F401 (a fixture)

# exact vs lossy per-step factors: x2.0 only shifts the exponent (exact in
# every e?m? format), x1.09 rounds at 2 mantissa bits
EXACT, LOSSY = 2.0, 1.09


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(jax.device_get(x))


def jstaged(n_exact: int, n_total: int):
    def f(x):
        def body(c, t):
            with jc.scope("stage"):
                fac = jnp.where(t < n_exact, jnp.asarray(EXACT, c.dtype),
                                jnp.asarray(LOSSY, c.dtype))
                c = c * fac
            return c, None
        y, _ = lax.scan(body, x, jnp.arange(n_total, dtype=jnp.int32))
        return jnp.sum(y)
    return f


def tstaged(n_exact: int, n_total: int):
    """``jstaged``: error first appears at step ``n_exact``."""
    def f(x):
        for t in range(n_total):
            with loop_body("step"):
                with scope("stage"):
                    x = x * (EXACT if t < n_exact else LOSSY)
        return x.sum()
    return f


def both(jf, tf, x, n_steps, fmt="e5m2", threshold=1e-3, sites=None):
    j = jc.profile_trajectory(jf, jc.TruncationPolicy.everywhere(fmt),
                              threshold=threshold, n_steps=n_steps,
                              sites=sites)(jnp.asarray(x))
    t = tc.profile_trajectory(tf, tc.TruncationPolicy.everywhere(fmt),
                              threshold=threshold, n_steps=n_steps,
                              sites=sites)(torch.from_numpy(x.copy()))
    return j, t


def site_names(locs):
    """Location descriptions without their ``@ file:line``."""
    return [loc.split(" @ ")[0] for loc in locs]


def assert_same_trajectory(jt, tt):
    """Bit for bit on the small programs: steps, counts, per-step maxima,
    scopes, onsets, blame; the float sums within summation order."""
    assert site_names(tt.locations) == site_names(jt.locations)
    assert tt.scopes == jt.scopes
    assert int(host(tt.steps_seen)) == int(host(jt.steps_seen))
    assert tt.n_steps == jt.n_steps and tt.used_rows() == jt.used_rows()
    np.testing.assert_array_equal(host(tt.op_counts), host(jt.op_counts))
    np.testing.assert_array_equal(host(tt.max_rel), host(jt.max_rel))
    for name in ("abs_sum", "mag_sum"):
        np.testing.assert_allclose(host(getattr(tt, name)),
                                   host(getattr(jt, name)), rtol=1e-5)
    for thr in (1e-3, 1e-1):
        np.testing.assert_array_equal(tt.onset_steps(thr),
                                      jt.onset_steps(thr))
        assert [(b.scope, b.onset, b.flags, b.n_sites)
                for b in tt.blame(thr)] == \
            [(b.scope, b.onset, b.flags, b.n_sites) for b in jt.blame(thr)]


# --------------------------------------------------------------------------
# tests/test_trajectory.py, through both packages
# --------------------------------------------------------------------------

def test_trajectory_totals_match_memtrace():
    """The trajectory report's whole-run totals are bit-identical to plain
    mem-mode, and outputs are unchanged."""
    x = np.asarray([1.0, 2.0], np.float32)
    (jo, jt), (to, tt) = both(jstaged(0, 6), tstaged(0, 6), x, 8)
    pol = tc.TruncationPolicy.everywhere("e5m2")
    out_m, rep = tc.memtrace(tstaged(0, 6), pol, threshold=1e-3)(
        torch.from_numpy(x))
    assert isinstance(tt, TrajectoryReport)
    assert torch.equal(to, out_m)
    assert torch.equal(to, tc.truncate(tstaged(0, 6), pol)(torch.from_numpy(x)))
    assert float(to) == float(jo)
    assert tt.locations == rep.locations
    for a, b in ((tt.totals.flags, rep.flags),
                 (tt.totals.max_rel, rep.max_rel),
                 (tt.totals.op_counts, rep.op_counts)):
        assert torch.equal(a, b)
    assert_same_trajectory(jt, tt)


def test_divergence_onset_detected_at_the_right_step():
    k, n = 3, 8
    x = np.asarray([1.0, 1.5], np.float32)
    (_, jt), (_, tt) = both(jstaged(k, n), tstaged(k, n), x, n + 1)
    assert int(host(tt.steps_seen)) == n
    (i,) = [j for j, s in enumerate(tt.scopes) if s == "stage"]
    assert tt.onset_steps(1e-3)[i] == k
    m = host(tt.max_rel)
    assert np.all(m[:k, i] == 0.0) and np.all(m[k:n, i] > 0.0)
    blame = tt.blame(1e-3)
    assert blame[0].scope == "stage" and blame[0].onset == k
    assert_same_trajectory(jt, tt)


def test_onset_through_while_loop_carry():
    """A Python ``while`` under ``loop_body`` is the reference's
    ``while_loop``: one step a trip, onset after trip k > 1, every trip's
    elements counted."""
    k, n = 2, 5

    def jf(x):
        def cond(c):
            return c[0] < n

        def body(c):
            i, v = c
            with jc.scope("w"):
                fac = jnp.where(i < k, jnp.asarray(EXACT, v.dtype),
                                jnp.asarray(LOSSY, v.dtype))
                v = v * fac
            return (i + 1, v)

        return jnp.sum(lax.while_loop(cond, body, (jnp.int32(0), x))[1])

    def tf(x):
        i = 0
        while i < n:
            with loop_body("while"):
                with scope("w"):
                    x = x * (EXACT if i < k else LOSSY)
            i += 1
        return x.sum()

    x = np.asarray([1.0, 2.0], np.float32)
    (_, jt), (_, tt) = both(jf, tf, x, n)
    (i,) = [j for j, s in enumerate(tt.scopes) if s == "w"]
    assert int(host(tt.steps_seen)) == n
    assert tt.onset_steps(1e-3)[i] == k
    assert int(host(tt.op_counts)[:, i].sum()) == 2 * n
    assert int(host(jt.op_counts)[:, i].sum()) == 2 * n
    np.testing.assert_array_equal(host(tt.max_rel)[:, i],
                                  host(jt.max_rel)[:, i])


def test_ring_buffer_wraps_and_reports_steps_seen():
    n = 10
    x = np.asarray([1.0], np.float32)
    (_, jt), (_, tt) = both(jstaged(0, n), tstaged(0, n), x, 4)
    assert tt.n_steps == 4
    assert int(host(tt.steps_seen)) == n
    assert tt.used_rows() == 4
    (i,) = [j for j, s in enumerate(tt.scopes) if s == "stage"]
    assert np.all(host(tt.op_counts)[:, i] > 0)
    assert_same_trajectory(jt, tt)


def test_post_loop_ops_visible_to_blame():
    """Truncated ops AFTER the outermost loop accumulate in the trailing
    row (index steps_seen); blame sees that row."""
    n = 3

    def jf(x):
        def body(c, _):
            with jc.scope("loop"):
                c = c * jnp.asarray(2.0, c.dtype)
            return c, None
        y, _ = lax.scan(body, x, None, length=n)
        with jc.scope("tail"):
            return jnp.sum(y * jnp.asarray(1.09, y.dtype))

    def tf(x):
        for _ in range(n):
            with loop_body("step"):
                with scope("loop"):
                    x = x * 2.0
        with scope("tail"):
            return (x * 1.09).sum()

    x = np.asarray([1.0, 2.0], np.float32)
    (_, jt), (_, tt) = both(jf, tf, x, n + 1)
    assert int(host(tt.steps_seen)) == n
    assert tt.used_rows() == n + 1
    idxs = [j for j, s in enumerate(tt.scopes) if s == "tail"]
    assert idxs and all(tt.onset_steps(1e-3)[i] == n for i in idxs)
    blame = {b.scope: b for b in tt.blame(1e-3)}
    assert blame["tail"].peak_rel > 0 and blame["tail"].onset == n
    assert_same_trajectory(jt, tt)


def test_straight_line_program_lands_in_row_zero():
    def jf(x):
        with jc.scope("s"):
            return jnp.sum(x * 1.09)

    def tf(x):
        with scope("s"):
            return (x * 1.09).sum()

    x = np.asarray([1.0, 2.0], np.float32)
    (_, jt), (_, tt) = both(jf, tf, x, 3)
    assert int(host(tt.steps_seen)) == 0
    assert tt.used_rows() == 1
    assert int(host(tt.op_counts)[0].sum()) > 0
    assert int(host(tt.op_counts)[1:].sum()) == 0
    assert_same_trajectory(jt, tt)


# --------------------------------------------------------------------------
# what a step is in the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("outer", ["loop_body", "scope_loop"])
def test_only_outermost_loop_trips_are_steps(outer):
    """Inner loop trips accumulate into their enclosing step's row, whether
    the outer loop is a ``loop_body`` or a ``scope(..., loop=True)`` entry
    (a scanned stack in the reference, like a model's layers)."""
    def jf(x):
        def inner(c, _):
            with jc.scope("inner"):
                return c * jnp.asarray(LOSSY, c.dtype), None

        def body(c, _):
            with jc.scope("outer"):
                c, _ = lax.scan(inner, c, None, length=3)
            return c, None
        y, _ = lax.scan(body, x, None, length=4)
        return jnp.sum(y)

    def tf(x):
        for _ in range(4):
            trip = (loop_body("o") if outer == "loop_body"
                    else contextlib.nullcontext())
            with trip:
                with scope("outer", loop=outer == "scope_loop"):
                    for _ in range(3):
                        with loop_body("inner"):
                            with scope("inner"):
                                x = x * LOSSY
        return x.sum()

    x = np.asarray([1.0, 2.0], np.float32)
    (_, jt), (_, tt) = both(jf, tf, x, 5)
    assert int(host(tt.steps_seen)) == 4
    (i,) = [j for j, s in enumerate(tt.scopes) if s == "outer/inner"]
    assert host(tt.op_counts)[:, i].tolist() == [6, 6, 6, 6, 0]
    assert_same_trajectory(jt, tt)


def test_one_trip_frame_is_never_a_step():
    """``cg_iteration``'s second entries into ``coeffs`` and ``update`` run
    in a one-trip hidden frame: straight-line code in the reference, so not
    a step even at depth 0."""
    def lap(v):
        return 4.0 * v - jnp.roll(v, 1) - jnp.roll(v, -1)

    def tlap(v):
        return 4.0 * v - torch.roll(v, 1) - torch.roll(v, -1)

    def jf(b):
        x, r, p = jcg_iteration(lap, jnp.zeros_like(b), b, b)
        return jnp.sum(x * x)

    def tf(b):
        x, r, p = cg_iteration(tlap, torch.zeros_like(b), b, b)
        return (x * x).sum()

    b = np.random.RandomState(0).randn(16).astype(np.float32)
    (_, jt), (_, tt) = both(jf, tf, b, 2, fmt="e8m5")
    assert int(host(jt.steps_seen)) == 0
    assert int(host(tt.steps_seen)) == 0
    assert int(host(tt.op_counts)[1].sum()) == 0


def test_poisson_steps_are_its_cg_iterations():
    """Every CG iteration is one step in both packages; the iteration's
    one-trip frame adds none."""
    ja, ta = (jget_app("poisson", n=8, cg_iters=6),
              get_app("poisson", n=8, cg_iters=6))
    _, jt = ja.profile_trajectory()
    _, tt = ta.profile_trajectory(ta.init_state(device="cpu"))
    assert int(host(tt.steps_seen)) == int(host(jt.steps_seen)) == ta.n_steps
    assert tt.n_steps == jt.n_steps == ta.n_steps + 1
    assert [b.scope for b in tt.blame(1e-3)] == \
        [b.scope for b in jt.blame(1e-3)]


# --------------------------------------------------------------------------
# merge / allreduce edge cases (mirroring test_report_merge.py)
# --------------------------------------------------------------------------

def _traj(locs, scopes, max_rel, abs_sum, mag_sum, ops, steps):
    """The same report in both packages, from the same lists."""
    ops_np = np.asarray(ops)
    jtot = JRaptorReport(tuple(locs),
                         jnp.asarray(np.sum(ops_np, 0), jnp.int32),
                         jnp.asarray(np.max(np.asarray(max_rel), 0),
                                     jnp.float32),
                         jnp.asarray(np.sum(ops_np, 0), jnp.int32))
    j = JTrajectoryReport(
        totals=jtot, scopes=tuple(scopes),
        max_rel=jnp.asarray(max_rel, jnp.float32),
        abs_sum=jnp.asarray(abs_sum, jnp.float32),
        mag_sum=jnp.asarray(mag_sum, jnp.float32),
        op_counts=jnp.asarray(ops, jnp.int32), steps_seen=jnp.int32(steps))
    f32, i64 = torch.float32, torch.int64
    ttot = RaptorReport(tuple(locs),
                        torch.tensor(np.sum(ops_np, 0), dtype=i64),
                        torch.tensor(np.max(np.asarray(max_rel), 0),
                                     dtype=f32),
                        torch.tensor(np.sum(ops_np, 0), dtype=i64))
    t = TrajectoryReport(
        totals=ttot, scopes=tuple(scopes),
        max_rel=torch.tensor(max_rel, dtype=f32),
        abs_sum=torch.tensor(abs_sum, dtype=f32),
        mag_sum=torch.tensor(mag_sum, dtype=f32),
        op_counts=torch.tensor(ops, dtype=i64),
        steps_seen=torch.tensor(steps, dtype=torch.int32))
    return j, t


def test_merge_sums_and_maxes_per_step():
    ja, ta = _traj(["l0", "l1"], ["a", "b"], [[0.5, 0.0], [0.125, 0.25]],
                   [[1.0, 0.0], [0.5, 2.0]], [[4.0, 1.0], [4.0, 1.0]],
                   [[2, 1], [2, 1]], 2)
    jb, tb = _traj(["l0", "l1"], ["a", "b"], [[0.25, 1.5], [0.0, 0.0]],
                   [[1.0, 1.0], [0.5, 0.0]], [[4.0, 1.0], [4.0, 1.0]],
                   [[2, 1], [2, 1]], 2)
    jm, tm = ja.merge(jb), ta.merge(tb)
    assert tm.max_rel.tolist() == [[0.5, 1.5], [0.125, 0.25]]
    assert tm.abs_sum.tolist() == [[2.0, 1.0], [1.0, 2.0]]
    assert tm.op_counts.tolist() == [[4, 2], [4, 2]]
    assert int(tm.steps_seen) == 2
    for name in ("max_rel", "abs_sum", "mag_sum", "op_counts", "steps_seen"):
        np.testing.assert_array_equal(host(getattr(tm, name)),
                                      host(getattr(jm, name)))
    # a report read back from another process: numpy statistics merge too
    tn = TrajectoryReport(totals=tb.totals, scopes=tb.scopes,
                          **{k: host(getattr(tb, k)) for k in (
                              "max_rel", "abs_sum", "mag_sum", "op_counts",
                              "steps_seen")})
    assert torch.equal(ta.merge(tn).abs_sum, tm.abs_sum)


def test_merge_single_step_buffer():
    _, a = _traj(["l0"], ["s"], [[0.5]], [[1.0]], [[2.0]], [[3]], 1)
    assert TrajectoryReport.merge_all([a]) is a
    m2 = a.merge(a)
    assert m2.n_steps == 1
    assert m2.op_counts.tolist() == [[6]]


def test_merge_mismatched_step_counts_raises():
    _, a = _traj(["l0"], ["s"], [[0.5]], [[1.0]], [[2.0]], [[3]], 1)
    _, b = _traj(["l0"], ["s"], [[0.5], [0.5]], [[1.0], [1.0]],
                 [[2.0], [2.0]], [[3], [3]], 2)
    with pytest.raises(ValueError, match="step buffers differ"):
        a.merge(b)


def test_merge_mismatched_locations_raises():
    _, a = _traj(["l0"], ["s"], [[0.5]], [[1.0]], [[2.0]], [[3]], 1)
    _, b = _traj(["OTHER"], ["s"], [[0.5]], [[1.0]], [[2.0]], [[3]], 1)
    with pytest.raises(ValueError, match="location tables differ"):
        a.merge(b)


def test_merge_all_empty_raises():
    with pytest.raises(ValueError, match="at least one report"):
        TrajectoryReport.merge_all([])


def test_empty_location_table_sentinel():
    def jf(x):
        return x * 2.0

    def tf(x):
        return x * 2.0

    x = np.ones((3,), np.float32)
    j = jc.profile_trajectory(jf, jc.TruncationPolicy(rules=()),
                              threshold=1e-3, n_steps=2)(jnp.asarray(x))[1]
    t = tc.profile_trajectory(tf, tc.TruncationPolicy(rules=()),
                              threshold=1e-3, n_steps=2)(torch.from_numpy(x))[1]
    assert t.locations == j.locations == (NO_LOCATIONS,)
    assert t.scopes == j.scopes == ("",)
    m = t.merge(t)
    assert int(m.op_counts.sum()) == 0
    assert t.blame(1e-3) == j.blame(1e-3) == []
    assert t.onset_steps(1e-3).tolist() == [-1]
    assert tuple(t.max_rel.shape) == tuple(j.max_rel.shape) == (2, 1)


def test_allreduce_needs_the_distribution_layer(one_rank):
    """The reduction over a mesh axis needs a mesh (``mesh=`` or
    ``use_mesh``, as the reference's needs a mapped axis); over the data
    axis of a one-rank mesh it is the identity, bit for bit (several ranks:
    ``test_torch_spmd.py``)."""
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import make_profile_mesh
    _, a = _traj(["l0"], ["s"], [[0.5]], [[1.0]], [[2.0]], [[3]], 1)
    with pytest.raises(ValueError, match="DeviceMesh"):
        a.allreduce("data")
    mesh = make_profile_mesh(1, 1, device="cpu")
    with use_mesh(mesh):
        b = a.allreduce("data")
    for k in ("max_rel", "abs_sum", "mag_sum", "op_counts", "steps_seen"):
        assert torch.equal(torch.as_tensor(getattr(b, k)),
                           torch.as_tensor(getattr(a, k))), k
    assert torch.equal(b.totals.flags, torch.as_tensor(a.totals.flags))


# --------------------------------------------------------------------------
# blame -> warm-start hints
# --------------------------------------------------------------------------

def test_scope_of_location():
    assert scope_of_location("hydro/eos div @ sod.py:81") == "hydro/eos"
    assert scope_of_location("<root> add @ f.py:1") == ""
    assert scope_of_location(NO_LOCATIONS) == ""
    assert scope_of_location("transpose(jvp(mlp))/dot mul @ m.py:3") == \
        "mlp/dot"


def test_fit_log2_trend_matches_the_reference():
    from repro.profile import fit_log2_trend as jfit
    r = np.random.RandomState(0)
    for vals in ([1.0, 2.0, 4.0, 8.0], [0.0, np.inf, 3.0], [5.0],
                 list(r.rand(9)), [0.0, 0.0]):
        steps = np.arange(len(vals))
        assert fit_log2_trend(steps, vals) == jfit(steps, vals)


def test_ladder_hints_stable_aggressive_unstable_pinned():
    widths = (23, 15, 10, 7, 5, 3, 2)
    jt, t = _traj(["a x @ f:1", "b x @ f:2"], ["calm", "wild"],
                  [[0.0, 1.9]], [[0.0, 8.0]], [[4.0, 4.0]], [[4, 4]], 1)
    hints = ladder_hints(t, widths, threshold=1e-3, probe_man_bits=5)
    assert hints == {"calm": 2, "wild": None}
    hints_cal = ladder_hints(t, widths, threshold=1e-3, probe_man_bits=5,
                             joint_metric=1e-3, margin=0)
    assert hints_cal == {"calm": 2, "wild": 5}
    for kw in ({}, dict(joint_metric=1e-3, margin=0), dict(pin_slope=0.0)):
        assert ladder_hints(t, widths, 1e-3, 5, **kw) == \
            jladder_hints(jt, widths, 1e-3, 5, **kw)


def test_ladder_hints_nonfinite_peak_pins():
    jt, t = _traj(["a x @ f:1"], ["boom"], [[np.inf]], [[np.inf]], [[1.0]],
                  [[4]], 1)
    assert ladder_hints(t, (23, 10, 2), threshold=1e-3,
                        probe_man_bits=5) == {"boom": None}
    assert jladder_hints(jt, (23, 10, 2), threshold=1e-3,
                         probe_man_bits=5) == {"boom": None}


def test_profile_trajectory_validates_and_caches():
    with pytest.raises(ValueError, match="n_steps"):
        tc.profile_trajectory(lambda x: x, tc.TruncationPolicy(rules=()),
                              n_steps=0)
    with pytest.raises(TypeError, match="mesh"):
        tc.profile_trajectory(lambda x: x, tc.TruncationPolicy(rules=()),
                              mesh=object())
    pol = tc.TruncationPolicy.everywhere("e5m2")
    with pytest.warns(DeprecationWarning, match="threshold="):
        wrapped = tc.profile_trajectory(tstaged(0, 3), pol, 1e-3, n_steps=3)
    x = torch.ones(1)
    r1 = wrapped(x)
    r2 = wrapped(x)
    assert wrapped.n_traces == 1 and wrapped.cache_size() == 1
    assert torch.equal(r1[1].max_rel, r2[1].max_rel)
    assert torch.equal(r1[1].abs_sum, r2[1].abs_sum)
    assert "onset" in r1[1].summary(1e-3)


def test_sites_select_columns_by_scope_and_primitive():
    """``sites`` patterns are substrings of location descriptions. A
    description ends in the program's ``file:line``, which differs between
    the packages, so only the scope and primitive part of a pattern carries
    across (ROADMAP Queue C)."""
    def jf(x):
        def body(c, _):
            with jc.scope("stage"):
                c = c * jnp.asarray(LOSSY, c.dtype)
            with jc.scope("other"):
                c = c + jnp.asarray(1.0, c.dtype)
            return c, None
        return jnp.sum(lax.scan(body, x, None, length=3)[0])

    def tf(x):
        for _ in range(3):
            with loop_body("step"):
                with scope("stage"):
                    x = x * LOSSY
                with scope("other"):
                    x = x + 1.0
        return x.sum()

    x = np.asarray([1.0, 2.0], np.float32)
    (_, jt), (_, tt) = both(jf, tf, x, 4, sites=["stage mul"])
    assert tt.scopes == jt.scopes == ("stage",)
    assert len(tt.column_locations()) == 1
    assert tt.locations[tt.column_locations()[0]].startswith("stage mul @ ")
    assert tuple(tt.max_rel.shape) == (4, 1)
    np.testing.assert_array_equal(host(tt.op_counts), host(jt.op_counts))
    # whole-run totals still cover every site
    assert len(tt.locations) == len(jt.locations) == 3
    # the file:line part names each package's own source
    (jfile,) = {loc.split(" @ ")[1].split(":")[0] for loc in jt.locations
                if " @ " in loc and not loc.startswith("<")} - {"?"}
    (tfile,) = {loc.split(" @ ")[1].split(":")[0] for loc in tt.locations
                if not loc.startswith("<")}
    assert jfile == tfile == "test_torch_trajectory.py"
    jlines = [loc.split(":")[-1] for loc in jt.locations]
    tlines = [loc.split(":")[-1] for loc in tt.locations]
    assert jlines != tlines


# --------------------------------------------------------------------------
# the mini-apps and the model
# --------------------------------------------------------------------------

def test_heat_blame_pinpoints_stencil_onset_under_e5m2():
    """The reference's tier-1 heat case: the explicit stencil's onset lies
    in the explicit phase and the implicit scopes' at the phase switch; the
    port gives the same onsets and blame order."""
    kw = dict(n=8, n_explicit=8, n_implicit=1, cg_iters=6)
    ja, ta = jget_app("heat", **kw), get_app("heat", **kw)
    _, jt = ja.profile_trajectory(policy=ja.uniform_policy("e5m2"),
                                  threshold=1e-3)
    _, tt = ta.profile_trajectory(ta.init_state(device="cpu"),
                                  policy=ta.uniform_policy("e5m2"),
                                  threshold=1e-3)
    assert int(host(tt.steps_seen)) == int(host(jt.steps_seen)) == ta.n_steps
    blame = {b.scope: b for b in tt.blame(1e-3)}
    st = blame["heat/stencil"]
    assert st.onset is not None and 0 <= st.onset < ta.n_explicit
    assert any(sc.startswith("heat/implicit") and b.onset == ta.n_explicit
               for sc, b in blame.items())
    assert [(b.scope, b.onset) for b in tt.blame(1e-3)] == \
        [(b.scope, b.onset) for b in jt.blame(1e-3)]
    for tb, jb in zip(tt.blame(1e-3), jt.blame(1e-3)):
        assert abs(tb.peak_rel - jb.peak_rel) <= 1e-2 * jb.peak_rel


_MODEL = {}


def small_model():
    """h2o-danube's smoke configuration (2 layers, scanned in the
    reference: ``scan_layers`` is on), weights made by the reference."""
    if not _MODEL:
        jcfg = jget_config("h2o-danube-1.8b", "smoke")
        tcfg = get_config("h2o-danube-1.8b", "smoke")
        assert jcfg.scan_layers and tcfg.scan_layers
        jm, tm = JModel(jcfg), Model(tcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             "cpu")
        toks = np.random.RandomState(0).randint(0, jcfg.vocab, (2, 33))
        jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
        tb = {"tokens": torch.from_numpy(toks[:, :-1]).to(torch.int32),
              "labels": torch.from_numpy(toks[:, 1:]).to(torch.int32)}
        _MODEL.update(jm=jm, jp=jp, jb=jb, tm=tm, tp=tp, tb=tb)
    return _MODEL


def per_step(traj, drop=()):
    """(scope, primitive) -> per-row [op_counts], [max_rel], columns on one
    source line merged, in order of first appearance."""
    ops, mx = host(traj.op_counts), host(traj.max_rel)
    out = OrderedDict()
    for c, i in enumerate(traj.column_locations()):
        key = tuple(traj.locations[i].split(" @ ")[0].rsplit(" ", 1))
        if key in drop:
            continue
        acc = out.setdefault(key, [np.zeros(len(ops), np.int64),
                                   np.zeros(len(ops))])
        acc[0] += ops[:, c]
        acc[1] = np.maximum(acc[1], mx[:, c])
    return out


@pytest.mark.parametrize("fmt", ["e8m3", "e8m7"])
def test_scanned_model_layers_are_steps(fmt):
    """A ``scan_layers`` model: one layer is one step in both packages (the
    reference scans the stack; the port's layer loop enters
    ``scope("layer", loop=True)``), the attention's chunk loops inside
    bump none, and final norm, logits and loss land in the row after."""
    s = small_model()
    n = s["tm"].cfg.n_layers
    jout, jt = jc.profile_trajectory(
        s["jm"].loss, jc.TruncationPolicy.everywhere(fmt),
        n_steps=n + 1)(s["jp"], s["jb"])
    pol = tc.TruncationPolicy.everywhere(fmt)
    tout, tt = tc.profile_trajectory(s["tm"].loss, pol, n_steps=n + 1)(
        s["tp"], s["tb"])
    assert torch.equal(tout, tc.truncate(s["tm"].loss, pol)(s["tp"], s["tb"]))
    _, rep = tc.memtrace(s["tm"].loss, pol)(s["tp"], s["tb"])
    for name in ("flags", "max_rel", "op_counts"):
        assert torch.equal(getattr(tt.totals, name), getattr(rep, name))
    assert int(host(tt.steps_seen)) == int(host(jt.steps_seen)) == n
    # the reference's one extra site (test_torch_memmode.py)
    gj = per_step(jt, drop={("layer/attn/mix", "convert_element_type")})
    gt = per_step(tt)
    assert list(gj) == list(gt)
    for k in gj:
        np.testing.assert_array_equal(gt[k][0], gj[k][0], err_msg=str(k))
        for tm_, jm_ in zip(gt[k][1], gj[k][1]):
            if math.isinf(jm_):
                assert tm_ == jm_, k
            else:
                assert abs(tm_ - jm_) <= 2e-2 * jm_ + 1e-6, (k, jm_, tm_)
    rows = host(tt.op_counts)
    layer_cols = [c for c, sc in enumerate(tt.scopes)
                  if sc.startswith("layer")]
    assert (rows[:n][:, layer_cols] > 0).all()
    assert (rows[n][layer_cols] == 0).all()
    tail = {tt.scopes[c].split("/")[0] for c in range(len(tt.scopes))
            if rows[n, c] > 0}
    assert {"final_norm", "logits"} <= tail and "layer" not in tail
