"""Mem-mode of the port against the reference's, case by case: each case of
``tests/test_memmode.py`` runs through both packages on the same numpy
inputs, plus the cases only an eager framework has (random draws, in-place
ops on views) and a small dense h2o-danube-shaped model.

The reference's ``jit`` becomes a repeated call of one wrapper (``n_traces``
stays 1); ``lax.scan`` / ``while_loop`` / ``switch`` become Python loops
under ``loop_body`` and a Python ``if``.

Tolerances. Within one package the truncated lane of ``memtrace`` is bit for
bit ``truncate``'s. Between packages, per location (compared by ``(scope,
primitive)`` in order, locations on one source line summed): ``op_counts``
equal; ``flags`` equal on the small programs and within 0.1 % of the
location's elements on the model; ``max_rel`` within 2 % relative (1e-6
absolute near 0). The f32 shadow lanes of the two frameworks differ in the
last bit in places (XLA's CPU code contracts a multiply and an add into one
fma, matrix products sum in another order: ROADMAP Queue C), which can move
an element across the threshold or a rounding boundary, and changes the
deviation of an element whose lanes are both near zero by a few per cent.
Truncated outputs: within ``2^-m`` relative of the reference's, as in
``test_torch_model.py``. None of the programs here has a dot-input rule:
under one, mem-mode rounds the dot's output (the reference's mem-mode does)
and op-mode does not, so the two lanes would not be compared.
"""
import math
from collections import OrderedDict

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
import torch

import repro.core as jc
from repro.configs.base import get_config as jget_config
from repro.core.memmode import deviation as jdeviation
from repro.models import Model as JModel

import repro_torch.core as tc
from repro_torch.configs import get_config
from repro_torch.core.memmode import NO_LOCATIONS, deviation as tdeviation
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.distributed.sharding import batch_sharding
from repro_torch.launch.mesh import make_profile_mesh

from test_torch_distributed import one_rank  # noqa: F401 (a fixture)


# --------------------------------------------------------------------------
# the reference's program and its twin
# --------------------------------------------------------------------------

def jmodel(w, x):
    with jc.scope("attn"):
        h = jnp.tanh(x @ w)
    with jc.scope("mlp"):
        h = jax.nn.relu(h @ w.T) @ w
    with jc.scope("norm"):
        h = h / (jnp.sqrt(jnp.mean(h * h, -1, keepdims=True)) + 1e-5)
    return jnp.sum(h * h)


def tmodel(w, x):
    with tc.scope("attn"):
        h = torch.tanh(x @ w)
    with tc.scope("mlp"):
        h = torch.relu(h @ w.T) @ w
    with tc.scope("norm"):
        # sum then divide: the two primitives jnp.mean is made of
        h = h / (torch.sqrt((h * h).sum(-1, keepdim=True) / h.shape[-1])
                 + 1e-5)
    return (h * h).sum()


def data():
    r = np.random.RandomState(0)
    return r.randn(8, 8).astype(np.float32), r.randn(4, 8).astype(np.float32)


def jt(*arrays):
    """The same numpy arrays for both packages."""
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(a.copy()) for a in arrays))


def stats(rep):
    return tuple(np.asarray(torch.as_tensor(np.array(x)))
                 for x in (rep.flags, rep.max_rel, rep.op_counts))


def grouped(rep, drop=()):
    """(scope, primitive) -> [flags, max_rel, op_counts], in order of first
    appearance; locations that differ only by source line are summed."""
    out = OrderedDict()
    for loc, f, m, o in zip(rep.locations, *stats(rep)):
        key = tuple(loc.split(" @ ")[0].rsplit(" ", 1))
        if key in drop:
            continue
        acc = out.setdefault(key, [0, 0.0, 0])
        acc[0] += int(f)
        acc[1] = max(acc[1], float(m))
        acc[2] += int(o)
    return out


def assert_same_table(jrep, trep, flag_frac=0.0, drop=()):
    gj, gt = grouped(jrep, drop), grouped(trep)
    assert list(gj) == list(gt)
    for k in gj:
        (jf, jm, jo), (tf, tm, to) = gj[k], gt[k]
        assert to == jo, (k, jo, to)
        assert abs(tf - jf) <= flag_frac * jo, (k, jf, tf)
        if math.isinf(jm):
            assert tm == jm, (k, jm, tm)
        else:
            assert abs(tm - jm) <= 2e-2 * jm + 1e-6, (k, jm, tm)


def assert_close_out(t, j, m):
    t, j = float(t), float(j)
    assert np.isfinite(t)
    assert abs(t - j) <= 2.0 ** -m * abs(j), (t, j)


def bits(t):
    return t.detach().reshape(-1).view(torch.int32).tolist()


# --------------------------------------------------------------------------
# tests/test_memmode.py, through both packages
# --------------------------------------------------------------------------

def test_outputs_match_opmode():
    """mem-mode low lane == op-mode output (same truncation points)."""
    (jw, jx), (tw, tx) = jt(*data())
    jout_op = jc.truncate(jmodel, jc.TruncationPolicy.everywhere(jc.E5M2))(jw, jx)
    jout, jrep = jc.memtrace(jmodel, jc.TruncationPolicy.everywhere(jc.E5M2),
                             threshold=1e-3)(jw, jx)
    assert float(jout_op) == float(jout)
    pol = tc.TruncationPolicy.everywhere(tc.E5M2)
    tout_op = tc.truncate(tmodel, pol)(tw, tx)
    tout, trep = tc.memtrace(tmodel, pol, threshold=1e-3)(tw, tx)
    assert bits(tout_op) == bits(tout)
    assert_close_out(tout, jout, 2)
    assert_same_table(jrep, trep)


def test_shadow_is_full_precision():
    """With an identity policy nothing is flagged."""
    (jw, jx), (tw, tx) = jt(*data())
    jout, jrep = jc.memtrace(jmodel, jc.TruncationPolicy.everywhere("fp32"),
                             threshold=1e-6)(jw, jx)
    assert float(jout) == float(jmodel(jw, jx))
    assert int(jnp.sum(jrep.flags)) == 0
    tout, trep = tc.memtrace(tmodel, tc.TruncationPolicy.everywhere("fp32"),
                             threshold=1e-6)(tw, tx)
    assert bits(tout) == bits(tmodel(tw, tx))
    assert int(trep.flags.sum()) == 0
    assert float(trep.max_rel.max()) == 0.0
    assert_same_table(jrep, trep)


def test_flags_grow_with_coarser_format():
    (jw, jx), (tw, tx) = jt(*data())
    totals = {}
    for fmt in ("fp16", "e5m2"):
        _, jrep = jc.memtrace(jmodel, jc.TruncationPolicy.everywhere(fmt),
                              threshold=1e-3)(jw, jx)
        _, trep = tc.memtrace(tmodel, tc.TruncationPolicy.everywhere(fmt),
                              threshold=1e-3)(tw, tx)
        assert_same_table(jrep, trep)
        totals[fmt] = (int(jnp.sum(jrep.flags)), int(trep.flags.sum()))
    assert totals["e5m2"][1] > totals["fp16"][1]
    assert totals["e5m2"][0] > totals["fp16"][0]


def test_heatmap_locates_scopes():
    (jw, jx), (tw, tx) = jt(*data())
    _, jrep = jc.memtrace(jmodel, jc.TruncationPolicy.everywhere(jc.E5M2),
                          threshold=1e-2)(jw, jx)
    _, trep = tc.memtrace(tmodel, tc.TruncationPolicy.everywhere(tc.E5M2),
                          threshold=1e-2)(tw, tx)
    for rep in (jrep, trep):
        locs = [loc for loc, n, _ in rep.top(100) if n > 0]
        assert any("attn" in l for l in locs)
        assert any("mlp" in l for l in locs)
    # the port names the program's own source line, as the reference does
    assert all(" @ test_torch_memmode.py:" in l for l in trep.locations)
    assert [(l.split(" @ ")[0], f) for l, f, _ in trep.top(3)] == \
        [(l.split(" @ ")[0], f) for l, f, _ in jrep.top(3)]
    assert_same_table(jrep, trep)


def test_exclusion_workflow_table2():
    """Paper §6.3: exclude the worst-flagged module, re-run, error drops."""
    (jw, jx), (tw, tx) = jt(*data())
    for pkg, model, w, x in ((jc, jmodel, jw, jx), (tc, tmodel, tw, tx)):
        pol = pkg.TruncationPolicy.everywhere(pkg.E5M2)
        ref = float(model(w, x))
        out0, rep0 = pkg.memtrace(model, pol, threshold=1e-2)(w, x)
        worst = rep0.top(1)[0][0].split(" ")[0].split("/")[0]
        assert worst == "mlp"
        out1, rep1 = pkg.memtrace(model, pol.excluding(worst),
                                  threshold=1e-2)(w, x)
        err0 = abs(float(out0) - ref)
        err1 = abs(float(out1) - ref)
        # excluding the most-flagged scope must not make things worse
        assert err1 <= err0 * 1.5
        assert int(np.sum(stats(rep1)[0])) <= int(np.sum(stats(rep0)[0]))


def test_memmode_through_scan():
    def jf(x):
        def body(c, _):
            return jnp.sin(c * 1.01), c
        y, ys = lax.scan(body, x, None, length=4)
        return jnp.sum(y) + jnp.sum(ys)

    def tf(x):
        c, ys = x, []
        for _ in range(4):
            with tc.loop_body("scan"):
                ys.append(c)
                c = torch.sin(c * 1.01)
        return c.sum() + torch.stack(ys).sum()

    (jx,), (tx,) = jt(np.random.RandomState(2).randn(8).astype(np.float32))
    jout, jrep = jc.memtrace(jf, jc.TruncationPolicy.everywhere(jc.E5M2),
                             threshold=1e-3)(jx)
    tout, trep = tc.memtrace(tf, tc.TruncationPolicy.everywhere(tc.E5M2),
                             threshold=1e-3)(tx)
    assert np.isfinite(float(tout))
    assert int(trep.op_counts.sum()) > 0
    # op counts accumulate across the 4 iterations
    assert int(trep.op_counts.max()) >= 4 * 8
    assert_close_out(tout, jout, 2)
    assert_same_table(jrep, trep)


def test_memmode_repeated_call_reuses_its_trace():
    """The reference's ``jax.jit(memtrace(...))``: one walk per input
    signature, the same results every call."""
    (jw, jx), (tw, tx) = jt(*data())
    jfn = jax.jit(jc.memtrace(jmodel, jc.TruncationPolicy.everywhere(jc.E5M2),
                              threshold=1e-3))
    jout, jrep = jfn(jw, jx)
    fn = tc.memtrace(tmodel, tc.TruncationPolicy.everywhere(tc.E5M2),
                     threshold=1e-3)
    out1, rep1 = fn(tw, tx)
    out2, rep2 = fn(tw, tx)
    assert fn.n_traces == 1 and fn.cache_size() == 1
    assert bits(out1) == bits(out2)
    assert rep1.locations == rep2.locations
    for a, b in zip(stats(rep1), stats(rep2)):
        np.testing.assert_array_equal(a, b)
    assert_same_table(jrep, rep2)
    # another signature walks again
    fn(tw, tx[:2])
    assert fn.n_traces == 2 and fn.cache_size() == 2


# hybrid deviation metric: zero/denormal shadow values must not poison the
# per-location max with inf/nan
DEV_VALUES = [0.0, -0.0, 1e-45, 1e-40, -1e-40, 1e-7, 1e-6, 2e-6, 1e-3, 0.5,
              1.0, 1.001, 2.0, -2.0, 3e9, 3.4e38, np.inf, -np.inf, np.nan]


def test_deviation_zero_and_denormal_shadow():
    lo, sh = np.meshgrid(np.array(DEV_VALUES, np.float32),
                         np.array(DEV_VALUES, np.float32))
    want = np.asarray(jdeviation(jnp.asarray(lo), jnp.asarray(sh)))
    got = tdeviation(torch.from_numpy(lo), torch.from_numpy(sh)).numpy()
    # bit for bit: the same IEEE operations in the same order; but XLA's
    # CPU arithmetic flushes subnormal operands to zero and PyTorch's does
    # not (neither does the card's), so a subnormal lane deviates by ~1e-34
    # here and by 0 there, far below any threshold (ROADMAP Queue C)
    tiny = np.finfo(np.float32).tiny
    sub = ((np.abs(lo) < tiny) & (lo != 0)) | ((np.abs(sh) < tiny) & (sh != 0))
    np.testing.assert_array_equal(got[~sub].view(np.int32),
                                  want[~sub].view(np.int32))
    np.testing.assert_allclose(got[sub], want[sub], rtol=0, atol=1e-30)

    def dev(lo, sh):
        return float(tdeviation(torch.tensor(lo, dtype=torch.float32),
                                torch.tensor(sh, dtype=torch.float32)))

    assert 0.0 < dev(1e-3, 0.0) <= 2.0
    assert 0.0 < dev(2.0, 0.0) <= 2.0
    assert dev(1e-40, 0.0) < 1e-3
    assert dev(0.0, 1e-40) < 1e-3
    assert dev(0.0, 0.0) == 0.0
    assert dev(np.inf, np.inf) == 0.0
    assert dev(np.inf, 3e9) == float("inf")
    assert dev(np.nan, 1.0) == float("inf")
    assert dev(1.0, 1.001) == pytest.approx(1e-3, rel=1e-2)


@pytest.mark.parametrize("threshold", [1e-3, 0.0, -1.0])
def test_nan_lanes_of_an_unrounded_site(threshold):
    """A site whose format is the identity leaves one tensor in both lanes:
    its deviation is 0 but on NaN lanes, where it is inf (the reference's
    ``deviation(x, x)``), whatever the threshold."""
    def jf(x):
        with jc.scope("s"):
            return jnp.log(x)

    def tf(x):
        with tc.scope("s"):
            return torch.log(x)

    (jx,), (tx,) = jt(np.array([-1.0, 1.0, 2.0, -3.0, 0.5], np.float32))
    _, jrep = jc.memtrace(jf, jc.TruncationPolicy.everywhere("fp32"),
                          threshold=threshold)(jx)
    _, trep = tc.memtrace(tf, tc.TruncationPolicy.everywhere("fp32"),
                          threshold=threshold)(tx)
    assert int(trep.flags[0]) == (2 if threshold >= 0 else 5)
    assert float(trep.max_rel[0]) == math.inf
    assert_same_table(jrep, trep)


def test_zero_crossing_input_does_not_poison_max_rel():
    """Two op orders give the same exact shadow but different truncated
    values, so the subtraction sees shadow == 0 with a nonzero low lane."""
    def jf(x):
        with jc.scope("zc"):
            u = (x * jnp.asarray(1.1, x.dtype)) * jnp.asarray(5.0, x.dtype)
            v = (x * jnp.asarray(5.0, x.dtype)) * jnp.asarray(1.1, x.dtype)
            d = u - v
        return jnp.sum(d)

    def tf(x):
        with tc.scope("zc"):
            u = (x * 1.1) * 5.0
            v = (x * 5.0) * 1.1
            d = u - v          # shadow: exactly 0; low: quantized u != v
        return d.sum()

    (jx,), (tx,) = jt(np.array([2.0, 4.0], np.float32))
    _, jrep = jc.memtrace(jf, jc.TruncationPolicy.everywhere(jc.E5M2),
                          threshold=1e-3)(jx)
    _, trep = tc.memtrace(tf, tc.TruncationPolicy.everywhere(tc.E5M2),
                          threshold=1e-3)(tx)
    mr = trep.max_rel.numpy()
    assert int(trep.flags.sum()) > 0
    assert np.all(np.isfinite(mr)), mr
    assert np.all(mr <= 2.0), mr
    assert_same_table(jrep, trep)


def test_while_loop_error_appearing_after_iteration_k():
    """Per-site stats reflect every trip of the loop: an error that only
    appears from iteration k>1 is flagged, and op counts cover every trip."""
    k, n = 2, 5

    def jf(x):
        def cond(c):
            return c[0] < n

        def body(c):
            i, v = c
            with jc.scope("w"):
                fac = jnp.where(i < k, jnp.asarray(2.0, v.dtype),
                                jnp.asarray(1.09, v.dtype))
                v = v * fac
            return (i + 1, v)

        return jnp.sum(lax.while_loop(cond, body, (jnp.int32(0), x))[1])

    def tf(x):
        i, v = 0, x
        while i < n:
            with tc.loop_body("while"), tc.scope("w"):
                # x2.0 is exact in e5m2; x1.09 rounds
                v = v * (2.0 if i < k else 1.09)
            i += 1
        return v.sum()

    (jx,), (tx,) = jt(np.array([1.0, 2.0], np.float32))
    _, jrep = jc.memtrace(jf, jc.TruncationPolicy.everywhere(jc.E5M2),
                          threshold=1e-3)(jx)
    _, trep = tc.memtrace(tf, tc.TruncationPolicy.everywhere(tc.E5M2),
                          threshold=1e-3)(tx)
    (i,) = [j for j, l in enumerate(trep.locations) if l.startswith("w ")]
    assert int(trep.op_counts[i]) == 2 * n
    assert int(trep.flags[i]) == 2 * (n - k)
    assert_same_table(jrep, trep)


def test_cond_branch_stats_accumulate_across_scan_iterations():
    """Errors from both branches accumulate, whichever iteration takes
    them."""
    def jf(x):
        def body(c, t):
            def exact(v):
                with jc.scope("b_exact"):
                    return v * jnp.asarray(2.0, v.dtype)

            def lossy(v):
                with jc.scope("b_lossy"):
                    return v * jnp.asarray(1.09, v.dtype)

            return lax.switch(t % 2, [exact, lossy], c), None

        y, _ = lax.scan(body, x, jnp.arange(4, dtype=jnp.int32))
        return jnp.sum(y)

    def tf(x):
        c = x
        for t in range(4):
            with tc.loop_body("scan"):
                if t % 2 == 0:
                    with tc.scope("b_exact"):
                        c = c * 2.0
                else:
                    with tc.scope("b_lossy"):
                        c = c * 1.09
        return c.sum()

    (jx,), (tx,) = jt(np.array([1.0, 2.0], np.float32))
    _, jrep = jc.memtrace(jf, jc.TruncationPolicy.everywhere(jc.E5M2),
                          threshold=1e-3)(jx)
    _, trep = tc.memtrace(tf, tc.TruncationPolicy.everywhere(tc.E5M2),
                          threshold=1e-3)(tx)
    by = {l.split(" ")[0]: i for i, l in enumerate(trep.locations)}
    ops, flags = trep.op_counts.tolist(), trep.flags.tolist()
    assert ops[by["b_exact"]] == 4 and ops[by["b_lossy"]] == 4
    # the lossy branch deviates on both its trips; the exact branch is
    # clean on t=0 but inherits the drifted carry on t=2
    assert flags[by["b_lossy"]] == 4
    assert flags[by["b_exact"]] == 2
    assert_same_table(jrep, trep)


# --------------------------------------------------------------------------
# what only an eager framework has
# --------------------------------------------------------------------------

def _seeded_program(draw):
    """h gets a separate shadow with the same values (a rule whose mask is
    never true), so the random draw on it runs on both lanes; the site in
    ``c`` measures how far the two draws are apart."""
    def prog(x):
        with tc.scope("a"):
            h = x * 1.0
        noise = draw(h)
        with tc.scope("c"):
            return noise * 1.0
    policy = tc.TruncationPolicy((
        tc.TruncationRule(fmt=tc.E5M2, scope="a",
                          mask=tc.magnitude_above(math.inf)),
        tc.TruncationRule(fmt=tc.FP32, scope="c")))
    return prog, policy


@pytest.mark.parametrize("draw", [
    torch.rand_like,
    lambda h: torch.bernoulli(torch.sigmoid(h)),
    lambda h: torch.nn.functional.dropout(h, 0.5, training=True),
], ids=["rand_like", "bernoulli", "dropout"])
def test_random_draws_are_the_same_in_both_lanes(draw):
    prog, policy = _seeded_program(draw)
    x = torch.from_numpy(np.random.RandomState(4).randn(64).astype(np.float32))
    torch.manual_seed(7)
    plain = prog(x)
    after_plain = torch.rand(4)
    torch.manual_seed(7)
    out, rep = tc.memtrace(prog, policy)(x)
    after_mem = torch.rand(4)
    # the low lane drew what the plain program draws, and left the
    # generator where the plain program leaves it
    assert bits(out) == bits(plain)
    assert torch.equal(after_mem, after_plain)
    # the shadow lane drew the same numbers
    by = {l.split(" ")[0]: i for i, l in enumerate(rep.locations)}
    assert int(rep.op_counts[by["c"]]) == 64
    assert int(rep.flags[by["c"]]) == 0
    assert float(rep.max_rel[by["c"]]) == 0.0


@pytest.mark.parametrize("case", ["view_before_shadow", "own_shadow"])
def test_in_place_ops_against_their_functional_twin(case):
    """An in-place op is applied once to each lane, a view taken before its
    base had a shadow reads the base's shadow, and an input is never
    written; the functional JAX program is the reference."""
    r = np.random.RandomState(5)
    x, y = r.randn(4, 6).astype(np.float32), r.randn(2, 6).astype(np.float32)
    (jx, jy), (tx, ty) = jt(x, y)
    x0 = tx.clone()

    if case == "view_before_shadow":
        def jf(x, y):
            with jc.scope("a"):
                h = y * 1.5
            buf = x.at[1:3].add(h)
            with jc.scope("c"):
                ws = buf[0:2] * 1.0
                bs = buf * 1.0
            return jnp.sum(bs) + jnp.sum(ws)

        def tf(x, y):
            with tc.scope("a"):
                h = y * 1.5
            buf = x.clone()
            w = buf[0:2]            # taken before buf has a shadow
            buf[1:3].add_(h)        # h has one: buf gets one here
            with tc.scope("c"):
                ws = w * 1.0
                bs = buf * 1.0
            return bs.sum() + ws.sum()
    else:
        def jf(x, y):
            with jc.scope("a"):
                buf = x[0:2] * y
            with jc.scope("c"):
                bs = buf * 1.0
            return jnp.sum(bs)

        def tf(x, y):
            buf = x[0:2].clone()
            with tc.scope("a"):
                buf.mul_(y)         # one lane, rounded in place
            with tc.scope("c"):
                bs = buf * 1.0
            return bs.sum()

    def policy(pkg):
        return pkg.TruncationPolicy((
            pkg.TruncationRule(fmt=pkg.E5M2, scope="a"),
            pkg.TruncationRule(fmt=pkg.FP32, scope="c")))

    jout, jrep = jc.memtrace(jf, policy(jc))(jx, jy)
    tout, trep = tc.memtrace(tf, policy(tc))(tx, ty)
    assert bits(tout) == bits(tc.truncate(tf, policy(tc))(tx, ty))
    assert torch.equal(tx, x0)
    assert_close_out(tout, jout, 2)
    assert_same_table(jrep, trep)
    # the lanes did come apart where the reference says they do
    assert int(trep.flags.sum()) > 0


# --------------------------------------------------------------------------
# a small dense h2o-danube-shaped model
# --------------------------------------------------------------------------

_MODEL = {}


def small_model():
    """h2o-danube's smoke configuration (2 layers, d_model 64, 4/1 heads of
    16, window 16 < S = 32), float32, weights made by the reference and
    carried over."""
    if not _MODEL:
        jcfg = jget_config("h2o-danube-1.8b", "smoke")
        tcfg = get_config("h2o-danube-1.8b", "smoke")
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


@pytest.mark.parametrize("fmt,m", [("e8m3", 3), ("e8m7", 7), ("e8m10", 10)])
def test_small_model_location_by_location(fmt, m):
    s = small_model()
    jout, jrep = jc.memtrace(s["jm"].loss,
                             jc.TruncationPolicy.everywhere(fmt))(s["jp"],
                                                                 s["jb"])
    pol = tc.TruncationPolicy.everywhere(fmt)
    tout, trep = tc.memtrace(s["tm"].loss, pol)(s["tp"], s["tb"])
    assert bits(tout) == bits(tc.truncate(s["tm"].loss, pol)(s["tp"], s["tb"]))
    assert_close_out(tout, jout, m)
    assert trep.flags.dtype == trep.op_counts.dtype == torch.int64
    assert trep.max_rel.dtype == torch.float32
    # the reference's one extra site: the attention mask's NEG_INF constant
    # traced as a float convert_element_type (test_torch_model.py)
    assert_same_table(jrep, trep, flag_frac=1e-3,
                      drop={("layer/attn/mix", "convert_element_type")})


def test_no_rules_gives_the_plain_program_and_the_sentinel():
    s = small_model()
    out, rep = tc.memtrace(s["tm"].loss, tc.TruncationPolicy(()))(s["tp"],
                                                                  s["tb"])
    assert bits(out) == bits(s["tm"].loss(s["tp"], s["tb"]))
    assert rep.locations == (NO_LOCATIONS,)
    assert rep.flags.tolist() == [0] and rep.op_counts.tolist() == [0]


def test_surface_deprecations_and_what_is_not_ported(one_rank):
    """The positional threshold warns. ``mesh`` / ``allreduce`` are ported:
    anything but a mesh is refused, ``allreduce`` needs one (``mesh=`` or
    ``use_mesh``), and on a mesh of one rank both give the single-process
    report bit for bit (several ranks: ``test_torch_spmd.py``)."""
    (_, _), (tw, tx) = jt(*data())
    pol = tc.TruncationPolicy.everywhere(tc.E5M2)
    with pytest.warns(DeprecationWarning, match="threshold="):
        out_a, rep_a = tc.memtrace(tmodel, pol, 1e-2)(tw, tx)
    out_b, rep_b = tc.memtrace(tmodel, pol, threshold=1e-2)(tw, tx)
    assert torch.equal(rep_a.flags, rep_b.flags)
    with pytest.raises(TypeError, match="mesh"):
        tc.memtrace(tmodel, pol, mesh=object())
    with pytest.raises(ValueError, match="DeviceMesh"):
        rep_b.allreduce("data")
    mesh = make_profile_mesh(1, 1, device="cpu")
    out_c, rep_c = tc.memtrace(tmodel, pol, threshold=1e-2, mesh=mesh,
                               in_shardings=[None, batch_sharding(mesh)])(
        tw, tx)
    assert torch.equal(out_c, out_b)
    for got in (rep_c, rep_b.allreduce("data", mesh)):
        assert got.locations == rep_b.locations
        for k in ("flags", "max_rel", "op_counts"):
            assert torch.equal(getattr(got, k), getattr(rep_b, k)), k


# --------------------------------------------------------------------------
# the fused-epilogue kernels under mem-mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["flash", "wkv6"])
def test_fused_kernel_runs_on_both_lanes_and_is_not_routed(name,
                                                           monkeypatch):
    """As in the reference, mem-mode routes no row into a fused kernel's
    epilogue: the kernel runs on each lane and its output takes the separate
    quantize pass, so the truncated lane equals ``truncate`` of the same
    program with no row wired (which cannot route) and, the epilogue being
    bit for bit that pass, ``truncate`` with the row routed."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.quantize_em.ops import IDENTITY_ROW
    from repro_torch.kernels.rwkv6 import ops as wops

    runs = []
    if name == "flash":
        plain = fops._plain
        monkeypatch.setattr(fops, "_plain",
                            lambda *a: runs.append(1) or plain(*a))

        def op(xs, row):
            return fops.flash_attention(*xs, causal=True, impl="interpret",
                                        out_fmt=row)
        r = np.random.RandomState(6)
        xs = [r.randn(1, 2, 64, 16).astype(np.float32) for _ in range(3)]
    else:
        ref = wops.wkv6_ref
        monkeypatch.setattr(wops, "wkv6_ref",
                            lambda *a: runs.append(1) or ref(*a))

        def op(xs, row):
            return wops.wkv6(*xs, chunk=32, impl="interpret", out_fmt=row)
        r = np.random.RandomState(6)
        xs = [r.randn(1, 2, 64, 16).astype(np.float32) for _ in range(3)]
        xs += [(1 / (1 + np.exp(-r.randn(1, 2, 64, 16)))).astype(np.float32),
               (r.randn(2, 16) * 0.1).astype(np.float32),
               np.zeros((1, 2, 16, 16), np.float32)]

    def prog(row, *xs):
        with tc.scope("pre"):
            xs = [x * 1.0 for x in xs[:3]] + list(xs[3:])
        with tc.scope("fused"):
            return op(xs, row)

    xs = [torch.from_numpy(x) for x in xs]
    pol = tc.TruncationPolicy.everywhere(tc.E5M2)
    low, rep = tc.memtrace(prog, pol)(IDENTITY_ROW, *xs)
    assert len(runs) == 2                     # one call, both lanes
    unrouted = tc.truncate(prog, pol)(None, *xs)
    routed = tc.truncate(prog, pol)(IDENTITY_ROW, *xs)
    low, unrouted, routed = (o if isinstance(o, tuple) else (o,)
                             for o in (low, unrouted, routed))
    for a, b, c in zip(low, unrouted, routed):
        assert bits(a) == bits(b) == bits(c)
    fused = [i for i, l in enumerate(rep.locations)
             if l.startswith("fused pallas_call @ ")]
    # every output of the op is a site (flash: o; wkv6: y and sT, one line)
    assert len(fused) == 1
    assert int(rep.op_counts[fused[0]]) == sum(o.numel() for o in low)
    assert int(rep.flags[fused[0]]) > 0
