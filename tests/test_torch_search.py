"""The port's precision search (``repro_torch.search``) against the
reference's, on the same numpy inputs: the scope frontier, the metrics, and
``autosearch`` end to end (JAX on the CPU).

Tolerances. Frontier: the same paths in the same order, FLOPs equal and
fractions within 1e-6. Metrics: bit-equal on the same numpy pytrees (both
are numpy arithmetic). Searches: assignments, ``evals_used``,
``n_dispatches``, ``converged``, the event tags of the history and the
dispatch statistics exactly; every metric value within ``1e-2`` relative or
``1e-2 * threshold`` absolute. The two packages' plain runs differ in the
last bits (XLA's CPU code contracts ``a*b+c`` to an fma and sums in another
order, ROADMAP Queue C), so a metric near the f32 noise floor differs
relatively but not on the scale the threshold decides on; every test
asserts that no reference value lies that close to its threshold, so the
decisions cannot hinge on those bits.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
import torch

from repro import search as js
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import scope as jscope
from repro.core import truncate as jtruncate
from repro.core.formats import FPFormat as JFPFormat
from repro.core.policy import TruncationPolicy as JPolicy
from repro.core.policy import TruncationRule as JRule
from repro.models import Model as JModel

from repro_torch import search as ts
from repro_torch.configs import ArchConfig
from repro_torch.core import (
    FPFormat, TruncationPolicy, TruncationRule, loop_body, scope, truncate,
    truncate_sweep,
)
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.launch.mesh import make_probe_mesh

from test_torch_distributed import one_rank  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-2


def jtoy(w1, w2, x):
    with jscope("attn"):
        h = jnp.tanh(x @ w1)
    with jscope("mlp"):
        h = jax.nn.relu(h @ w2) @ w2.T
    with jscope("head"):
        return jnp.mean(h * h)


def ttoy(w1, w2, x):
    """``jtoy`` from the same primitives (the mean as sum and divide, as
    ``jnp.mean`` traces)."""
    with scope("attn"):
        h = torch.tanh(x @ w1)
    with scope("mlp"):
        h = torch.relu(h @ w2) @ w2.T
    with scope("head"):
        return (h * h).sum() / h.numel()


def toy_args(seed=0):
    r = np.random.RandomState(seed)
    a = ((r.randn(32, 64) / 8).astype(np.float32),
         (r.randn(64, 64) / 8).astype(np.float32),
         r.randn(16, 32).astype(np.float32))
    return (tuple(jnp.asarray(x) for x in a),
            tuple(torch.from_numpy(x) for x in a))


BENCH = dict(name="bench", family="dense", n_layers=4, d_model=128, n_heads=8,
             n_kv_heads=4, d_ff=512, vocab=512, dtype="float32", remat=False,
             scan_layers=False)
_BENCH = {}


def bench(scan_layers):
    """tests/test_torch_model.py's bench model in both packages, the same
    weights and tokens."""
    if scan_layers not in _BENCH:
        over = {**BENCH, "scan_layers": scan_layers}
        jm, tm = JModel(JArchConfig(**over)), Model(ArchConfig(**over))
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm.cfg,
                             "cpu")
        toks = np.random.RandomState(0).randint(0, BENCH["vocab"], (2, 33))
        jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
        tb = {"tokens": torch.from_numpy(toks[:, :-1]).to(torch.int32),
              "labels": torch.from_numpy(toks[:, 1:]).to(torch.int32)}
        _BENCH[scan_layers] = (jm, (jp, jb), tm, (tp, tb))
    return _BENCH[scan_layers]


def assigns(res):
    return {p: (a.man_bits, a.excluded) for p, a in res.assignments.items()}


def close(want, got, threshold):
    if not np.isfinite(want):
        return want == got
    return abs(got - want) <= max(RTOL * abs(want), RTOL * threshold)


def assert_same_search(rj, rt):
    """The port's SearchResult against the reference's on the same inputs."""
    thr = rj.threshold
    for _, v in rj.history:           # no decision hinges on the last bits
        assert not np.isfinite(v) or abs(v - thr) > RTOL * max(thr, abs(v)), \
            (v, thr)
    assert assigns(rt) == assigns(rj), (rj.table(), rt.table())
    for key in ("evals_used", "n_dispatches", "converged", "probe_batch",
                "max_dispatch_rows", "n_compiles", "n_warm_hints", "budget",
                "exp_bits", "n_devices"):
        assert getattr(rt, key) == getattr(rj, key), key
    assert [t for t, _ in rt.history] == [t for t, _ in rj.history]
    for (tag, vj), (_, vt) in zip(rj.history, rt.history):
        assert close(vj, vt, thr), (tag, vj, vt)
    assert close(rj.final_error, rt.final_error, thr)
    for p, a in rj.assignments.items():
        assert close(a.error_at_accept, rt.assignments[p].error_at_accept,
                     thr)
    assert rt.n_traces == (1 if rt.n_dispatches else 0)
    assert rt.n_compiles == (1 if rt.n_dispatches else 0)


# --------------------------------------------------------------------------
# scope discovery
# --------------------------------------------------------------------------

def assert_same_frontier(jscopes, tscopes, n_eqns=True):
    assert [s.path for s in tscopes] == [s.path for s in jscopes]
    for a, b in zip(jscopes, tscopes):
        assert b.flops == a.flops, a.path
        assert abs(b.fraction - a.fraction) <= 1e-6, a.path
        if n_eqns:
            assert b.n_eqns == a.n_eqns, a.path


@pytest.mark.parametrize("min_fraction", [0.01, 1e-4, 0.5])
def test_toy_frontier_matches_the_reference(min_fraction):
    ja, ta = toy_args()
    jscopes = js.discover_scopes(jax.make_jaxpr(jtoy)(*ja),
                                 min_fraction=min_fraction)
    tscopes = ts.discover_scopes(ttoy, ta, min_fraction=min_fraction)
    assert_same_frontier(jscopes, tscopes)
    assert ("head" in [s.path for s in tscopes]) == (min_fraction < 0.01)
    assert ts.discover_scopes(ttoy, ta, max_scopes=1) == tscopes[:1]
    # the tree holds every prefix and the total
    tree = ts.scope_tree(ttoy, ta)
    assert tree == pytest.approx(js.scope_tree(jax.make_jaxpr(jtoy)(*ja)))


@pytest.mark.parametrize("scan_layers", [False, True])
def test_bench_model_frontier_matches_the_reference(scan_layers):
    jm, jargs, tm, targs = bench(scan_layers)
    jscopes = js.discover_scopes(jax.make_jaxpr(jm.loss)(*jargs))
    tscopes = ts.discover_scopes(tm.loss, targs)
    # a scanned layer body is one set of equations there and runs four
    # times here: n_eqns counts aten calls as they ran
    assert_same_frontier(jscopes, tscopes, n_eqns=not scan_layers)
    if scan_layers:
        for a, b in zip(jscopes, tscopes):
            want = a.n_eqns * (4 if a.path.startswith("layer/") else 1)
            assert b.n_eqns == want, a.path


@pytest.mark.parametrize("trips", [(5,), (3, 2)])
def test_loop_trips_multiply_flops(trips):
    """A Python loop under ``loop_body`` is counted trip by trip: its FLOPs
    are those of ``lax.scan`` with the same length (nested loops
    multiply)."""
    def jf(x):
        def nest(c, depth):
            if depth == len(trips):
                return c @ c
            body = lambda c, _: (nest(c, depth + 1), None)  # noqa: E731
            return lax.scan(body, c, None, length=trips[depth])[0]
        with jscope("loop"):
            return nest(x, 0)

    def tf(x):
        def nest(c, depth):
            if depth == len(trips):
                return c @ c
            for _ in range(trips[depth]):
                with loop_body(f"d{depth}"):
                    c = nest(c, depth + 1)
            return c
        with scope("loop"):
            return nest(x, 0)

    x = np.eye(8, dtype=np.float32) * 0.5
    (jsi,) = js.discover_scopes(jax.make_jaxpr(jf)(jnp.asarray(x)))
    (tsi,) = ts.discover_scopes(tf, (torch.from_numpy(x),))
    assert jsi.flops == tsi.flops == pytest.approx(
        int(np.prod(trips)) * 2 * 8 ** 3)
    assert tsi.n_eqns == int(np.prod(trips)) and jsi.n_eqns == 1


def test_integer_work_stays_out_of_the_frontier():
    def tf(x, idx):
        with scope("index"):
            j = (idx * 3 + 1) % 7
        with scope("math"):
            return (x * 2.0).sum() + x[j].sum()
    x = torch.arange(8, dtype=torch.float32)
    idx = torch.arange(64)
    tree = ts.scope_tree(tf, (x, idx))
    assert "index" not in tree and tree["math"] == tree[""] > 0


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

def metric_cases():
    r = np.random.RandomState(1)
    f = r.randn(3, 5).astype(np.float32)
    g = (f + r.randn(3, 5).astype(np.float32) * 1e-3).astype(np.float32)
    s = np.float32(2.5)
    bad = f.copy()
    bad[1, 2] = np.nan
    inf_ref = f.copy()
    inf_ref[0, 0] = np.inf
    return {
        "scalar": (s, np.float32(2.4)),
        "field": (f, g),
        "tuple": ((s, f), (np.float32(2.6), g)),
        "dict": ({"b": f, "a": s}, {"b": g, "a": np.float32(2.0)}),
        "nested": ({"x": (f, [s])}, {"x": (g, [np.float32(3.0)])}),
        "nan_candidate": ((s, f), (s, bad)),
        "inf_reference": (inf_ref, inf_ref),
        "zeros": (np.zeros(4, np.float32), np.zeros(4, np.float32)),
        "empty": (np.zeros((0,), np.float32), np.zeros((0,), np.float32)),
    }


@pytest.mark.parametrize("case", sorted(metric_cases()))
@pytest.mark.parametrize("name", sorted(ts.NAMED_METRICS))
def test_named_metrics_on_the_same_numpy_pytrees(name, case):
    ref, cand = metric_cases()[case]
    jm, tm = js.NAMED_METRICS[name], ts.NAMED_METRICS[name]
    if case == "empty" and name == "loss":
        with pytest.raises(IndexError):
            js.NAMED_METRICS[name](ref, cand)
        with pytest.raises(IndexError):
            tm(ref, cand)
        return
    want = jm(ref, cand)
    assert tm(ref, cand) == want or (np.isnan(want) and np.isnan(
        tm(ref, cand)))
    # tensors, on the host, give the same value as their numpy arrays
    as_t = ts.metrics.tree_map(lambda a: torch.from_numpy(np.asarray(a)),
                               (ref, cand))
    got = tm(*as_t)
    assert got == want or (np.isnan(want) and np.isnan(got))


def test_metric_resolution_and_observables():
    assert ts.resolve_metric(None) is ts.rel_error
    assert ts.default_metric is ts.rel_error
    assert ts.resolve_metric("max_rel") is ts.rel_error
    assert ts.resolve_metric("rel_l2") is ts.rel_l2_error
    assert sorted(ts.NAMED_METRICS) == sorted(js.NAMED_METRICS)
    fn = lambda r, c: 0.123  # noqa: E731
    assert ts.resolve_metric(fn) is fn
    with pytest.raises(ValueError):
        ts.resolve_metric("nope")
    with pytest.raises(TypeError):
        ts.resolve_metric(42)
    a = np.asarray([1.0, 2.0], np.float32)
    jl = js.from_observables(lambda out: {"m": np.sum(out)}, "rel")
    tl = ts.from_observables(lambda out: {"m": np.sum(out)}, "rel")
    assert tl(a, a) == jl(a, a) == 0.0
    assert tl(a, a * 2) == jl(a, a * 2) == pytest.approx(1.0)
    assert ts.rel_error(torch.tensor(1.0), torch.tensor(float("nan"))) \
        == float("inf")
    assert ts.loss_degradation((torch.tensor(2.0),),
                               (torch.tensor(float("inf")),)) == float("inf")
    assert ts.rel_error(torch.tensor(2.0, dtype=torch.bfloat16),
                        torch.tensor(2.0, dtype=torch.bfloat16)) == 0.0


def test_leaves_follow_the_reference_order():
    tree = {"b": (1, [2, 3]), "a": {"z": 4, "y": None, "x": 5}}
    assert ts.metrics.tree_leaves(tree) == jax.tree_util.tree_leaves(tree)


# --------------------------------------------------------------------------
# autosearch
# --------------------------------------------------------------------------

TOY_SEARCHES = [
    dict(budget=32, threshold=1e-2),
    dict(budget=32, threshold=1e-1),
    dict(budget=32, threshold=2e-4),
    dict(budget=8, threshold=1e-2),
    dict(budget=5, threshold=2e-4),
    dict(budget=32, threshold=2e-2, min_fraction=1e-4),
    dict(budget=32, threshold=1e-2, widths=(10, 5, 3)),
    dict(budget=32, threshold=1e-2, max_scopes=1),
    dict(budget=32, threshold=2e-4, refine=False),
    dict(budget=32, threshold=1e-2, exp_bits=5),
]


@pytest.mark.parametrize("kw", TOY_SEARCHES,
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in
                                                 kw.items()))
def test_toy_search_matches_the_reference(kw):
    ja, ta = toy_args()
    rj = js.autosearch(jtoy, ja, js.rel_error, **kw)
    rt = ts.autosearch(ttoy, ta, ts.rel_error, **kw)
    assert_same_search(rj, rt)
    assert rt.n_sites == rj.n_sites
    # the table renders every discovered scope
    table = rt.table()
    for path in rt.assignments:
        assert path in table


def test_budget_one_and_the_reserved_joint_evaluation():
    ja, ta = toy_args()
    for budget in (0, 1):
        rj = js.autosearch(jtoy, ja, js.rel_error, budget, threshold=1e-2)
        rt = ts.autosearch(ttoy, ta, ts.rel_error, budget, threshold=1e-2)
        assert_same_search(rj, rt)
        assert rt.evals_used == 0 and rt.policy().rules == ()
        assert rt.converged and rt.n_sites == 0 and rt.n_traces == 0
    # budget 2: one probe of the widest scope, the other evaluation held
    # back for the joint check, so the budget is never overrun
    rj = js.autosearch(jtoy, ja, js.rel_error, 2, threshold=1e-2)
    rt = ts.autosearch(ttoy, ta, ts.rel_error, 2, threshold=1e-2)
    assert_same_search(rj, rt)
    assert [t for t, _ in rt.history] == ["ladder:mlp:m15", "joint"]
    assert rt.evals_used == 2


def test_exclusion_refinement_loop_matches_the_reference():
    """The paper's §6.3 dynamic: every scope passes its solo check but the
    composed policy misses the threshold, so the search excludes fragile
    scopes until the joint metric fits (the reference's own setup)."""
    ja, ta = toy_args(seed=3)
    ref = float(jtoy(*ja))

    def err_of(*scopes_):
        pol = JPolicy(rules=tuple(JRule(fmt=JFPFormat(8, 2), scope=s)
                                  for s in scopes_))
        return abs(float(jtruncate(jtoy, pol)(*ja)) - ref) / abs(ref)

    solo = {s: err_of(s) for s in ("attn", "mlp", "head")}
    joint = err_of("attn", "mlp", "head")
    assert joint > max(solo.values())      # this seed has the gap
    thr = (max(solo.values()) + joint) / 2.0
    kw = dict(threshold=thr, widths=(23, 2), min_fraction=1e-4)
    rj = js.autosearch(jtoy, ja, js.rel_error, 32, **kw)
    rt = ts.autosearch(ttoy, ta, ts.rel_error, 32, **kw)
    assert_same_search(rj, rt)
    assert rt.converged and any(a.excluded for a in rt.assignments.values())
    pol_scopes = {r.scope for r in rt.policy().rules}
    for path, a in rt.assignments.items():
        assert (path in pol_scopes) == (not a.excluded)


@pytest.mark.parametrize("hints", [
    {"mlp": 2, "attn": 2},
    {"mlp": None, "attn": 7},
    {"mlp": 15, "attn": 15},
    {"mlp/deeper/site": 5, "mlp": 3, "attn": None},
    {"attn": 10},
], ids=["accurate", "pinned", "too-fine", "deep-keys", "partial"])
def test_hand_written_warm_start_matches_the_reference(hints):
    ja, ta = toy_args()
    rj = js.autosearch(jtoy, ja, js.rel_error, 48, threshold=1e-2,
                       warm_start=hints)
    rt = ts.autosearch(ttoy, ta, ts.rel_error, 48, threshold=1e-2,
                       warm_start=hints)
    assert_same_search(rj, rt)
    assert rt.n_warm_hints == len({k.split("/")[0] for k in hints})


def test_warm_start_reproduces_the_unguided_search_with_fewer_evals():
    _, ta = toy_args()
    r0 = ts.autosearch(ttoy, ta, ts.rel_error, 48, threshold=1e-2)
    r1 = ts.autosearch(ttoy, ta, ts.rel_error, 48, threshold=1e-2,
                       warm_start=r0.hints())
    assert assigns(r1) == assigns(r0)
    assert r1.final_error == r0.final_error
    assert r1.evals_used < r0.evals_used
    assert r1.n_dispatches <= r0.n_dispatches


def test_frontier_hints_project_onto_the_frontier():
    ja, ta = toy_args()
    jscopes = js.discover_scopes(jax.make_jaxpr(jtoy)(*ja))
    tscopes = ts.discover_scopes(ttoy, ta)
    for hints in ({"mlp/deeper/site": 5, "mlp": 7}, {"mlp/deeper": None,
                                                     "mlp": 7}, {}, None):
        assert ts.driver._frontier_hints(hints, tscopes) == \
            js.driver._frontier_hints(hints, jscopes)
    with pytest.raises(TypeError, match="ladder_hints"):
        ts.autosearch(ttoy, ta, ts.rel_error, 8, warm_start="not-a-mapping")


@pytest.mark.parametrize("scan_layers,budget", [(True, 128), (True, 24),
                                                (False, 24)])
def test_bench_model_search_matches_the_reference(scan_layers, budget):
    """The reference's bench-model acceptance call (budget 128 is
    non-binding; 24 cuts the ladder, and is the one run of the unrolled
    model's 13-scope frontier, which would take 79 evaluations at 128)."""
    jm, jargs, tm, targs = bench(scan_layers)
    rj = js.autosearch(jm.loss, jargs, js.loss_degradation, budget,
                       threshold=5e-3)
    rt = ts.autosearch(tm.loss, targs, ts.loss_degradation, budget,
                       threshold=5e-3)
    assert_same_search(rj, rt)
    assert rt.n_sites == rj.n_sites
    assert rt.converged and len(rt.policy().rules) >= 1


def test_searched_policy_round_trips_through_truncate():
    """``truncate(fn, res.policy())`` is bit for bit the swept evaluation of
    the policy's table, so the metric of it is the search's final error."""
    _, ta = toy_args()
    res = ts.autosearch(ttoy, ta, ts.rel_error, 32, threshold=1e-2)
    assert res.policy().rules
    ref = ttoy(*ta)
    lossy = truncate(ttoy, res.policy())(*ta)
    site_policy = TruncationPolicy(rules=tuple(
        TruncationRule(fmt=FPFormat(8, 0), scope=p) for p in res.assignments))
    handle = truncate_sweep(ttoy, site_policy)(*ta)
    swept = handle(handle.table(res.policy()))
    assert lossy.view(torch.int32) == swept.view(torch.int32)
    assert ts.rel_error(ref.numpy(), lossy.numpy()) == res.final_error


def test_one_enumeration_and_only_the_real_rows_run():
    """Every candidate runs through one sweep handle; the program runs once
    to discover scopes, once to enumerate sites, once for the reference row
    and once per evaluation — the identity padding of a dispatch never
    runs."""
    _, ta = toy_args()
    calls = [0]

    def counted(*a):
        calls[0] += 1
        return ttoy(*a)

    res = ts.autosearch(counted, ta, ts.rel_error, 32, threshold=1e-2)
    assert res.n_traces == 1 and res.n_compiles == 1
    assert res.probe_batch == 7 and res.n_dispatches == 3
    assert calls[0] == 3 + res.evals_used
    # metrics see numpy pytrees on the host
    seen = []

    def spy(ref, cand):
        seen.append((type(ref), type(cand)))
        return ts.rel_error(ref, cand)

    ts.autosearch(ttoy, ta, spy, 4, threshold=1e-2)
    assert seen and all(t == (np.ndarray, np.ndarray) for t in seen)


def test_what_is_not_ported_raises(one_rank):
    """The static analysis and ``mesh`` are ported: a pruned search and a
    search on a probe mesh of one rank return the unpruned, unsharded
    one's assignments (several ranks: ``test_torch_spmd.py``); anything but
    a mesh, and ``in_shardings`` that are no prefix of the arguments, are
    refused as the reference refuses them."""
    _, ta = toy_args()
    # the static analysis is ported: a pruned search returns the unpruned
    # one's assignments
    pruned = ts.autosearch(ttoy, ta, ts.rel_error, 8, threshold=1e-2,
                           static_prune=True)
    assert pruned.static_verdicts is not None
    with pytest.raises(TypeError, match="mesh"):
        ts.autosearch(ttoy, ta, ts.rel_error, 8, mesh=object())
    with pytest.raises(ValueError, match="prefix"):
        ts.autosearch(ttoy, ta, ts.rel_error, 8, in_shardings=())
    res = ts.autosearch(ttoy, ta, ts.rel_error, 8, threshold=1e-2)
    on_mesh = ts.autosearch(ttoy, ta, ts.rel_error, 8, threshold=1e-2,
                            mesh=make_probe_mesh(device="cpu"))
    assert on_mesh.n_devices == 1
    assert on_mesh.history == res.history
    assert [(a.man_bits, a.excluded) for a in on_mesh.assignments.values()] \
        == [(a.man_bits, a.excluded) for a in res.assignments.values()]
    assert pruned.assignments.keys() == res.assignments.keys()
    assert [(a.man_bits, a.excluded) for a in pruned.assignments.values()] \
        == [(a.man_bits, a.excluded) for a in res.assignments.values()]
    # artifacts are ported: the search packages into one, and anything
    # that is neither a mapping nor carries hints is refused as warm_start
    assert res.to_artifact("toy").policy == res.policy()
    with pytest.raises(TypeError, match="warm_start"):
        ts.autosearch(ttoy, ta, ts.rel_error, 8, warm_start=[("attn", 5)])
