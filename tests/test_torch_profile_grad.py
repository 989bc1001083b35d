"""Profiling a training loss: ``profile_counts``, ``memtrace`` and
``profile_trajectory`` of ``value_and_grad(loss)`` against the reference's
of ``jax.value_and_grad(loss)``, on h2o-danube's smoke configuration (2
layers, d_model 64, d_ff 160, vocab 256; B = 2, S = 16, numpy-drawn
weights), ``remat`` on and off, and on toys.

**Names.** A backward op's location is ``transpose(jvp())/{forward scope}
{prim} @ {its forward op's file:line}``, a recomputed op's
``transpose(jvp())/rematted_computation/{scope} ...``; a forward op keeps
its plain scope where the reference writes ``jvp()/{scope}`` (or
``jvp({top})/...``). ``kinds`` maps both onto ``(forward | backward |
recompute, scope, prim)``.

**Where the two place an op differently.** ``logistic``'s JVP residual
(``1 - s`` and ``s * (1 - s)``: a ``sub`` and a ``mul`` per element) is
computed by the reference in the forward (in the recompute under
``remat``), by the port's derivative formula in the backward pass
(``interpreter._sigmoid_backward``): ``moved_residual`` moves them before
the per-kind comparison; flags and maxima are compared per (scope, prim)
over all kinds. Under an everywhere policy three scopes are left out,
each pinned in ``test_torch_grad_scopes.PINNED``: the attention's mix (the
mask constant, ``add`` / ``add_any`` sums), the rotary tables of
``attn/qkv`` (the reference's recompute computes them once for the
scanned layers, the port once per layer) and the loss's formulas.

**Counts** are a plain run: the backward ops are autograd's formulas. They
differ from the reference's transposed primitives by the terms
``count_differences`` names (ROADMAP Queue C 10).
"""
import collections

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jc
from repro.core import counters as jcounters
from repro.core.policy import normalize_stack as jnormalize

import repro_torch.core as tc
from repro_torch.core.interpreter import remat, scope
from repro_torch.core.memmode import BACKWARD_PREFIX, RECOMPUTE_PREFIX
from repro_torch.optim import tree as T
from repro_torch.train import value_and_grad

from test_torch_families import setup
from test_torch_memmode import stats

B, S = 2, 16
ARCH = "h2o-danube-1.8b"


def model(remat_on):
    return setup(ARCH, B=B, S=S, remat=remat_on)


def policies(name):
    if name == "scoped_mlp":
        return (jc.TruncationPolicy.scoped("layer/mlp", "e5m7"),
                tc.TruncationPolicy.scoped("layer/mlp", "e5m7"))
    return (jc.TruncationPolicy.everywhere("e8m3"),
            tc.TruncationPolicy.everywhere("e8m3"))


# --------------------------------------------------------------------------
# profile_counts
# --------------------------------------------------------------------------

@pytest.fixture
def normalized_reference_scopes(monkeypatch):
    """The reference keys ``by_scope`` by the raw first segment of a name
    stack (``jvp()``, ``transpose(jvp(loss))``); normalised here as the
    port keys its own (``layer``, ``loss``)."""
    join = jcounters.join_stack
    monkeypatch.setattr(jcounters, "join_stack",
                        lambda a, b: jnormalize(join(a, b)))


def count_differences(cfg, fmt):
    """(port - reference) FLOPs per (top scope, format), exact:

      * ``embed``: the reference's integer index arithmetic of ``jnp``
        indexing, B·S (also in the forward alone, Queue C 10);
      * ``final_norm``: the RMSNorm's derivative, 3 per token fewer
        (autograd raises the result to the third power and scales once
        where the reference divides and multiplies, ``_rsqrt_backward``);
      * ``loss``: log-sum-exp's and the maximum's derivatives, 2·B·S·V + B·S
        fewer (the reference's JVP recomputes ``exp(x - max)`` and the
        shifted logits);
      * ``layer``: ``logistic``'s derivative, 2·L·B·S·d_ff fewer (autograd's
        one fused ``sigmoid_backward`` against ``1 - s``, ``s (1 - s)`` and
        the product); under a policy that matches it, ``reduce_max``'s
        location count, L·B·S·d_model, which autograd sums as an integer
        (``full``) and the reference as a float, after a
        ``convert_element_type``. What is left under ``layer`` (the norms'
        and the attention's formulas) is below 1e-4 of the scope."""
    L, V, N = cfg.n_layers, cfg.vocab, B * S
    full = "full" if fmt != "e8m3" else fmt
    out = {("embed", "full"): -N, ("final_norm", full): -3 * N,
           ("loss", full): -(2 * N * V + N),
           ("layer", fmt): -2 * L * N * cfg.d_ff}
    if fmt == "e8m3":
        out[("layer", fmt)] -= L * N * cfg.d_model
        out[("layer", "full")] = L * N * cfg.d_model
    return out


@pytest.mark.parametrize("remat_on", [True, False])
@pytest.mark.parametrize("pol", ["scoped_mlp", "everywhere"])
def test_counts_of_a_train_loss_against_the_reference(
        pol, remat_on, normalized_reference_scopes):
    jm, jp, jb, tm, tp, tb = model(remat_on)
    jpol, tpol = policies(pol)
    jr = jc.profile_counts(jax.value_and_grad(jm.loss), jpol)(jp, jb)
    tr = tc.profile_counts(value_and_grad(tm.loss), tpol)(tp, tb)
    fmt = "e5m7" if pol == "scoped_mlp" else "e8m3"
    expected = count_differences(tm.cfg, fmt)
    for key in set(tr.by_scope) | set(jr.by_scope):
        got = tr.by_scope.get(key, 0) - jr.by_scope.get(key, 0)
        if key == ("layer", fmt) or key == ("layer", "full"):
            left = got - expected.get(key, 0)
            assert abs(left) <= 1e-4 * jr.by_scope[key], (key, got)
        else:
            assert got == expected.get(key, 0), (key, got)
    assert tr.total_flops == pytest.approx(jr.total_flops, rel=2.5e-3)
    # the backward's share: the step over the loss forward, near the
    # reference's (6 N D over 2 N D is 3 without remat, 4 with it)
    fwd = tc.profile_counts(tm.loss, tpol)(tp, tb).total_flops
    jfwd = jc.profile_counts(jm.loss, jpol)(jp, jb).total_flops
    assert tr.total_flops / fwd == pytest.approx(jr.total_flops / jfwd,
                                                 rel=3e-3)
    assert (3.0 if not remat_on else 3.6) < tr.total_flops / fwd < (
        3.1 if not remat_on else 3.8)


# --------------------------------------------------------------------------
# memtrace
# --------------------------------------------------------------------------

def kinds(rep, ref: bool):
    """(kind, scope, prim) -> [flags, max_rel, op_counts], locations on
    different lines summed."""
    out = collections.OrderedDict()
    for loc, f, m, o in zip(rep.locations, *stats(rep)):
        sc, prim = loc.split(" @ ")[0].rsplit(" ", 1)
        if ref:
            kind = ("recompute" if "rematted_computation" in sc
                    else "backward" if sc.startswith("transpose(")
                    else "forward")
            sc = jnormalize(sc)
        else:
            kind = "forward"
            for k, prefix in (("recompute", RECOMPUTE_PREFIX),
                              ("backward", BACKWARD_PREFIX)):
                if sc.startswith(prefix):
                    kind, sc = k, sc[len(prefix):].lstrip("/")
                    break
        sc = "" if sc == "<root>" else sc
        acc = out.setdefault((kind, sc, prim), [0, 0.0, 0])
        acc[0] += int(f)
        acc[1] = max(acc[1], float(m))
        acc[2] += int(o)
    return out


def moved_residual(table, mlp="layer/mlp"):
    """The reference's table with ``logistic``'s JVP residual (its ``sub``
    and as many ``mul`` elements) moved to the backward pass, where the
    port computes it. Op counts only."""
    out = {k: v[2] for k, v in table.items()}
    for kind in ("forward", "recompute"):
        n = out.pop((kind, mlp, "sub"), 0)
        if n:
            out[(kind, mlp, "mul")] -= n
            for prim in ("sub", "mul"):
                out[("backward", mlp, prim)] = out.get(
                    ("backward", mlp, prim), 0) + n
    return {k: v for k, v in out.items() if v}


def summed(table, leave_out=()):
    out = collections.OrderedDict()
    for (_, sc, prim), (f, m, o) in table.items():
        if sc in leave_out:
            continue
        acc = out.setdefault((sc, prim), [0, 0.0, 0])
        acc[0] += f
        acc[1] = max(acc[1], m)
        acc[2] += o
    return out


def assert_same_totals(jt, tt, flag_frac=1e-3):
    assert sorted(jt) == sorted(tt)
    for k in jt:
        (jf, jm, jo), (tf, tm, to) = jt[k], tt[k]
        assert to == jo, (k, jo, to)
        assert abs(tf - jf) <= flag_frac * jo, (k, jf, tf)
        assert abs(tm - jm) <= 2e-2 * jm + 1e-6, (k, jm, tm)


def bits(t):
    return t.detach().reshape(-1).view(torch.int32)


def assert_truncated_lane(out, tm, tpol, tp, tb):
    """The truncated lane is ``truncate``'s, bit for bit."""
    loss, grads = out
    want_loss, want_grads = tc.truncate(value_and_grad(tm.loss), tpol)(tp, tb)
    assert torch.equal(bits(loss), bits(want_loss))
    for a, b in zip(T.leaves(grads), T.leaves(want_grads)):
        assert torch.equal(bits(a), bits(b))


LEFT_OUT = ("layer/attn/mix", "layer/attn/qkv", "loss")


# the reference's ``memtrace`` of the differentiated smoke model under an
# everywhere policy takes ~30 s on the CPU: one such case (remat on, as the
# train path runs) keeps this file's cases under 90 s together
@pytest.mark.parametrize("pol,remat_on", [("scoped_mlp", True),
                                          ("scoped_mlp", False),
                                          ("everywhere", True)])
def test_memtrace_of_a_train_loss_location_by_location(pol, remat_on):
    jm, jp, jb, tm, tp, tb = model(remat_on)
    jpol, tpol = policies(pol)
    _, jrep = jc.memtrace(jax.value_and_grad(jm.loss), jpol)(jp, jb)
    out, trep = tc.memtrace(value_and_grad(tm.loss), tpol)(tp, tb)
    assert_truncated_lane(out, tm, tpol, tp, tb)
    jk, tk = kinds(jrep, True), kinds(trep, False)
    if pol == "scoped_mlp":
        # forward, backward and (under remat) recompute locations, each
        # backward one at its forward op's line
        assert {k[0] for k in tk} == ({"forward", "backward", "recompute"}
                                      if remat_on else
                                      {"forward", "backward"})
        assert moved_residual(jk) == {k: v[2] for k, v in tk.items()}
        lines = {loc.rsplit(" @ ", 1)[1] for loc in trep.locations}
        assert all(line.startswith(("transformer.py:", "common.py:"))
                   for line in lines), lines
        assert_same_totals(summed(jk), summed(tk))
    else:
        assert_same_totals(summed(jk, LEFT_OUT), summed(tk, LEFT_OUT))


def test_trajectory_of_a_train_loss_has_the_reference_steps():
    """Two layers: the forward's two trips, then the backward's in reverse
    layer order (each with its recompute), four steps as the reference's
    transposed scan gives; the rows' element counts equal and their
    maxima close, and the totals are ``memtrace``'s."""
    jm, jp, jb, tm, tp, tb = model(True)
    jpol, tpol = policies("scoped_mlp")
    _, jr = jc.profile_trajectory(jax.value_and_grad(jm.loss), jpol,
                                  n_steps=8)(jp, jb)
    out, tr = tc.profile_trajectory(value_and_grad(tm.loss), tpol,
                                    n_steps=8)(tp, tb)
    assert int(jr.steps_seen) == int(tr.steps_seen) == 4
    assert_truncated_lane(out, tm, tpol, tp, tb)
    np.testing.assert_array_equal(np.asarray(jr.op_counts).sum(1),
                                  tr.op_counts.numpy().sum(1))
    np.testing.assert_allclose(tr.max_rel.numpy().max(1),
                               np.asarray(jr.max_rel).max(1), rtol=2e-2,
                               atol=1e-6)
    _, rep = tc.memtrace(value_and_grad(tm.loss), tpol)(tp, tb)
    assert tr.totals.locations == rep.locations
    for k in ("flags", "max_rel", "op_counts"):
        assert torch.equal(getattr(tr.totals, k), getattr(rep, k)), k


# --------------------------------------------------------------------------
# toys: a saved output, a tensor read twice, a remat region
# --------------------------------------------------------------------------

def _toy_inputs():
    r = np.random.RandomState(0)
    return [r.randn(64).astype(np.float32) for _ in range(3)]


def _toy_tables(kind):
    x, w1, w2 = _toy_inputs()

    def jf(x):
        with jc.scope("f"):
            if kind == "saved_output":
                return jnp.sum(jnp.exp(x) * w1)
            if kind == "read_twice":
                y = jnp.exp(x)
                return jnp.sum(y * w1) + jnp.sum(y * w2)
            return jnp.sum(jax.checkpoint(lambda x: jnp.exp(x) * w1)(x))

    def tf(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            a, b = torch.from_numpy(w1), torch.from_numpy(w2)
            with scope("f"):
                if kind == "saved_output":
                    y = (torch.exp(x) * a).sum()
                elif kind == "read_twice":
                    e = torch.exp(x)
                    y = (e * a).sum() + (e * b).sum()
                else:
                    y = remat(lambda x: torch.exp(x) * a, x).sum()
            return torch.autograd.grad(y, x)[0]

    jpol = jc.TruncationPolicy.scoped("f", "e5m2",
                                      ops=("exp", "mul", "add_any"))
    tpol = tc.TruncationPolicy.scoped("f", "e5m2",
                                      ops=("exp", "mul", "add_any"))
    jg, jrep = jc.memtrace(jax.grad(jf), jpol)(jnp.asarray(x))
    tg, trep = tc.memtrace(tf, tpol)(torch.from_numpy(x))
    assert torch.equal(bits(tg), bits(tc.truncate(tf, tpol)(
        torch.from_numpy(x))))
    return kinds(jrep, True), kinds(trep, False)


@pytest.mark.parametrize("kind", ["saved_output", "read_twice", "remat"])
def test_toy_backward_passes_location_by_location(kind):
    """``saved_output``: ``exp``'s derivative reads the op's output, which
    autograd saves; its shadow lane must be the unrounded ``exp`` (a lost
    shadow gives 128 flags and a maximum of 0.170 at the backward ``mul``
    where the reference has 126 and 0.215). ``read_twice``: the engine's
    sum of ``exp``'s two cotangents is an ``add_any`` of the walk, on both
    lanes. ``remat``: the recompute makes the shadows its backward reads."""
    jk, tk = _toy_tables(kind)
    # the reference's recompute of a checkpoint called inside ``f`` keeps
    # the caller's scope and adds the body's own: ``f/f``
    jk = collections.OrderedDict(
        ((k, "f" if sc == "f/f" else sc, p), v) for (k, sc, p), v in jk.items())
    assert list(jk) == list(tk)
    assert_same_totals(jk, tk, flag_frac=0.0)
    assert ("backward", "f", "mul") in tk
    if kind == "read_twice":
        assert ("backward", "f", "add_any") in tk
    if kind == "remat":
        assert ("recompute", "f", "exp") in tk
