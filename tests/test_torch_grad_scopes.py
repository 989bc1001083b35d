"""Gradients inside ``truncate`` / ``truncate_sweep``: every backward op
runs under the scope of the forward op it differentiates, as in the
reference (whose backward equations keep the name stack
``transpose(jvp(mlp))``, normalised to ``mlp``).

* The twin of ``tests/test_interpreter.py::test_scoped_policy_survives_grad``
  (red on jax 0.9.0 only for its ``rtol=1e-6`` miss case): a policy scoped
  to ``mlp`` rounds the backward dot, one scoped to nothing leaves the
  gradient as it is.
* Sites of the differentiated smoke h2o-danube-1.8b loss, scope by scope,
  against the reference's: 237 there without ``remat`` and 300 with it
  (the smoke config's own setting), 231 and 293 here. The scopes holding
  sites are the same, and so are the contractions (``dot_general``) in
  every scope and the rematerialised forward of every layer. Where
  autograd's derivative formulas differ from JAX's JVP rules on this
  model, the walk computes the reference's elementary ops
  (``interpreter._FORMULAS``): ``logistic``'s ``1 - s`` and ``s (1 - s)``,
  ``rsqrt``'s ``rsqrt(x) / x``, the ``reduce_sum`` that transposes a
  ``keepdims`` reduction, a ``[..., None]`` and ``jnp``'s rank promotion
  of the norm's scale, ``reduce_max``'s converted location mask and its
  count, ``max``'s tie weights (``jnp.maximum`` of two arrays or with a
  constant), ``div``'s ``integer_pow(y, -2)`` for the denominator and
  ``abs``'s ``add_any``; a ``remat`` recompute of a jitted helper
  (``silu``) has sites of its own, as the reference's JVP body has; and
  the blockwise attention's loops start the cotangent sums of their consts
  and of the final ``m`` at zero, as the reference's scan transpose does
  (``interpreter.loop_const``, ``interpreter.zero_cotangents``). The loss
  shifts by a maximum that carries no gradient, as ``jax.nn.logsumexp``
  does. What is left is pinned in ``PINNED`` (ROADMAP Queue C 1 and 5),
  and moves no value: JAX materialises the mask constant
  (``convert_element_type``) that torch passes as a scalar; its scan
  transpose computes the cotangents of the constant first carries and
  drops them, and its linearisation leaves the dead JVP of the loss's
  maximum in the program; torch's recompute of a kv chunk runs on to its
  last saved tensor. autograd also visits a scope's nodes in another
  order than XLA's transpose, so scopes are compared as multisets, not
  sequences.
* Each of the ten smoke configurations' differentiated losses enumerates
  under ``scope:**`` with every aten op named.
* Backward sites do not depend on the thread that runs them.
"""
import collections
import threading

import numpy as np
import pytest

import jax
import torch

import repro.core as jc
from repro.configs import base as jbase

import repro_torch.core as tc
from repro_torch.configs import base as tbase
from repro_torch.core import scope
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.train import value_and_grad

from test_torch_families import make_batch, numpy_params, prims_by_scope, setup
from torch_threads import one_torch_thread  # noqa: F401


def _loss(w, x):
    with scope("mlp"):
        h = torch.tanh(x @ w)
    return torch.sum(h ** 2)


def _grad(w, x):
    w = w.detach().requires_grad_()
    (g,) = torch.autograd.grad(_loss(w, x), w)
    return g


def _wx():
    w = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    x = np.random.RandomState(1).randn(4, 8).astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy(x)


def test_scoped_policy_survives_grad():
    w, x = _wx()
    g_full = _grad(w, x)
    g_tr = tc.truncate(_grad, tc.TruncationPolicy.scoped("mlp", "e5m2"))(w, x)
    assert not np.allclose(g_full.numpy(), g_tr.numpy())
    g_miss = tc.truncate(_grad,
                         tc.TruncationPolicy.scoped("nothing", "e5m2"))(w, x)
    np.testing.assert_allclose(g_full.numpy(), g_miss.numpy(), rtol=1e-6)


def test_backward_dot_and_tanh_backward_are_mlp_sites():
    """The backward ``dot_general`` and ``tanh_backward`` (a ``mul`` to a
    policy) carry the forward op's stack ``mlp``; the seed gradient and the
    backward of ops outside any scope stay at the root."""
    w, x = _wx()
    h = tc.truncate_sweep(_grad, tc.TruncationPolicy.everywhere("e5m2"))(w, x)
    by = prims_by_scope(h)
    assert by["mlp"] == ["dot_general", "tanh", "mul", "dot_general"]
    # ``x ** 2`` is ``square`` to the walk, whose JVP (``2 * x``, then the
    # cotangent's product) raises nothing to a power
    assert by[""] == ["square", "reduce_sum", "mul", "mul"]
    keys = h.index.site_keys()
    assert [k[0] for k in keys if k[0].startswith("mlp")] == [
        "mlp", "mlp", "mlp/#grad1", "mlp/#grad0:01"]
    # the backward dot under mlp is rounded by a policy scoped to it alone
    pol = tc.TruncationPolicy.scoped("mlp", "e5m2", ops=("dot_general",))
    only_bwd = h.table(pol)
    only_bwd[[i for i, k in enumerate(keys) if "#grad" not in k[0]]] = \
        h.identity_table()[0]
    assert not torch.equal(h(only_bwd), _grad(w, x))


# per scope: (primitives only the reference has, only the port has), with
# and without remat -- ROADMAP Queue C 1 and 5. None of them moves a value
# (tests/test_torch_grad_values.py::test_pinned_sites_change_no_value)
PINNED = {
    False: {"layer/attn/mix": ({"add_any": 1, "convert_element_type": 3,
                                "mul": 1}, {"add": 1, "reduce_sum": 1}),
            "loss": ({"convert_element_type": 1, "div": 1,
                      "reduce_sum": 1}, {})},
    True: {"layer/attn/mix": ({"add_any": 1, "convert_element_type": 4,
                               "mul": 1}, {"add": 1, "reduce_sum": 1}),
           "loss": ({"convert_element_type": 1, "div": 1,
                     "reduce_sum": 1}, {})},
}
TOTALS = {False: (237, 231), True: (300, 293)}


@pytest.mark.parametrize("remat", [False, True])
def test_grad_sites_per_scope_against_the_reference(remat):
    jm, jp, jb, tm, tp, tb = setup("h2o-danube-1.8b", B=2, S=16, remat=remat)
    site = "e5m2"
    jh = jc.truncate_sweep(jax.value_and_grad(jm.loss),
                           jc.TruncationPolicy.everywhere(site))(jp, jb)
    th = tc.truncate_sweep(value_and_grad(tm.loss),
                           tc.TruncationPolicy.everywhere(site))(tp, tb)
    assert (len(jh.sites), len(th.sites)) == TOTALS[remat]
    js, ts = prims_by_scope(jh), prims_by_scope(th)
    assert set(js) == set(ts)
    diff = {}
    for s in js:
        a, b = collections.Counter(js[s]), collections.Counter(ts[s])
        if a != b:
            diff[s] = (dict(a - b), dict(b - a))
        assert a["dot_general"] == b["dot_general"], s
    assert diff == PINNED[remat]


# the four families whose truncated gradients
# ``test_torch_grad_values_families.py`` holds to the reference's (B = 2,
# S = 16):
# (sites of the reference, of the port), and per scope (primitives only the
# reference has, only the port has). The attention's rows are ``PINNED``'s
# (``MIX``, four mask constants under remat); the loss's too. Others:
# RWKV-6's time mix, the reference's recompute of its checkpointed chunk
# (``mul`` 2, ``add`` 2) against one ``reduce_sum``; deepseek-v2's combine
# under remat, the port's recompute of its gate product; the
# encoder-decoder's first encoder layer norm, whose input needs no gradient
# (its backward frames carry the mask, ``#grad<pos>:10``). The layer norms'
# ``add_any`` that summed the residual stream's cotangents (two fewer in
# ``dec_layer/layernorm``, one in ``enc_layer/layernorm``) is repaired:
# a jitted helper's input cotangents are summed inside it
# (``interpreter.shared_body``, ROADMAP Queue C 21)
MIX = {False: ({'add_any': 1, 'convert_element_type': 3, 'mul': 1}, {'add': 1, 'reduce_sum': 1}),
       True: ({'add_any': 1, 'convert_element_type': 4, 'mul': 1}, {'add': 1, 'reduce_sum': 1})}
LOSS = ({"convert_element_type": 1, "div": 1, "reduce_sum": 1}, {})
FAMILY_PINNED = {
    ("rwkv6-7b", False): ((285, 279), {
        "layer/time_mix": ({"add": 2, "mul": 2}, {"reduce_sum": 1}),
        "loss": LOSS}),
    ("rwkv6-7b", True): ((353, 347), {
        "layer/time_mix": ({"add": 2, "mul": 2}, {"reduce_sum": 1}),
        "loss": LOSS}),
    ("olmoe-1b-7b", False): ((263, 257), {
        "layer/attn/mix": MIX[False], "loss": LOSS}),
    ("olmoe-1b-7b", True): ((333, 326), {
        "layer/attn/mix": MIX[True], "loss": LOSS}),
    ("deepseek-v2-236b", False): ((583, 574), {
        "layer/attn/mla_mix": MIX[False],
        "lead_layer0/attn/mla_mix": MIX[False], "loss": LOSS}),
    ("deepseek-v2-236b", True): ((672, 664), {
        "layer/attn/mla_mix": MIX[True],
        "layer/moe/combine": ({}, {"mul": 1, "reduce_sum": 1}),
        "lead_layer0/attn/mla_mix": MIX[False], "loss": LOSS}),
    ("seamless-m4t-large-v2", False): ((670, 661), {
        "dec_layer/cross_attn": MIX[False],
        "dec_layer/self_attn/mix": MIX[False],
        "enc_layer/layernorm": ({}, {"mul": 1, "reduce_sum": 2}),
        "enc_layer/self_attn/mix": MIX[False], "loss": LOSS}),
    ("seamless-m4t-large-v2", True): ((855, 843), {
        "dec_layer/cross_attn": MIX[True],
        "dec_layer/self_attn/mix": MIX[True],
        "enc_layer/layernorm": ({}, {"mul": 1, "reduce_sum": 2}),
        "enc_layer/self_attn/mix": MIX[True], "loss": LOSS}),
    # hymba's Mamba: the reference's recompute of its checkpointed chunk
    # body (``mul``, ``add``, ``exp``) against the residuals of
    # ``softplus``'s JVP, which the port computes in the forward also under
    # ``remat`` (``sub``, ``exp``; ``models.common._Softplus``). Without
    # remat each global layer's chunk is recomputed on its own
    ("hymba-1.5b", False): ((1155, 1131), {
        "global_layer/attn/mix": ({"add_any": 2, "convert_element_type": 3,
                                   "mul": 2}, {"add": 2, "reduce_sum": 2}),
        "global_layer/mamba": ({"add": 2, "exp": 2, "mul": 6}, {}),
        "layer/attn/mix": MIX[False],
        "layer/mamba": ({"add": 1, "exp": 1, "mul": 3}, {}),
        "loss": LOSS}),
    ("hymba-1.5b", True): ((1129, 1118), {
        "global_layer/attn/mix": MIX[True],
        "global_layer/mamba": ({"add": 1, "mul": 2}, {"exp": 1, "sub": 2}),
        "layer/attn/mix": MIX[True],
        "layer/mamba": ({"add": 1, "mul": 2}, {"exp": 1, "sub": 2}),
        "loss": LOSS}),
}


@pytest.mark.parametrize("arch,remat", sorted(FAMILY_PINNED))
def test_family_grad_sites_per_scope_against_the_reference(arch, remat):
    jm, jp, jb, tm, tp, tb = setup(arch, B=2, S=16, remat=remat)
    jh = jc.truncate_sweep(jax.value_and_grad(jm.loss),
                           jc.TruncationPolicy.everywhere("e5m2"))(jp, jb)
    th = tc.truncate_sweep(value_and_grad(tm.loss),
                           tc.TruncationPolicy.everywhere("e5m2"))(tp, tb)
    totals, pinned = FAMILY_PINNED[(arch, remat)]
    assert (len(jh.sites), len(th.sites)) == totals
    js, ts = prims_by_scope(jh), prims_by_scope(th)
    assert set(js) == set(ts)
    diff = {}
    for s in js:
        a, b = collections.Counter(js[s]), collections.Counter(ts[s])
        if a != b:
            diff[s] = (dict(a - b), dict(b - a))
        assert a["dot_general"] == b["dot_general"], s
    assert diff == pinned


def test_remat_adds_the_reference_recompute_of_each_layer():
    """With ``remat`` each scanned layer's forward runs again in the
    backward pass under its own scopes: what the reference adds, site for
    site, in every layer scope but the attention's mix (where the
    difference is pinned above). In the MLP that includes the recompute of
    the jitted ``silu``, which has sites of its own."""
    out = {}
    for remat in (False, True):
        jm, jp, jb, tm, tp, tb = setup("h2o-danube-1.8b", B=2, S=16,
                                       remat=remat)
        jh = jc.truncate_sweep(jax.value_and_grad(jm.loss),
                               jc.TruncationPolicy.everywhere("e5m2"))(jp, jb)
        th = tc.truncate_sweep(value_and_grad(tm.loss),
                               tc.TruncationPolicy.everywhere("e5m2"))(tp, tb)
        out[remat] = prims_by_scope(jh), prims_by_scope(th)
    for s in ("layer", "layer/attn/qkv", "layer/attn/proj", "layer/mlp",
              "layer/pre_norm/rmsnorm", "layer/post_norm/rmsnorm",
              "layer/attn/mix/bhgqd,bhkd->bhgqk"):
        added_ref = len(out[True][0][s]) - len(out[False][0][s])
        added_port = len(out[True][1][s]) - len(out[False][1][s])
        assert added_ref == added_port > 0, s


def test_mlp_truncated_gradients_equal_the_reference():
    """The gradients of the MLP weights under ``**/mlp`` at e5m2, where
    every elementary op of the MLP's forward and backward is rounded to two
    mantissa bits: the reference's values at the tolerance of the gradient
    tests below (``rtol 1e-4``, ``atol 1e-6``). The backward ops follow the
    reference's formulas (``logistic``'s ``1 - s`` and ``s (1 - s)`` as
    sites), so only an upstream last-bit difference of the f32 forward
    (XLA's CPU contracts multiply-adds, ROADMAP Queue C 3) can move a value
    across a rounding boundary of e5m2: at most one element in 10^4, and
    then by one e5m2 step. With autograd's fused ``sigmoid_backward``
    3.2 % of ``wi`` and 1.1 % of ``wo`` were outside the tolerance."""
    jm, jp, jb, tm, tp, tb = setup("h2o-danube-1.8b", B=2, S=16)
    jl, jg = jc.truncate(jax.value_and_grad(jm.loss),
                         jc.TruncationPolicy.scoped("**/mlp", "e5m2"))(jp, jb)
    tl, tg = tc.truncate(value_and_grad(tm.loss),
                         tc.TruncationPolicy.scoped("**/mlp", "e5m2"))(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in ("wi", "wo"):
        a = np.asarray(jg["layers"]["mlp"][k])
        b = tg["layers"]["mlp"][k].numpy()
        off = np.abs(b - a) > 1e-4 * np.abs(a) + 1e-6
        assert off.mean() <= 1e-4, (k, off.mean())
        np.testing.assert_allclose(b[off], a[off], rtol=2.0 ** -2)


def test_plain_gradients_keep_autograd_formulas():
    """A walk that rounds nothing (a policy without rules) leaves
    autograd's formulas as they are: loss and gradients bit-equal to the
    plain call."""
    _, _, _, tm, tp, tb = setup("h2o-danube-1.8b", B=2, S=16)
    vg = value_and_grad(tm.loss)
    pl, pg = vg(tp, tb)
    wl, wg = tc.truncate(vg, tc.TruncationPolicy(rules=()))(tp, tb)
    from repro_torch.optim import tree as T
    assert torch.equal(pl, wl)
    for a, b in zip(T.leaves(pg), T.leaves(wg)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_every_config_differentiates_with_every_aten_op_named(arch):
    cfg = tbase.get_config(arch, "smoke")
    m = Model(cfg)
    tp = params_from_jax(numpy_params(m.param_defs()), cfg, "cpu")
    _, tb = make_batch(cfg, 2, 16 if cfg.family != "hybrid" else 32)
    vg = value_and_grad(m.loss)
    h = tc.truncate_sweep(vg, tc.TruncationPolicy.everywhere("e5m2"))(tp, tb)
    stacks = {s.scope for s in h.sites}
    assert any("#grad" in k[0] for k in h.index.site_keys())
    assert "" not in stacks or len(stacks) > 1
    loss, grads = h(h.identity_table())
    want, _ = vg(tp, tb)
    assert loss.view(torch.int32) == want.view(torch.int32)


def test_backward_sites_do_not_depend_on_the_thread():
    """Two calls from two other threads give the same sites, the same
    values and one enumeration: a backward op's position is counted in
    its node's frame, not on a thread's stack."""
    _, _, _, tm, tp, tb = setup("h2o-danube-1.8b", B=2, S=16)
    sweep = tc.truncate_sweep(value_and_grad(tm.loss),
                              tc.TruncationPolicy.everywhere("e5m2"))
    pol = tc.TruncationPolicy.scoped("layer/mlp", "e5m7")
    out = []

    def run():
        h = sweep(tp, tb)
        out.append((h.index.site_keys(), h(h.table(pol))))

    for _ in range(2):
        t = threading.Thread(target=run)
        t.start()
        t.join()
    run()
    assert sweep.n_traces == 1
    (k0, (l0, g0)), (k1, (l1, g1)), (k2, (l2, _)) = out
    assert k0 == k1 == k2
    assert l0.view(torch.int32) == l1.view(torch.int32) == \
        l2.view(torch.int32)


@pytest.mark.parametrize("which", ["memtrace", "profile_trajectory",
                                   "profile_counts"])
def test_profiling_a_backward_pass_raises(which):
    """A backward pass inside the profiled function raised
    ``NotImplementedError`` until the profilers followed it; now each
    profiles it under the forward op's scope: mem-mode and trajectories
    tally the backward ops (``transpose(jvp())/mlp``) and keep the
    truncated lane ``truncate``'s, the counters charge them to ``mlp``
    (``tests/test_torch_profile_grad.py`` holds all three to the
    reference)."""
    w, x = _wx()
    pol = tc.TruncationPolicy.scoped("mlp", "e5m2")
    if which == "profile_counts":
        grad = tc.profile_counts(_grad, pol)(w, x).by_scope[("mlp", "e5m2")]
        fwd = tc.profile_counts(_loss, pol)(w, x).by_scope[("mlp", "e5m2")]
        assert grad > fwd
        return
    g, rep = getattr(tc, which)(_grad, pol)(w, x)
    assert torch.equal(g, tc.truncate(_grad, pol)(w, x))
    locs = getattr(rep, "totals", rep).locations
    assert any(loc.startswith("transpose(jvp())/mlp ") for loc in locs)


def test_loop_trips_keep_their_sites_through_remat_and_constant_carries():
    """The blockwise attention with several q and kv chunks: every chunk is
    a ``remat`` region whose saved-tensor hooks issue a ``detach`` per saved
    tensor, and the first kv trip's carry is a constant whose nodes need
    fewer gradients. Neither may make two different ops share a site: the
    policy-driven and the table-driven step give the same bits, also under
    a rule restricted to one primitive."""
    from repro_torch.models.attention import flash_attention
    r = np.random.RandomState(0)
    q = torch.from_numpy(r.randn(1, 4, 16, 8).astype(np.float32))
    k = torch.from_numpy(r.randn(1, 2, 16, 8).astype(np.float32))
    v = torch.from_numpy(r.randn(1, 2, 16, 8).astype(np.float32))

    def f(q, k, v):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        with scope("mix"):
            o = flash_attention(q, k, v, causal=True, q_chunk=4, kv_chunk=4)
        loss = (o * o).sum()
        return loss, torch.autograd.grad(loss, (q, k, v))

    h = tc.truncate_sweep(f, tc.TruncationPolicy.everywhere("e5m2"))(q, k, v)
    keys = h.index.site_keys()
    assert any(":" in k[0] for k in keys)              # constant carries
    assert any("#remat" in k[0] for k in keys)
    for pol in (tc.TruncationPolicy.scoped("mix", "e8m3"),
                tc.TruncationPolicy.scoped("mix", "e8m3", ops=("mul",)),
                tc.TruncationPolicy.scoped("mix", "e8m3", ops=("exp",))):
        want = tc.truncate(f, pol)(q, k, v)
        got = h(h.table(pol))
        for a, b in zip((want[0],) + want[1], (got[0],) + got[1]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_gradients_equal_the_reference_across_attention_chunks():
    """Loss and every gradient of the smoke h2o-danube loss at S = 2048,
    where the blockwise attention runs two q chunks and three (q, kv) chunk
    pairs, each a ``remat`` region recomputed in the backward pass: equal to
    ``jax.value_and_grad`` of the reference (``rtol 1e-4``, as the forward;
    ``atol 1e-6`` of gradients that are sums over 2048 tokens)."""
    jm, jp, jb, tm, tp, tb = setup("h2o-danube-1.8b", B=1, S=2048)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tl, tg = value_and_grad(tm.loss)(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    from repro_torch.optim import tree as T
    jleaves = jax.tree_util.tree_leaves(jg)
    tleaves = T.leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-6)
