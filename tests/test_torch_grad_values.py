"""Truncated gradients equal to the reference's.

``truncate(value_and_grad(loss), policy)`` of the smoke h2o-danube-1.8b
loss (B = 2, S = 16) in both packages, on the same numpy-drawn parameters
and batch: the loss, and in every gradient leaf at most 1 % of the elements
more than 1e-3 relative from the reference's. The policies are the loss's
scope at e5m2, the attention at e8m3 (the train path's hot-swapped rung)
and at e5m7, and the blockwise attention's mix alone at e8m3; each with
and without ``remat``. The elements that still differ (at most 0.02 % of a
leaf) sit one rounding step apart: an f32 multiply-add that XLA's CPU code
contracts and PyTorch rounds twice (ROADMAP Queue C 3) lands on the other
side of a boundary.

``test_pinned_sites_change_no_value``: the sites the two packages still
count differently (``test_torch_grad_scopes.PINNED``) move no value. A
policy that rounds only the pinned primitives of a pinned scope, at e5m2,
gives gradients within the same 1 %: a pinned site that changed a value
would change it in every element downstream.

``test_truncated_gradients_equal_the_reference_across_attention_chunks``:
the blockwise attention alone with four q and four kv chunks (causal, and
with a window that skips kv chunks), where the port's ``k`` / ``v``
cotangents are summed over the kv trips and the reference's stacked, and
where a trip's backward sites are not the same set as one chunk's (the
port's first trip, on a constant carry, has sites of its own). The
gradients of ``q``, ``k`` and ``v`` within the same 1 % under the
attention policies, and under a policy that rounds only the primitives
whose counts differ there.

``test_clamp_gradients_equal_the_reference``: ``torch.clamp`` against
``jnp.clip`` with a lower bound, an upper bound or both, under a policy
that rounds every site; the gradient is zero outside the bounds.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jc
from repro.models.attention import flash_attention as jflash

import repro_torch.core as tc
from repro_torch.core import scope
from repro_torch.models.attention import flash_attention as tflash
from repro_torch.optim import tree as T
from repro_torch.train import value_and_grad

from test_torch_families import setup
from test_torch_grad_scopes import PINNED

OFF_RTOL = 1e-3          # an element is off beyond this relative distance
OFF_SHARE = 1e-2         # ... and a leaf may hold at most this share of them


def grads_both(remat, scope, fmt, ops=None):
    """(reference loss, its gradient leaves, port loss, its leaves) under
    ``scoped(scope, fmt, ops=ops)``."""
    jm, jp, jb, tm, tp, tb = setup("h2o-danube-1.8b", B=2, S=16, remat=remat)
    kw = {} if ops is None else {"ops": ops}
    jl, jg = jc.truncate(jax.value_and_grad(jm.loss),
                         jc.TruncationPolicy.scoped(scope, fmt, **kw))(jp, jb)
    tl, tg = tc.truncate(value_and_grad(tm.loss),
                         tc.TruncationPolicy.scoped(scope, fmt, **kw))(tp, tb)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    return (float(jl), [(jax.tree_util.keystr(k), np.asarray(a))
                        for k, a in jflat],
            float(tl), [b.detach().numpy() for b in T.leaves(tg)])


def assert_same_gradients(remat, scope, fmt, ops=None):
    jl, jleaves, tl, tleaves = grads_both(remat, scope, fmt, ops)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert len(jleaves) == len(tleaves)
    shares = {}
    for (name, a), b in zip(jleaves, tleaves):
        assert a.shape == b.shape, name
        shares[name] = float((np.abs(b - a) > OFF_RTOL * np.abs(a)).mean())
    assert max(shares.values()) <= OFF_SHARE, shares


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("scope,fmt", [
    ("loss", "e5m2"),
    ("layer/attn/**", "e8m3"),
    ("layer/attn/mix", "e8m3"),
    ("layer/attn/**", "e5m7"),
])
def test_truncated_gradients_equal_the_reference(scope, fmt, remat):
    """Before the repair 70-99 % of ``wq`` / ``wk`` (attention policies)
    and of every leaf but ``embed`` / ``lm_head`` (the loss's) were off."""
    assert_same_gradients(remat, scope, fmt)


def _prims(remat, scope):
    ref_only, port_only = PINNED[remat][scope]
    return sorted(set(ref_only) | set(port_only))


# (remat, scope, the primitives a policy rounds): each pinned primitive of
# the attention alone, the loss's few sites together; remat pins one more
# mask constant in the attention
PINNED_CASES = (
    [(False, "layer/attn/mix", (p,))
     for p in _prims(False, "layer/attn/mix")]
    + [(False, "loss", tuple(_prims(False, "loss"))),
       (True, "layer/attn/mix", ("convert_element_type",))])


@pytest.mark.parametrize("remat,scope,ops", PINNED_CASES)
def test_pinned_sites_change_no_value(remat, scope, ops):
    assert_same_gradients(remat, scope, "e5m2", ops)


def off_share(a, b):
    """The share of ``b``'s elements more than ``OFF_RTOL`` relative from
    ``a``'s."""
    a = np.asarray(a)
    return float((np.abs(np.asarray(b) - a) > OFF_RTOL * np.abs(a)).mean())


# the primitives whose counts differ between the two packages in the
# multi-chunk attention's ``layer/attn/mix``
CHUNK_PRIMS = ("add", "add_any", "convert_element_type", "div", "mul",
               "reduce_sum")


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("scope_,fmt,ops", [
    ("layer/attn/**", "e8m3", None),
    ("layer/attn/mix", "e8m3", None),
    ("layer/attn/**", "e5m7", None),
    ("layer/attn/mix", "e5m2", CHUNK_PRIMS),
])
def test_truncated_gradients_equal_the_reference_across_attention_chunks(
        scope_, fmt, ops, window):
    r = np.random.RandomState(1)
    q, k, v = (r.randn(2, h, 16, 8).astype(np.float32) for h in (4, 2, 2))
    w = r.randn(2, 4, 16, 8).astype(np.float32)
    chunks = dict(causal=True, window=window, q_chunk=4, kv_chunk=4)

    def jf(q, k, v):
        with jax.named_scope("layer"), jax.named_scope("attn"), \
                jax.named_scope("mix"):
            o = jflash(q, k, v, **chunks)
        return jnp.sum(o * w)

    def tf(q, k, v):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        with scope("layer"), scope("attn"), scope("mix"):
            o = tflash(q, k, v, **chunks)
        loss = (o * torch.from_numpy(w)).sum()
        return loss, torch.autograd.grad(loss, (q, k, v))

    kw = {} if ops is None else {"ops": ops}
    jl, jg = jc.truncate(jax.value_and_grad(jf, argnums=(0, 1, 2)),
                         jc.TruncationPolicy.scoped(scope_, fmt, **kw))(
        q, k, v)
    tl, tg = tc.truncate(tf, tc.TruncationPolicy.scoped(scope_, fmt, **kw))(
        *map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    shares = [off_share(a, b.numpy()) for a, b in zip(jg, tg)]
    assert max(shares) <= OFF_SHARE, shares


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (-1.0, None), (None, 1.0)])
def test_clamp_gradients_equal_the_reference(lo, hi):
    """Before the repair a clamp with both bounds passed the cotangent
    through above the upper one."""
    r = np.random.RandomState(2)
    x = r.uniform(-3, 3, 64).astype(np.float32)
    w = r.randn(64).astype(np.float32)

    def tf(x):
        x = x.detach().requires_grad_()
        loss = (torch.clamp(x, lo, hi) * torch.from_numpy(w)).sum()
        return loss, torch.autograd.grad(loss, x)[0]

    jl, jg = jc.truncate(
        jax.value_and_grad(lambda x: jnp.sum(jnp.clip(x, lo, hi) * w)),
        jc.TruncationPolicy.everywhere("e5m2"))(jnp.asarray(x))
    tl, tg = tc.truncate(tf, tc.TruncationPolicy.everywhere("e5m2"))(
        torch.from_numpy(x))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    outside = ((x < lo) if lo is not None else False) | (
        (x > hi) if hi is not None else False)
    assert outside.any() and not tg.numpy()[outside].any()
