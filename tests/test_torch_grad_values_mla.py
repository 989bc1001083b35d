"""The MLA family (deepseek-v2-236b) under ``layer/attn/mla_mix`` e8m3:
its truncated gradients differ from the reference's only through an fma
ulp (``test_torch_grad_values_families.py``'s docstring). The block alone
on equal inputs is held to the measure; the model's loss within 1e-5."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jc
from repro.models import attention as jattn

import repro_torch.core as tc
from repro_torch.core import scope
from repro_torch.models import attention as tattn

from test_torch_families import setup
from test_torch_grad_values import OFF_SHARE, off_share
from test_torch_grad_values_families import leaf_shares


@pytest.mark.parametrize("remat", [False, True])
def test_mla_gradients_move_only_by_the_fma(remat):
    """The model under ``layer/attn/mla_mix`` e8m3: the loss within 1e-5
    (one element flipped by an fma ulp, see the module docstring), where
    it differed by 5e-6 before and after the repairs alike."""
    jl, tl, _ = leaf_shares("deepseek-v2-236b", remat, "layer/attn/mla_mix",
                            "e8m3")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def _mla_block(scope_, fmt):
    """One MLA attention block of the smoke deepseek-v2 (its first scanned
    layer's weights) on the same numpy input in both packages: the loss
    ``sum(out * W)`` and its gradients in the parameters and the input."""
    jm, jp, jb, tm, tp, tb = setup("deepseek-v2-236b", B=2, S=16)
    p = {k: np.asarray(v[0]) for k, v in jp["layers"]["attn"].items()}
    r = np.random.RandomState(3)
    B, S, d = 2, 16, tm.cfg.d_model
    x = r.randn(B, S, d).astype(np.float32)
    w = r.randn(B, S, d).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()

    def jf(p, x):
        with jax.named_scope("attn"):
            out = jattn.mla_forward(p, x, jm.cfg, positions=jnp.asarray(pos))
        return jnp.sum(out[0] * w)

    def tf(p, x):
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        x = x.detach().requires_grad_()
        with scope("attn"):
            out = tattn.mla_forward(p, x, tm.cfg,
                                    positions=torch.from_numpy(pos))
        loss = (out[0] * torch.from_numpy(w)).sum()
        return loss, torch.autograd.grad(loss, list(p.values()) + [x])

    jl, (jgp, jgx) = jc.truncate(
        jax.value_and_grad(jf, argnums=(0, 1)),
        jc.TruncationPolicy.scoped(scope_, fmt))(p, x)
    tl, tg = tc.truncate(tf, tc.TruncationPolicy.scoped(scope_, fmt))(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    return (float(jl), [np.asarray(jgp[k]) for k in p] + [np.asarray(jgx)],
            float(tl), [g.numpy() for g in tg])


def test_mla_block_gradients_equal_the_reference():
    jl, jg, tl, tg = _mla_block("attn/mla_mix", "e8m3")
    # the losses are sums of 2048 products in another order
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert max(off_share(a, b) for a, b in zip(jg, tg)) <= OFF_SHARE


def test_mla_mix_moves_by_the_fma():
    """The two halves of the MLA case: the blockwise attention at the MLA
    shapes (q / k heads of 24, v heads of 16, scale 1/sqrt(24)) under the
    policy is bit-equal on equal inputs, and a multiply-add, which the
    norms and the rotary embedding feeding it hold, is not."""
    r = np.random.RandomState(4)
    q, k = (r.randn(2, 4, 16, 24).astype(np.float32) for _ in range(2))
    v = r.randn(2, 4, 16, 16).astype(np.float32)
    sc = 1.0 / np.sqrt(24.0)

    def jf(q, k, v):
        with jax.named_scope("mla_mix"):
            return jattn.flash_attention(q, k, v, causal=True, scale=sc)

    def tf(q, k, v):
        with scope("mla_mix"):
            return tattn.flash_attention(q, k, v, causal=True, scale=sc)

    pol = ("mla_mix", "e8m3")
    a = np.asarray(jc.truncate(jf, jc.TruncationPolicy.scoped(*pol))(q, k, v))
    b = tc.truncate(tf, tc.TruncationPolicy.scoped(*pol))(
        *map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_array_equal(a, b)

    x, y, z = (r.randn(4096).astype(np.float32) for _ in range(3))
    fused = np.asarray(jax.jit(lambda x, y, z: x * y + z)(x, y, z))
    twice = (torch.from_numpy(x) * torch.from_numpy(y)
             + torch.from_numpy(z)).numpy()
    assert (fused != twice).any()
