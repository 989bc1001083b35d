"""The state-space families (hymba-1.5b: parallel attention + Mamba heads
with unrolled global-attention layers; rwkv6-7b: time-mix + channel-mix)
against the reference package's, on the same weights and batch: logits,
loss, site lists per scope, truncated losses (tolerances and the one listed
site difference as in ``test_torch_families.py``), how hymba's execution
plan shares sites, and trajectory steps."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro.core as jc

import repro_torch.core as tc
from repro_torch.models import common as tcommon

from test_torch_families import (
    assert_same_sites, check_forward, check_truncated, prims_by_scope, setup,
    sweep_both,
)

ARCHS = ["hymba-1.5b", "rwkv6-7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_prefill(arch):
    check_forward(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_site_lists_per_scope(arch, dtype):
    jh, th = sweep_both(arch, dtype=dtype)
    assert_same_sites(jh, th)
    # the recurrence is plain tensor code, as in the reference's model: no
    # fused kernel anywhere on the path
    assert "pallas_call" not in {s.prim for s in th.sites}


@pytest.mark.parametrize("kind", ["everywhere", "scoped"])
@pytest.mark.parametrize("arch", ARCHS)
def test_truncated_loss(arch, kind):
    check_truncated(arch, kind, "e5m7", 7)


HYMBA_7 = dict(n_layers=7, global_layers=(0, 3, 6))


@pytest.mark.parametrize("remat", [True, False])
def test_hymba_plan_shares_sites_as_the_reference(remat):
    """Global 0, scan 1-2, global 3, scan 4-5, global 6. The two scan
    segments share one body in both packages; the three global layers
    share one under ``remat`` (the reference re-uses its one traced
    checkpoint body) and have three without."""
    jh, th = sweep_both("hymba-1.5b", remat=remat, **HYMBA_7)
    assert_same_sites(jh, th)
    per_global = len(prims_by_scope(th)["global_layer/attn/qkv"])
    per_layer = len(prims_by_scope(th)["layer/attn/qkv"])
    assert per_global == per_layer * (1 if remat else 3)


def _steps(arch, **over):
    """Steps seen by both packages' ``profile_trajectory`` of the loss. The
    count does not depend on the policy; one scoped to the logits keeps the
    reference's mem-mode program small."""
    jm, jp, jb, tm, tp, tb = setup(arch, **over)
    jt = jc.profile_trajectory(jm.loss, jc.TruncationPolicy.scoped(
        "logits", "e5m7"), threshold=1e-3, n_steps=16)(jp, jb)[1]
    tt = tc.profile_trajectory(tm.loss, tc.TruncationPolicy.scoped(
        "logits", "e5m7"), threshold=1e-3, n_steps=16)(tp, tb)[1]
    return int(np.asarray(jt.steps_seen)), int(tt.steps_seen)


@pytest.mark.parametrize("over", [{}, HYMBA_7], ids=["smoke", "7-layers"])
def test_hymba_trajectory_steps_equal_the_reference(over):
    """A step is one trip of a depth-0 loop: each scanned layer, and inside
    an unrolled global layer each attention q chunk and each Mamba chunk
    (S = 32: one of each)."""
    cfg = setup("hymba-1.5b", **over)[3].cfg
    want = (cfg.n_layers - len(cfg.global_layers)) + 2 * len(
        cfg.global_layers)
    assert _steps("hymba-1.5b", **over) == (want, want)


def test_rwkv6_trajectory_steps_are_its_layers():
    assert _steps("rwkv6-7b") == (2, 2)


def test_softplus_of_extremes():
    """``atol`` 1e-37: XLA's CPU code flushes the subnormal softplus(-100)
    to zero, PyTorch keeps it (ROADMAP Queue C, ``deviation`` of a
    subnormal lane)."""
    x = np.array([-100.0, -20.0, -1e-3, 0.0, 1e-3, 20.0, 100.0, np.inf,
                  -np.inf, np.nan], np.float32)
    got = tcommon.softplus(torch.from_numpy(x)).numpy()
    import jax
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-37)
    assert np.isnan(got[-1]) and got[-3] == np.inf
