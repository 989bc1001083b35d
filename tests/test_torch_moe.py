"""The MoE families (olmoe-1b-7b; deepseek-v2-236b with MLA, shared experts
and a leading dense layer) against the reference package's, on the same
weights and batch: logits, loss, site lists per scope, truncated losses
(tolerances and the one listed site difference as in
``test_torch_families.py``), and the router and dispatch exactly — expert
ids, ties, the capacity rule and which ``(token, k)`` slots are dropped."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jc
from repro.configs.base import get_config as jget
from repro.models import moe as jmoe

import repro_torch.core as tc
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax

from test_torch_families import (
    assert_same_sites, check_forward, check_truncated, close, numpy_params,
    setup, sweep_both,
)

ARCHS = ["olmoe-1b-7b", "deepseek-v2-236b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_prefill(arch):
    check_forward(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_site_lists_per_scope(arch, dtype):
    jh, th = sweep_both(arch, dtype=dtype)
    assert_same_sites(jh, th)
    scopes = {s.scope for s in th.sites}
    assert {"layer/moe/router", "layer/moe/experts",
            "layer/moe/combine"} <= scopes
    casts = ["convert_element_type"] * 2 if dtype == "bfloat16" else []
    assert [s.prim for s in th.sites if s.scope == "layer/moe/router"] == \
        casts + ["dot_general", "sub", "exp", "reduce_sum", "div", "top_k"]
    if arch == "deepseek-v2-236b":
        assert {"layer/moe/shared", "layer/attn/mla_qkv/rmsnorm",
                "lead_layer0/mlp"} <= scopes


@pytest.mark.parametrize("scope,fmt,m", [
    (None, "e5m7", 7), ("layer/moe/experts", "e5m7", 7),
    ("layer/moe/router", "e8m3", 3)])
@pytest.mark.parametrize("arch", ARCHS)
def test_truncated_loss(arch, scope, fmt, m):
    if scope is None:
        check_truncated(arch, "everywhere", fmt, m)
        return
    jm, jp, jb, tm, tp, tb = setup(arch)
    want = float(jc.truncate(jm.loss, jc.TruncationPolicy.scoped(scope, fmt))(
        jp, jb))
    got = float(tc.truncate(tm.loss, tc.TruncationPolicy.scoped(scope, fmt))(
        tp, tb))
    assert abs(got - want) <= 2.0 ** -m * abs(want), (got, want)


def test_mla_scoped_truncation():
    check_truncated("deepseek-v2-236b", "scoped", "e5m7", 7)


# --------------------------------------------------------------------------
# router and dispatch, exactly
# --------------------------------------------------------------------------

def test_top_k_ties_go_to_the_lower_index():
    """The example ``torch.topk`` orders differently from ``lax.top_k``."""
    probs = np.array([[.5, .25, .25, .5, .25, .5, .1, .5]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = tmoe.top_k(torch.from_numpy(probs), 3)
    assert ti.tolist() == np.asarray(ji).tolist() == [[0, 3, 5]]
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _router_case(tie: bool, T=64, seed=1):
    """A router and inputs for the olmoe smoke config; ``tie`` copies three
    experts' router columns onto others, so their probabilities are equal
    bit for bit."""
    cfg = get_config("olmoe-1b-7b", "smoke")
    r = np.random.RandomState(seed)
    p = numpy_params(tmoe.moe_param_defs(cfg), seed)
    p["router"] = (r.randn(*p["router"].shape) * 0.5).astype(np.float32)
    if tie:
        p["router"][:, 5] = p["router"][:, 1]
        p["router"][:, 6] = p["router"][:, 2]
        p["router"][:, 7] = p["router"][:, 0]
    x = r.randn(T, cfg.d_model).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("tie", [False, True], ids=["random", "forced-tie"])
def test_expert_ids_and_gates_equal_the_reference(tie):
    cfg, p, x = _router_case(tie)
    jids, jg = jmoe._routing({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jget("olmoe-1b-7b", "smoke").moe)
    tids, tg = tmoe._routing({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), cfg.moe)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    close(tg, jg)
    if tie:   # the ties were there, and were broken the reference's way
        assert np.any(np.asarray(jids) >= 5)


def test_truncated_router_ties_equal_the_reference():
    """Router probabilities rounded to 3 mantissa bits tie often; the ids
    of the truncated routing are the reference's, tie for tie."""
    cfg, p, x = _router_case(False, T=256)
    jcfg = jget("olmoe-1b-7b", "smoke")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    pol = "e8m3"
    jids, _ = jc.truncate(lambda v: jmoe._routing(jp, v, jcfg.moe),
                          jc.TruncationPolicy.everywhere(pol))(jnp.asarray(x))
    tids, _ = tc.truncate(lambda v: tmoe._routing(tp, v, cfg.moe),
                          tc.TruncationPolicy.everywhere(pol))(
        torch.from_numpy(x))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    # ties did occur among the chosen probabilities
    probs = tc.truncate(
        lambda v: tmoe.common.softmax(v @ tp["router"], dim=-1),
        tc.TruncationPolicy.everywhere(pol))(torch.from_numpy(x))
    top = torch.sort(probs, dim=-1, descending=True).values[:, :3]
    assert bool((top[:, 1:] == top[:, :-1]).any())


def _reference_drop_rule(ids: np.ndarray, E: int, C: int):
    """Which (token, k) slot lands where, from the reference's rule written
    out in numpy: stable sort by expert, position within the expert, drop
    past the capacity."""
    T, K = ids.shape
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=E)
    offsets = np.cumsum(counts) - counts
    pos = np.arange(T * K) - offsets[flat[order]]
    dest = np.where(pos < C, flat[order] * C + pos, E * C)
    slot_of = np.full(T * K, E * C)
    slot_of[order] = dest
    slot_tok = np.full(E * C, T)
    kept = dest < E * C
    slot_tok[dest[kept]] = np.repeat(np.arange(T), K)[order][kept]
    return slot_tok, slot_of


@pytest.mark.parametrize("tie", [False, True], ids=["random", "forced-tie"])
def test_drop_pattern_equals_the_reference(tie):
    """A capacity that binds: the same slots dropped, the same expert slot
    for every kept one, and the layer's output equal to the reference's."""
    cfg, p, x = _router_case(tie, T=64)
    jcfg = jget("olmoe-1b-7b", "smoke")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ids, _ = tmoe._routing(tp, torch.from_numpy(x), cfg.moe)
    E, C = cfg.moe.n_experts, 8                  # 64*2/8 = 16 a expert
    slot_tok, slot_of = tmoe.dispatch_plan(ids, E, C)
    want_tok, want_of = _reference_drop_rule(ids.numpy(), E, C)
    np.testing.assert_array_equal(slot_of.numpy(), want_of)
    np.testing.assert_array_equal(slot_tok.numpy(), want_tok)
    assert (want_of == E * C).sum() > 0          # some slots were dropped
    xb = x.reshape(2, 32, -1)
    want = jmoe.moe_forward({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(xb), jcfg, capacity=C)
    got = tmoe.moe_forward(tp, torch.from_numpy(xb), cfg, capacity=C)
    close(got, want)


@pytest.mark.parametrize("T", [1, 7, 64, 4096])
def test_capacity_rule(T):
    for arch in ("olmoe-1b-7b", "deepseek-v2-236b"):
        cfg = get_config(arch)
        mc = cfg.moe
        want = max(8, -(-int(np.ceil(T * mc.top_k / mc.n_experts
                                     * mc.capacity_factor)) // 8) * 8)
        assert tmoe.capacity_of(cfg, T) == want
    assert tmoe.capacity_of(get_config("olmoe-1b-7b"), 4096) == 640


def test_aux_load_balance_loss():
    cfg, p, x = _router_case(True)
    jcfg = jget("olmoe-1b-7b", "smoke")
    xb = x.reshape(2, 32, -1)
    want = jmoe.aux_load_balance_loss({k: jnp.asarray(v) for k, v in p.items()},
                                      jnp.asarray(xb), jcfg)
    got = tmoe.aux_load_balance_loss(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(xb),
        cfg)
    close(got, want)


# --------------------------------------------------------------------------
# params_from_jax on a tree with a list of lead layers
# --------------------------------------------------------------------------

def test_params_from_jax_lead_layer_list():
    jm, jp, _, tm, tp, _ = setup("deepseek-v2-236b")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    assert isinstance(tp["lead_layers"], list) and len(tp["lead_layers"]) == 1
    np.testing.assert_array_equal(
        tp["lead_layers"][0]["mlp"]["wi"].numpy(),
        tree["lead_layers"][0]["mlp"]["wi"])
    assert tm.n_params() == sum(
        t.numel() for t in jax.tree_util.tree_leaves(
            tp, is_leaf=lambda v: isinstance(v, torch.Tensor)))
    lead = dict(tree["lead_layers"][0])
    bad = dict(tree, lead_layers=[{k: v for k, v in lead.items()
                                   if k != "mlp"}])
    with pytest.raises(ValueError, match=r"lead_layers\[0\].*expected keys"):
        params_from_jax(bad, tm.cfg, "cpu")
    bad = dict(tree, lead_layers=[dict(lead, extra=lead["norm1"])])
    with pytest.raises(ValueError, match="expected keys"):
        params_from_jax(bad, tm.cfg, "cpu")
    bad = dict(tree, lead_layers=[lead, lead])
    with pytest.raises(ValueError, match="list of 1"):
        params_from_jax(bad, tm.cfg, "cpu")
    bad = dict(tree, lead_layers=lead)
    with pytest.raises(ValueError, match="list of 1"):
        params_from_jax(bad, tm.cfg, "cpu")
    moe = dict(tree["layers"]["moe"], wi=tree["layers"]["moe"]["wi"][:, :-1])
    bad = dict(tree, layers=dict(tree["layers"], moe=moe))
    with pytest.raises(ValueError, match="layers/moe/wi"):
        params_from_jax(bad, tm.cfg, "cpu")
