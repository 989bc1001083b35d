"""The port's dense decoder against the reference package's, on the same
weights (carried over with ``params_from_jax``) and the same tokens.

Tolerances. Untruncated logits and loss: ``rtol 1e-4, atol 1e-5`` — float32
in both, but the matrix products sum in another order and ``exp`` / ``sin`` /
``cos`` / ``rsqrt`` are other implementations. Truncated loss: a relative
``2^-m`` of the rung — the two packages round after the same ops (the site
lists below are compared), but one ulp of difference before a rounding can
move a value to the neighbouring grid point.
"""
import json
import os
from collections import Counter

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jc
from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import get_config as jget_config
from repro.models import Model as JModel

import repro_torch.core as tc
from repro_torch.configs import ArchConfig, get_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
BENCH = dict(name="bench", family="dense", n_layers=4, d_model=128, n_heads=8,
             n_kv_heads=4, d_ff=512, vocab=512, dtype="float32", remat=False,
             scan_layers=False)


def configs(kind, **over):
    """The same configuration in both packages."""
    if kind == "smoke":
        return (jget_config("h2o-danube-1.8b", "smoke").replace(**over),
                get_config("h2o-danube-1.8b", "smoke").replace(**over))
    return JArchConfig(**{**BENCH, **over}), ArchConfig(**{**BENCH, **over})


_CACHE = {}


def setup(kind, B=2, S=32, **over):
    """(jax model, its params, its batch, port model, the same params carried
    over, the same batch), cached per configuration."""
    key = (kind, B, S, tuple(sorted(over.items())))
    if key not in _CACHE:
        jcfg, tcfg = configs(kind, **over)
        jm, tm = JModel(jcfg), Model(tcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             "cpu")
        toks = np.random.RandomState(0).randint(0, jcfg.vocab, (B, S + 1))
        jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
        tb = {"tokens": torch.from_numpy(toks[:, :-1]).to(torch.int32),
              "labels": torch.from_numpy(toks[:, 1:]).to(torch.int32)}
        _CACHE[key] = (jm, jp, jb, tm, tp, tb)
    return _CACHE[key]


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=1e-4, atol=1e-5)


CASES = [
    ("smoke", dict(S=32)),                       # S > window 16: window binds
    ("smoke", dict(S=8)),                        # S < window: it does not
    ("smoke", dict(S=32, scan_layers=False)),
    ("bench", dict(S=32)),
    ("bench", dict(S=32, scan_layers=True)),
    ("bench", dict(S=32, sliding_window=8)),
    ("bench", dict(S=32, qkv_bias=True, norm="layernorm", act="gelu",
                   rope_fraction=0.5, tie_embeddings=True)),
]
IDS = ["smoke-window-binds", "smoke-window-loose", "smoke-unrolled",
       "bench", "bench-scanned", "bench-window", "bench-bias-ln-gelu-tied"]


@pytest.mark.parametrize("kind,kw", CASES, ids=IDS)
def test_untruncated_logits_and_loss(kind, kw):
    jm, jp, jb, tm, tp, tb = setup(kind, **kw)
    close(tm.forward(tp, tb), jm.forward(jp, jb))
    close(tm.loss(tp, tb), jm.loss(jp, jb))


@pytest.mark.parametrize("kind", ["smoke", "bench"])
def test_last_only_prefill(kind):
    jm, jp, jb, tm, tp, tb = setup(kind)
    got = tm.prefill(tp, tb)
    assert got.shape == (2, jm.cfg.vocab)
    close(got, jm.prefill(jp, jb))
    close(got, tm.forward(tp, tb)[:, -1])


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.3])
def test_rope_partial_rotary(fraction):
    from repro.models import common as jcommon
    from repro_torch.models import common as tcommon
    r = np.random.RandomState(2)
    x = r.randn(2, 3, 16, 20).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e4,
                              fraction=fraction)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta=1e4, fraction=fraction)
    assert got.shape == (2, 3, 16, 20)
    close(got, want)


@pytest.mark.parametrize("name", ["swiglu", "gelu", "relu"])
def test_activations_and_norms(name):
    from repro.models import common as jcommon
    from repro_torch.models import common as tcommon
    r = np.random.RandomState(3)
    x = (r.randn(4, 7, 32) * 3).astype(np.float32)
    close(tcommon.ACTIVATIONS[name](torch.from_numpy(x)),
          jcommon.ACTIVATIONS[name](jnp.asarray(x)))
    g, b = r.randn(32).astype(np.float32), r.randn(32).astype(np.float32)
    close(tcommon.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), 1e-5),
          jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-5))
    close(tcommon.layernorm(torch.from_numpy(x), torch.from_numpy(g),
                            torch.from_numpy(b), 1e-5),
          jcommon.layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                            1e-5))


def test_masked_loss():
    jm, jp, jb, tm, tp, tb = setup("smoke")
    mask = (np.random.RandomState(1).rand(2, 32) > 0.3).astype(np.float32)
    close(tm.loss(tp, dict(tb, mask=torch.from_numpy(mask))),
          jm.loss(jp, dict(jb, mask=jnp.asarray(mask))))


@pytest.mark.parametrize("fmt,m", [("e8m10", 10), ("e8m7", 7), ("e5m7", 7)])
@pytest.mark.parametrize("kind,kw", [CASES[0], CASES[2], CASES[3]],
                         ids=[IDS[0], IDS[2], IDS[3]])
def test_truncated_loss_everywhere(kind, kw, fmt, m):
    jm, jp, jb, tm, tp, tb = setup(kind, **kw)
    want = float(jc.truncate(jm.loss, jc.TruncationPolicy.everywhere(fmt))(
        jp, jb))
    got = float(tc.truncate(tm.loss, tc.TruncationPolicy.everywhere(fmt))(
        tp, tb))
    assert np.isfinite(got)
    assert abs(got - want) <= 2.0 ** -m * abs(want), (got, want)
    # the table-driven twin gives the port's own truncate bit for bit
    h = tc.truncate_sweep(tm.loss, tc.TruncationPolicy.everywhere("e5m2"))(
        tp, tb)
    swept = h(h.table(tc.TruncationPolicy.everywhere(fmt)))
    assert swept.view(torch.int32) == torch.tensor(got).view(torch.int32)


def test_truncated_loss_committed_bench_policy():
    """The policy of ``artifacts/bench_model.json`` (e8m2 on 17 scopes of the
    unrolled bench model), loaded from the same JSON by both packages."""
    with open(os.path.join(ROOT, "artifacts", "bench_model.json")) as f:
        data = json.load(f)["policy"]
    jm, jp, jb, tm, tp, tb = setup("bench")
    want = float(jc.truncate(jm.loss, jc.TruncationPolicy.from_json(data))(
        jp, jb))
    base = float(tm.loss(tp, tb))
    got = float(tc.truncate(tm.loss, tc.TruncationPolicy.from_json(data))(
        tp, tb))
    assert got != base                       # the policy did bite
    assert abs(got - want) <= 2.0 ** -2 * abs(want), (got, want)


def site_counts(handle):
    return Counter(s.scope for s in handle.sites)


@pytest.mark.parametrize("kind,kw", [CASES[0], CASES[2], CASES[3]],
                         ids=[IDS[0], IDS[2], IDS[3]])
def test_scopes_with_sites_are_equal(kind, kw, capsys):
    """Same set of scopes holding quantize sites; counts side by side. The
    one expected difference is documented in the interpreter's docstring:
    the reference traces the NEG_INF constant of the attention mask as a
    float ``convert_element_type`` equation, torch has no such tensor."""
    jm, jp, jb, tm, tp, tb = setup(kind, **kw)
    jh = jc.truncate_sweep(jm.loss, jc.TruncationPolicy.everywhere("e5m2"))(
        jp, jb)
    th = tc.truncate_sweep(tm.loss, tc.TruncationPolicy.everywhere("e5m2"))(
        tp, tb)
    jcnt, tcnt = site_counts(jh), site_counts(th)
    with capsys.disabled():
        print(f"\n{'scope':40s} {'reference':>9s} {'port':>5s}")
        for k in sorted(set(jcnt) | set(tcnt)):
            print(f"{k:40s} {jcnt.get(k, 0):9d} {tcnt.get(k, 0):5d}")
    assert set(jcnt) == set(tcnt)
    for k in jcnt:
        if k.endswith("attn/mix"):
            assert jcnt[k] == tcnt[k] + 1, k
            jprims = [s.prim for s in jh.sites if s.scope == k]
            tprims = [s.prim for s in th.sites if s.scope == k]
            jprims.remove("convert_element_type")
            assert jprims == tprims
        else:
            assert jcnt[k] == tcnt[k], k
            assert [s.prim for s in jh.sites if s.scope == k] == \
                [s.prim for s in th.sites if s.scope == k], k


def test_scanned_layers_share_sites_unrolled_do_not():
    _, _, _, tm, tp, tb = setup("smoke")
    h = tc.truncate_sweep(tm.loss, tc.TruncationPolicy.everywhere("e5m2"))(
        tp, tb)
    _, _, _, tm2, tp2, tb2 = setup("smoke", scan_layers=False)
    h2 = tc.truncate_sweep(tm2.loss, tc.TruncationPolicy.everywhere("e5m2"))(
        tp2, tb2)
    per_layer = sum(1 for s in h.sites if s.scope.startswith("layer"))
    outside = h.num_sites - per_layer
    assert h2.num_sites == outside + 2 * per_layer
    assert {s.scope.split("/")[0] for s in h2.sites} >= {"layer0", "layer1"}
    # one row of the scanned table steers both layers
    p = tc.TruncationPolicy.scoped("layer/mlp", "e8m3")
    a = h(h.table(p))
    b = tc.truncate(tm.loss, p)(tp, tb)
    assert a.view(torch.int32) == b.view(torch.int32)
    assert a != tm.loss(tp, tb)


def test_params_carry_over_exactly_and_checked():
    jm, jp, _, tm, tp, _ = setup("smoke")
    assert tm.n_params() == jm.n_params() == sum(
        t.numel() for t in _leaves(tp))
    np.testing.assert_array_equal(tp["layers"]["attn"]["wq"].numpy(),
                                  np.asarray(jp["layers"]["attn"]["wq"]))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    bad = dict(tree, embed=tree["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(bad, tm.cfg, "cpu")
    with pytest.raises(ValueError, match="expected keys"):
        params_from_jax({k: v for k, v in tree.items() if k != "lm_head"},
                        tm.cfg, "cpu")
    # bf16 parameters arrive as an extension dtype numpy cannot hand to torch
    bf = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)), jp)
    tb16 = params_from_jax(bf, tm.cfg.replace(dtype="bfloat16"), "cpu")
    assert tb16["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tb16["embed"].float().numpy(),
        np.asarray(jnp.asarray(bf["embed"]).astype(jnp.float32)))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_seeded_init_and_config_registry():
    cfg = get_config("h2o-danube-1.8b", "smoke")
    m = Model(cfg)
    a, b = m.init(seed=3, device="cpu"), m.init(seed=3, device="cpu")
    c = m.init(seed=4, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["layers"]["mlp"]["wi"].shape == (2, 64, 320)
    assert torch.equal(a["final_norm"]["scale"], torch.ones(64))
    full = get_config("h2o-danube-1.8b")
    jfull = jget_config("h2o-danube-1.8b")
    assert Model(full).n_params() == JModel(jfull).n_params() == 1831201280
    assert {f: getattr(full, f) for f in full.__dataclass_fields__} == \
        {f: getattr(jfull, f) for f in jfull.__dataclass_fields__}
    assert get_config("glm4-9b").name == "glm4-9b"    # all ten registered
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("nope")
    with pytest.raises(ValueError, match="nope"):
        Model(cfg.replace(attn_type="nope")).param_defs()
    # decode (the serving slice) works: one step from an empty cache
    cache = m.init_cache(1, 8, device="cpu")
    logits, new = m.decode_step(a, cache, torch.tensor([5], dtype=torch.int32))
    assert logits.shape == (1, cfg.vocab) and int(new["pos"][0]) == 1
