"""The decode half of every model family (``Model.init_cache``,
``Model.decode_step``: GQA with ring caches, M-RoPE, MLA in the absorbed
form, Mamba's and RWKV-6's carried state, the encoder-decoder's
self-attention cache against a fixed cross-attention memory) against the
reference package's, on the ten smoke configurations, in float32, with the
reference's parameters carried over by ``params_from_jax`` (the helpers of
``test_torch_families.py``).

Tolerances. Decode logits and caches against the reference's over eight
steps: ``rtol 1e-4, atol 1e-5`` (float32 in both, other summation orders,
as the forward's). Decode logits against the parallel forward: the
reference's own ``2e-2`` (``tests/test_arch_smoke.py``). Truncated decode
logits: within ``2^-m`` of the largest logit, the two packages rounding
after the same operations (the site lists are compared per scope) with one
ulp before a rounding able to move a value to the neighbouring grid point.

Site lists. The decode step opens the reference's scopes, which are not the
forward's: no ``attn/...`` under a layer, no ``mamba``, no ``self_attn`` in
the decoder and no ``logits`` for the encoder-decoder. Per scope the
primitives are the reference's in order, but for the listed mask constant
(ROADMAP Queue C): where a decode mask runs, the reference may have
``convert_element_type`` sites of the ``NEG_INF`` constant that torch never
materialises.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jc
from repro.configs import base as jbase
from repro.models import encdec as jed

import repro_torch.core as tc
from repro_torch.configs import base as tbase
from repro_torch.models import Model
from repro_torch.models import encdec as ted

from test_torch_families import prims_by_scope, setup

ARCHS = jbase.ARCH_IDS
B, T = 2, 8
EXTRA = 4                 # cache room past T: the ragged lane starts at 3
# scopes where a decode mask runs (attention of a layer, the decoder's
# self-attention and its cross-attention)
MASK_SCOPES = ("layer", "lead_layer0", "dec_layer", "dec_layer/cross_attn")


def leaves(tree, path=""):
    """{path: leaf} of a nested dict / list of jax arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{path}[{i}]"))
        return out
    return {path: tree}


def as_numpy(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def caches(arch, seq_len, memory=None):
    """An empty cache of both packages; for the encoder-decoder the cross
    K/V are ``memory`` (numpy), the same in both."""
    jm, tm = setup(arch, B=B, S=T)[0], setup(arch, B=B, S=T)[3]
    if jm.cfg.family == "encdec":
        mlen = T if memory is None else memory[0].shape[3]
        jcache = jed.init_cache(jm.cfg, B, seq_len, memory_len=mlen)
        tcache = ted.init_cache(tm.cfg, B, seq_len, memory_len=mlen,
                                device="cpu")
        if memory is not None:
            for key, arr in zip(("cross_k", "cross_v"), memory):
                jcache[key] = jnp.asarray(arr)
                tcache[key] = torch.from_numpy(arr)
        return jcache, tcache
    return jm.init_cache(B, seq_len), tm.init_cache(B, seq_len, device="cpu")


def random_memory(cfg, seed=5):
    r = np.random.RandomState(seed)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, T, cfg.resolved_head_dim)
    return tuple(r.randn(*shape).astype(np.float32) for _ in range(2))


def step_inputs(cfg, tb, t):
    """(tokens, embeds) of decode step ``t`` for the port; embeds for the
    stub-frontend VLM, tokens otherwise."""
    if cfg.input_mode == "embeds":
        return torch.zeros(B, dtype=torch.int32), tb["embeds"][:, t:t + 1]
    return tb["tokens"][:, t], None


_RUNS = {}


def decode_both(arch):
    """Eight decode steps of both packages from one cache whose two lanes
    sit at cursors 0 and 3 (ragged), the port's input cache cloned before
    every step: (reference logits, port logits, final caches, whether every
    input cache came back unchanged)."""
    if arch in _RUNS:
        return _RUNS[arch]
    jm, jp, jb, tm, tp, tb = setup(arch, B=B, S=T)
    cfg = tm.cfg
    mem = random_memory(cfg) if cfg.family == "encdec" else None
    jcache, tcache = caches(arch, T + EXTRA, mem)
    start = np.array([0, 3], np.int32)
    jcache["pos"] = jnp.asarray(start)
    tcache["pos"] = torch.from_numpy(start.copy())
    jl, tl, unchanged = [], [], True
    step = jax.jit(jm.decode_step)
    for t in range(T):
        tok, emb = step_inputs(cfg, tb, t)
        kw = {} if emb is None else {"embeds": jnp.asarray(emb.numpy())}
        lg, jcache = step(jp, jcache, jnp.asarray(tok.numpy()), **kw)
        jl.append(np.asarray(lg))
        before = {k: v.clone() for k, v in leaves(tcache).items()}
        lg, new = tm.decode_step(tp, tcache, tok, embeds=emb)
        unchanged &= all(torch.equal(before[k], v)
                         for k, v in leaves(tcache).items())
        tl.append(lg.numpy())
        tcache = new
    _RUNS[arch] = (jl, tl, jcache, tcache, unchanged)
    return _RUNS[arch]


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_tree_shapes_and_dtypes_equal_the_reference(arch):
    jcache, tcache = caches(arch, 12)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            leaves(jcache).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in leaves(tcache).items()}
    assert got == want
    assert all(not bool(v.any()) for v in leaves(tcache).values())


def test_ring_and_global_caches_are_laid_out_as_the_reference():
    """Sliding-window layers get window-sized rings, hymba's global layers
    full-length caches in ``global``, deepseek-v2's lead layer in
    ``lead``."""
    hymba = setup("hymba-1.5b", B=B, S=T)[3]
    hy, cfg = hymba.init_cache(1, 40, device="cpu"), hymba.cfg
    assert hy["layers"]["kv"]["k"].shape[3] == cfg.sliding_window
    assert [g["kv"]["k"].shape[2] for g in hy["global"]] == [40, 40]
    ds = setup("deepseek-v2-236b", B=B, S=T)[3].init_cache(1, 40,
                                                           device="cpu")
    assert len(ds["lead"]) == 1 and ds["lead"][0]["c_kv"].shape[1] == 40


def test_init_cache_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default device exists")
    m = Model(tbase.get_config("glm4-9b", "smoke"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(tbase.get_config("seamless-m4t-large-v2", "smoke")).init_cache(
            1, 8, device=None)


# --------------------------------------------------------------------------
# decode against the reference and against the forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_and_cache_equal_the_reference(arch):
    """Eight steps with ragged (B,) cursors: logits at every step and the
    final cache, leaf by leaf."""
    jl, tl, jcache, tcache, _ = decode_both(arch)
    for t, (j, p) in enumerate(zip(jl, tl)):
        np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{arch} step {t}")
    want, got = leaves(jcache), leaves(tcache)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(as_numpy(got[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tcache["pos"].numpy(), [T, 3 + T])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_leaves_its_input_cache_unchanged(arch):
    assert decode_both(arch)[4]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_the_parallel_forward(arch):
    """Greedy decode logits at each position == the parallel forward's,
    within the reference's 2e-2; the encoder-decoder's cross K/V are
    computed from its encoder, as the reference's test builds them."""
    _, _, _, tm, tp, tb = setup(arch, B=B, S=T)
    cfg = tm.cfg
    batch = {k: v for k, v in tb.items() if k not in ("labels", "positions")}
    full = tm.forward(tp, batch)
    if cfg.family == "encdec":
        memory = ted.encode(tp, batch["src_embeds"], cfg)
        hd = cfg.resolved_head_dim
        w = tp["dec_layers"]["cross_attn"]
        kv = [torch.stack([(memory @ w[n][i]).reshape(
            B, T, cfg.n_kv_heads, hd).permute(0, 2, 1, 3)
            for i in range(cfg.n_layers)]) for n in ("wk", "wv")]
        cache = ted.init_cache(cfg, B, T + 1, memory_len=T, device="cpu")
        cache["cross_k"], cache["cross_v"] = kv
    else:
        cache = tm.init_cache(B, T + 1, device="cpu")
    maxdiff = 0.0
    for t in range(T):
        tok, emb = step_inputs(cfg, tb, t)
        logits, cache = tm.decode_step(tp, cache, tok, embeds=emb)
        maxdiff = max(maxdiff, float((logits - full[:, t]).abs().max()))
    assert maxdiff < 2e-2, (arch, maxdiff)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "hymba-1.5b"])
def test_ring_cache_wraps_past_the_window(arch):
    """A window of 8 decoded for 20 steps: the ring caches (8 slots; hymba's
    global layers keep full caches) against the windowed parallel forward
    at every position, and against the reference's ring decode."""
    W, n = 8, 20
    jm, jp, jb, tm, tp, tb = setup(arch, B=B, S=n, sliding_window=W)
    cache = tm.init_cache(B, n, device="cpu")
    jcache = jm.init_cache(B, n)
    ring = [v for k, v in leaves(cache["layers"]).items() if k.endswith("/k")]
    assert [t.shape[3] for t in ring] == [W]
    full = tm.forward(tp, {"tokens": tb["tokens"]})
    step = jax.jit(jm.decode_step)
    for t in range(n):
        tok = tb["tokens"][:, t]
        logits, cache = tm.decode_step(tp, cache, tok)
        jlogits, jcache = step(jp, jcache, jnp.asarray(tok.numpy()))
        assert float((logits - full[:, t]).abs().max()) < 2e-2, t
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-5, err_msg=str(t))


def test_dead_lane_past_the_end_writes_nothing():
    """A non-ring cursor at the cache's end writes no slot (the engine's
    finished lanes); the other lane writes exactly its own slot."""
    tm, tp, tb = setup("glm4-9b", B=B, S=T)[3:]
    cache = tm.init_cache(B, 4, device="cpu")
    r = np.random.RandomState(0)
    for leaf in leaves(cache["layers"]).values():
        leaf.copy_(torch.from_numpy(r.randn(*leaf.shape).astype(np.float32)))
    cache["pos"] = torch.tensor([4, 1], dtype=torch.int32)
    _, new = tm.decode_step(tp, cache, tb["tokens"][:, 0])
    for name in ("k", "v"):
        old, got = cache["layers"][name], new["layers"][name]
        assert torch.equal(got[:, 0], old[:, 0])           # dead lane
        written = (got[:, 1] != old[:, 1]).any(dim=(0, 1, 3))
        assert written.tolist() == [False, True, False, False]
    np.testing.assert_array_equal(new["pos"].numpy(), [5, 2])


# --------------------------------------------------------------------------
# profiling the decode step
# --------------------------------------------------------------------------

def sweep_decode(arch, fmt="e5m2"):
    jm, jp, jb, tm, tp, tb = setup(arch, B=B, S=T)
    mem = random_memory(tm.cfg) if tm.cfg.family == "encdec" else None
    jcache, tcache = caches(arch, T + 1, mem)
    tok, emb = step_inputs(tm.cfg, tb, 0)
    kw = {} if emb is None else {"embeds": emb}
    jkw = {} if emb is None else {"embeds": jnp.asarray(emb.numpy())}
    jh = jc.truncate_sweep(jm.decode_step, jc.TruncationPolicy.everywhere(
        fmt))(jp, jcache, jnp.asarray(tok.numpy()), **jkw)
    th = tc.truncate_sweep(tm.decode_step, tc.TruncationPolicy.everywhere(
        fmt))(tp, tcache, tok, **kw)
    return jh, th


def assert_same_decode_sites(jh, th):
    """Per scope, the reference's primitives in order, but for mask
    constants (``convert_element_type``) the port does not have, in the
    scopes a decode mask runs in."""
    js, ts = prims_by_scope(jh), prims_by_scope(th)
    assert set(js) == set(ts), (sorted(js), sorted(ts))
    for scope in js:
        want, got = js[scope], ts[scope]
        i = j = skipped = 0
        while i < len(want):
            if j < len(got) and want[i] == got[j]:
                i, j = i + 1, j + 1
            elif want[i] == "convert_element_type" and scope in MASK_SCOPES:
                i, skipped = i + 1, skipped + 1
            else:
                raise AssertionError((scope, i, want, got))
        assert j == len(got), (scope, want, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_sites_per_scope_equal_the_reference(arch):
    jh, th = sweep_decode(arch)
    assert_same_decode_sites(jh, th)
    scopes = set(prims_by_scope(th))
    # the decode paths open no scope of the forward's attention or SSM
    assert not any("/attn" in s or s.endswith("mamba")
                   or "self_attn" in s for s in scopes), scopes
    if setup(arch, B=B, S=T)[3].cfg.family == "encdec":
        assert "logits" not in scopes and "dec_layer/cross_attn" in scopes
    else:
        assert "final_norm/rmsnorm" in scopes or \
            "final_norm/layernorm" in scopes
        assert "logits" in scopes


def test_a_policy_on_attention_scopes_matches_nothing_at_decode():
    _, _, _, tm, tp, tb = setup("glm4-9b", B=B, S=T)
    cache = tm.init_cache(B, T, device="cpu")
    h = tc.truncate_sweep(tm.decode_step, tc.TruncationPolicy.scoped(
        "**/attn/**", "e5m2"))(tp, cache, tb["tokens"][:, 0])
    assert h.num_sites == 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind,fmt,m", [("everywhere", "e8m7", 7),
                                        ("scoped", "e5m4", 4)])
def test_truncated_decode_logits_equal_the_reference(arch, kind, fmt, m):
    """Two truncated decode steps from an empty cache, every float result
    (or the MLP / MoE / channel-mix blocks) rounded."""
    jm, jp, jb, tm, tp, tb = setup(arch, B=B, S=T)
    if kind == "everywhere":
        jpol, tpol = (jc.TruncationPolicy.everywhere(fmt),
                      tc.TruncationPolicy.everywhere(fmt))
    else:
        scopes = ("**/mlp", "**/moe", "**/channel_mix")
        jpol = jc.TruncationPolicy(rules=tuple(
            jc.TruncationRule(fmt, scope=s) for s in scopes))
        tpol = tc.TruncationPolicy(rules=tuple(
            tc.TruncationRule(fmt, scope=s) for s in scopes))
    mem = random_memory(tm.cfg) if tm.cfg.family == "encdec" else None
    jcache, tcache = caches(arch, T, mem)
    jstep = jc.truncate(jm.decode_step, jpol)
    tstep = tc.truncate(tm.decode_step, tpol)
    for t in range(2):
        tok, emb = step_inputs(tm.cfg, tb, t)
        jkw = {} if emb is None else {"embeds": jnp.asarray(emb.numpy())}
        want, jcache = jstep(jp, jcache, jnp.asarray(tok.numpy()), **jkw)
        got, tcache = tstep(tp, tcache, tok, embeds=emb)
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all()
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 2.0 ** -m * float(np.abs(want).max()), (arch, t, err)
    assert tstep.n_traces == 1
