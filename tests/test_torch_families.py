"""Every model family of the port against the reference package's, on the
same weights (carried over with ``params_from_jax``) and the same numpy
batch: the registry and the ten configurations, parameter shapes and counts
of the full configurations, M-RoPE and the elementary activations, and the
dense / M-RoPE families (glm4, deepseek-coder, internlm2, qwen2-vl) end to
end. The MoE, SSM and encoder-decoder families have files of their own
(``test_torch_moe.py``, ``test_torch_ssm.py``, ``test_torch_encdec.py``),
which share this file's helpers.

Tolerances, as ``tests/test_torch_model.py`` states them. Untruncated
logits and loss: ``rtol 1e-4, atol 1e-5`` (float32 in both, other summation
orders and other ``exp``/``sin``/``rsqrt``). Truncated loss: a relative
``2^-m`` of the format, the two packages rounding after the same ops (the
site lists are compared per scope) with one ulp before a rounding able to
move a value to the neighbouring grid point.

Site lists. Per scope, the primitives of the quantize sites are equal in
order, with one difference entered in ROADMAP Queue C: under every scope
that runs the blockwise attention (``.../mix``, ``.../mla_mix``,
``.../cross_attn``) the reference has one more site, a
``convert_element_type`` of the mask's ``NEG_INF`` constant that torch
never materialises.
"""
import dataclasses
from collections import defaultdict

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jc
from repro.configs import base as jbase
from repro.models import Model as JModel
from repro.models import common as jcommon

import repro_torch.core as tc
from repro_torch.configs import base as tbase
from repro_torch.models import Model
from repro_torch.models import common as tcommon
from repro_torch.models.common import map_defs
from repro_torch.models.convert import params_from_jax

# the block each family is profiled by in the scoped-policy checks
FAMILY_SCOPE = {
    "hymba-1.5b": "layer/mamba",
    "glm4-9b": "layer/attn/qkv",
    "deepseek-coder-33b": "layer/attn/qkv",
    "internlm2-20b": "layer/attn/qkv",
    "h2o-danube-1.8b": "layer/attn/qkv",
    "olmoe-1b-7b": "layer/moe/experts",
    "deepseek-v2-236b": "layer/attn/mla_mix",
    "rwkv6-7b": "layer/time_mix",
    "seamless-m4t-large-v2": "dec_layer/cross_attn",
    "qwen2-vl-7b": "layer/attn/qkv",
}
# scopes holding the blockwise attention's mask (the Queue C difference)
MASKED_SCOPES = ("mix", "mla_mix", "cross_attn")


def make_batch(cfg, B=2, S=32, seed=0):
    """The same batch for both packages: tokens, or frame / patch embeddings
    (with three different M-RoPE position streams) for the stub
    frontends."""
    r = np.random.RandomState(seed)
    toks = r.randint(0, cfg.vocab, (B, S + 1))
    nb = {"labels": toks[:, 1:].astype(np.int32)}
    if cfg.family == "encdec":
        # the reference's cross-attention chunking needs T_src == S
        nb["src_embeds"] = r.randn(B, S, cfg.d_model).astype(np.float32)
        nb["tokens"] = toks[:, :-1].astype(np.int32)
    elif cfg.input_mode == "embeds":
        nb["embeds"] = r.randn(B, S, cfg.d_model).astype(np.float32)
        s = np.arange(S)
        nb["positions"] = np.stack([np.broadcast_to(v, (B, S)) for v in (
            s, s // 4, (s * 7) % 5)]).astype(np.int32)
    else:
        nb["tokens"] = toks[:, :-1].astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in nb.items()})


def numpy_params(defs, seed=0):
    """Parameters drawn with numpy from a seed, as the definitions ask
    (normal with the def's scale, zeros, ones): one tree for both
    packages, faster than the reference's eager initialiser."""
    r = np.random.RandomState(seed)

    def draw(d):
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        return (r.randn(*d.shape) * d.scale).astype(np.float32)

    return map_defs(draw, defs)


_CACHE = {}


def setup(arch, B=2, S=32, **over):
    """(jax model, its params, its batch, port model, the same params carried
    over, the same batch) for ``arch``'s smoke config, cached."""
    key = (arch, B, S, tuple(sorted(over.items())))
    if key not in _CACHE:
        jcfg = jbase.get_config(arch, "smoke").replace(**over)
        tcfg = tbase.get_config(arch, "smoke").replace(**over)
        jm, tm = JModel(jcfg), Model(tcfg)
        tree = numpy_params(tm.param_defs())
        jp = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.dtype(jcfg.dtype)), tree)
        tp = params_from_jax(tree, tcfg, "cpu")
        jb, tb = make_batch(jcfg, B, S)
        _CACHE[key] = (jm, jp, jb, tm, tp, tb)
    return _CACHE[key]


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=1e-4, atol=1e-5)


def prims_by_scope(handle):
    out = defaultdict(list)
    for s in handle.sites:
        out[s.scope].append(s.prim)
    return out


def sweep_both(arch, fmt="e5m2", **over):
    jm, jp, jb, tm, tp, tb = setup(arch, **over)
    jh = jc.truncate_sweep(jm.loss, jc.TruncationPolicy.everywhere(fmt))(
        jp, jb)
    th = tc.truncate_sweep(tm.loss, tc.TruncationPolicy.everywhere(fmt))(
        tp, tb)
    return jh, th


def assert_same_sites(jh, th):
    """Per scope, the same primitives in the same order (bar the Queue C
    mask constant)."""
    js, ts = prims_by_scope(jh), prims_by_scope(th)
    assert set(js) == set(ts)
    for scope in js:
        want, got = list(js[scope]), ts[scope]
        if scope.split("/")[-1] in MASKED_SCOPES:
            assert len(want) == len(got) + 1, scope
            at = next((i for i, (a, b) in enumerate(zip(want, got))
                       if a != b), len(got))
            assert want.pop(at) == "convert_element_type", (scope, at)
        assert want == got, (scope, want, got)


def check_forward(arch, **over):
    jm, jp, jb, tm, tp, tb = setup(arch, **over)
    close(tm.forward(tp, tb), jax.jit(jm.forward)(jp, jb))
    close(tm.loss(tp, tb), jax.jit(jm.loss)(jp, jb))
    got = tm.prefill(tp, tb)
    assert got.shape == (2, jm.cfg.vocab)
    close(got, jax.jit(jm.prefill)(jp, jb))


def check_truncated(arch, policy_kind, fmt, m, **over):
    """Truncated loss within a relative 2^-m of the reference's, under an
    everywhere policy or one scoped to the family's own block; the swept
    table of the same policy gives the port's own truncate bit for bit."""
    jm, jp, jb, tm, tp, tb = setup(arch, **over)
    if policy_kind == "everywhere":
        jpol = jc.TruncationPolicy.everywhere(fmt)
        tpol = tc.TruncationPolicy.everywhere(fmt)
    else:
        jpol = jc.TruncationPolicy.scoped(FAMILY_SCOPE[arch], fmt)
        tpol = tc.TruncationPolicy.scoped(FAMILY_SCOPE[arch], fmt)
    want = float(jc.truncate(jm.loss, jpol)(jp, jb))
    got_t = tc.truncate(tm.loss, tpol)(tp, tb)
    got = float(got_t)
    assert np.isfinite(got)
    assert abs(got - want) <= 2.0 ** -m * abs(want), (got, want)
    h = tc.truncate_sweep(tm.loss, tc.TruncationPolicy.everywhere("e5m2"))(
        tp, tb)
    swept = h(h.table(tpol))
    assert swept.view(torch.int32) == got_t.view(torch.int32)
    if policy_kind == "scoped":                  # the scope did bite
        assert not torch.equal(tc.truncate(tm.forward, tpol)(tp, tb),
                               tm.forward(tp, tb))


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["smoke", "full"])
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_config_equals_the_reference_field_by_field(arch, variant):
    assert dataclasses.asdict(tbase.get_config(arch, variant)) == \
        dataclasses.asdict(jbase.get_config(arch, variant))


def test_registry_shapes_and_cells_equal_the_reference():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert set(tbase._MODULES) == set(jbase._MODULES) == set(jbase.ARCH_IDS)
    assert tbase.LONG_CONTEXT_ARCHS == jbase.LONG_CONTEXT_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for arch in jbase.ARCH_IDS:
        assert [(dataclasses.asdict(s), r) for s, r in tbase.cells(arch)] == \
            [(dataclasses.asdict(s), r) for s, r in jbase.cells(arch)]
    with pytest.raises(KeyError, match="unknown arch"):
        tbase.get_config("nope")
    with pytest.raises(ValueError, match="unknown variant"):
        tbase.get_config("glm4-9b", "tiny")


def _shapes(defs, path=""):
    """{path: shape} of a tree of ParamDef (reference or port)."""
    if isinstance(defs, dict):
        out = {}
        for k, v in defs.items():
            out.update(_shapes(v, f"{path}/{k}"))
        return out
    if isinstance(defs, (list, tuple)) and not hasattr(defs, "shape"):
        out = {}
        for i, v in enumerate(defs):
            out.update(_shapes(v, f"{path}[{i}]"))
        return out
    return {path: (tuple(defs.shape), tuple(defs.axes), defs.init,
                   defs.scale)}


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_full_param_defs_and_counts_equal_the_reference(arch):
    """Counted from the definitions, nothing allocated."""
    jm = JModel(jbase.get_config(arch))
    tm = Model(tbase.get_config(arch))
    assert _shapes(tm.param_defs()) == _shapes(jm.param_defs())
    assert tm.n_params() == jm.n_params()
    assert tm.n_active_params() == jm.n_active_params()


def test_headline_counts():
    olmoe = Model(tbase.get_config("olmoe-1b-7b"))
    assert olmoe.n_params() == 6919096320
    assert olmoe.n_active_params() == 1281951744
    cut = tbase.get_config("deepseek-v2-236b").replace(n_layers=2)
    assert Model(cut).n_params() == 5358679040


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

def test_mrope_three_different_streams():
    """Three different t/h/w streams (equal streams would reduce it to
    RoPE); the partial case keeps the tail of the head untouched."""
    r = np.random.RandomState(4)
    x = r.randn(2, 3, 12, 20).astype(np.float32)
    s = np.arange(12)
    pos = np.stack([np.broadcast_to(v, (2, 12)) for v in
                    (s, s // 3, (s * 5) % 7)]).astype(np.int32)
    for sections in [(2, 3, 3), (2, 3, 5)]:
        want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                   theta=1e4, sections=sections)
        got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                                  theta=1e4, sections=sections)
        close(got, want)
        rope = tcommon.apply_rope(torch.from_numpy(x),
                                  torch.from_numpy(pos[0]), theta=1e4,
                                  fraction=2 * sum(sections) / 20)
        assert not torch.allclose(got, rope)


@pytest.mark.parametrize("name", ["softplus", "softmax", "square", "relu",
                                  "sigmoid", "silu"])
def test_activations_match_and_run_the_reference_steps(name):
    """Values, and the primitives a policy sees (everywhere policy), equal
    the reference's ``jax.nn`` / ``jnp`` function's."""
    jf = {"softplus": jax.nn.softplus,
          "softmax": lambda v: jax.nn.softmax(v, axis=-1),
          "square": jnp.square, "relu": jax.nn.relu,
          "sigmoid": jax.nn.sigmoid, "silu": jax.nn.silu}[name]
    tf = {"softplus": tcommon.softplus,
          "softmax": lambda v: tcommon.softmax(v, dim=-1),
          "square": tcommon.square, "relu": tcommon.relu,
          "sigmoid": tcommon.sigmoid, "silu": tcommon.silu}[name]
    r = np.random.RandomState(5)
    x = (r.randn(3, 16) * 4).astype(np.float32)
    x[0, :3] = [0.0, 60.0, -60.0]
    close(tf(torch.from_numpy(x)), jf(jnp.asarray(x)))
    jh = jc.truncate_sweep(jf, jc.TruncationPolicy.everywhere("e5m2"))(
        jnp.asarray(x))
    th = tc.truncate_sweep(tf, tc.TruncationPolicy.everywhere("e5m2"),
                           device="cpu")(torch.from_numpy(x))
    assert [s.prim for s in th.sites] == [s.prim for s in jh.sites]


def test_layernorm_sites_share_the_jitted_variance():
    """Two layernorms under one scope: the reference traces ``jnp.var`` once
    (a jitted body both calls share) and each norm's own steps twice."""
    r = np.random.RandomState(6)
    x = r.randn(2, 5, 16).astype(np.float32)
    g, b = r.randn(16).astype(np.float32), r.randn(16).astype(np.float32)

    def jf(v):
        return jcommon.layernorm(jcommon.layernorm(v, g, b), g, b)

    def tf(v):
        from repro_torch.core.interpreter import loop_body
        y = tcommon.layernorm(v, torch.from_numpy(g), torch.from_numpy(b))
        with loop_body("second", once=True):
            return tcommon.layernorm(y, torch.from_numpy(g),
                                     torch.from_numpy(b))

    close(tf(torch.from_numpy(x)), jf(jnp.asarray(x)))
    jh = jc.truncate_sweep(jf, jc.TruncationPolicy.everywhere("e5m2"))(
        jnp.asarray(x))
    th = tc.truncate_sweep(tf, tc.TruncationPolicy.everywhere("e5m2"),
                           device="cpu")(torch.from_numpy(x))
    assert [s.prim for s in th.sites] == [s.prim for s in jh.sites]
    assert th.num_sites == 17 + 8


def test_decode_raises_naming_the_serving_slice():
    """Decode is ported (the serving slice, ``tests/test_torch_decode.py``);
    what still raises is a cache asked for on no device where there is no
    card, and a decode step given no cache."""
    for arch in ("olmoe-1b-7b", "seamless-m4t-large-v2"):
        m = Model(tbase.get_config(arch, "smoke"))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                m.init_cache(1, 8)
        with pytest.raises(TypeError):
            m.decode_step({}, None, None)
        cache = m.init_cache(1, 8, device="cpu")
        assert cache["pos"].tolist() == [0]


# --------------------------------------------------------------------------
# the dense and M-RoPE families end to end
# --------------------------------------------------------------------------

DENSE = ["glm4-9b", "deepseek-coder-33b", "internlm2-20b", "qwen2-vl-7b"]


@pytest.mark.parametrize("arch", DENSE)
def test_logits_loss_and_prefill(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_site_lists_per_scope(arch):
    assert_same_sites(*sweep_both(arch))


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen2-vl-7b"])
def test_bf16_site_lists_per_scope(arch):
    """In bf16 (the card's dtype) the casts to and from f32 are sites too:
    the same ones, in the same places."""
    assert_same_sites(*sweep_both(arch, dtype="bfloat16"))


@pytest.mark.parametrize("kind", ["everywhere", "scoped"])
@pytest.mark.parametrize("arch", DENSE)
def test_truncated_loss(arch, kind):
    check_truncated(arch, kind, "e5m7", 7)


def test_qwen2_vl_attention_uses_its_three_position_streams():
    """The attention block of qwen2-vl with weights large enough for the
    rotary phases to matter: equal to the reference's on three different
    streams, and moved when one stream's spacing moves (a constant shift
    would not: rotary scores see position differences only)."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jm, _, jb, tm, _, tb = setup("qwen2-vl-7b")
    r = np.random.RandomState(7)
    p = {k: (r.randn(*d.shape) * (0.15 if d.init != "zeros" else 0.1))
         .astype(np.float32)
         for k, d in jattn.gqa_param_defs(jm.cfg).items()}
    x = r.randn(2, 32, jm.cfg.d_model).astype(np.float32)

    def port(pos):
        y, _ = tattn.gqa_forward({k: torch.from_numpy(v) for k, v in p.items()},
                                 torch.from_numpy(x), tm.cfg, positions=pos)
        return y

    want, _ = jattn.gqa_forward({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), jm.cfg,
                                positions=jb["positions"])
    got = port(tb["positions"])
    close(got, want)
    moved = tb["positions"].clone()
    moved[2] *= 5000          # the w stream drives the slowest channels
    assert (port(moved) - got).abs().max() > 1e-2
    shifted = tb["positions"].clone()
    shifted[2] += 3
    torch.testing.assert_close(port(shifted), got, rtol=1e-4, atol=1e-4)
