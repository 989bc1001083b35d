"""The port's truncation policies against the reference package's: the same
scope grammar, the same rule decisions, the same JSON."""
import itertools
import json
import os

import pytest

import jax.numpy as jnp
import torch

import repro.core as jc
from repro.core import policy as jpolicy

import repro_torch.core as tc
from repro_torch.core import policy as tpolicy

ROOT = os.path.join(os.path.dirname(__file__), "..")

STACKS = [
    "", "layer", "layer/mlp", "layer/attn/qkv", "layer/attn/mix",
    "layer/attn/mix/bhgqd,bhkd->bhgqk", "layer0/mlp", "layer12/attn/proj",
    "layer/pre_norm/rmsnorm", "logits", "loss", "model/block/mlp/act",
    "transpose(jvp(layer))/mlp", "checkpoint/rematted_computation/mlp",
    "vmap(jvp(layer))/attn/qkv", "mlpx", "a/mlp/b",
]
PRIMS = ["dot_general", "add", "mul", "exp", "rsqrt", "reshape", "max",
         "select_n", "convert_element_type", "reduce_sum", "reduce_max",
         "logistic", "iota"]
DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16),
          ("float16", jnp.float16, torch.float16),
          ("float64", jnp.float64, torch.float64),
          ("int32", jnp.int32, torch.int32),
          ("bool", jnp.bool_, torch.bool)]


def _policies(mod):
    P, R = mod.TruncationPolicy, mod.TruncationRule
    return {
        "everywhere": P.everywhere("e5m7"),
        "scoped_mlp": P.scoped("layer/mlp", "e5m7"),
        "glob_star": P.scoped("layer*/attn/*", "e8m3"),
        "glob_dstar": P.scoped("**/mlp", "e4m3"),
        "glob_q": P.scoped("layer?/mlp", "e5m2"),
        "ops_only": P.everywhere("e5m2", ops=("dot_general", "add")),
        "exclude_ops": P.everywhere("e8m5", exclude_ops=("exp", "rsqrt")),
        "excluding": P.everywhere("e5m7").excluding("layer/attn", "loss"),
        "flag": P.from_flag("64_to_5_14;32_to_3_8"),
        "flag16": P.from_flag("16_to_4_3"),
        "first_wins": P(rules=(R(fmt="e4m3", scope="layer/mlp"),
                               R(fmt="e8m10", scope="layer"),
                               R(fmt="bf16"))),
        "dot_inputs": P.scoped("layer", "e4m3", quantize_dot_inputs=True),
        "empty": P(rules=()),
    }


JP, TP = _policies(jc), _policies(tc)


@pytest.mark.parametrize("pattern,stack,want", [
    ("layer/attn", "layer/attn/qkv/dot", True),
    ("layer/attn", "layer/attnx", False),
    ("**/mlp", "mlp", True),
    ("**/mlp", "a/b/mlp/c", True),
    ("*/mlp", "a/b/mlp", False),
    ("layer?/mlp", "layer1/mlp", True),
    ("layer?/mlp", "layer12/mlp", False),
    ("layer*", "layer12/mlp", True),
    ("**", "", True),
    ("a.b", "axb", False),
])
def test_scope_globbing(pattern, stack, want):
    assert tpolicy.scope_matches(tpolicy.compile_scope(pattern), stack) is want
    assert jpolicy.scope_matches(jpolicy.compile_scope(pattern), stack) is want
    assert tpolicy._translate(pattern) == jpolicy._translate(pattern)


@pytest.mark.parametrize("stack,want", [
    ("transpose(jvp(cell))/dot", "cell/dot"),
    ("jvp(mlp)", "mlp"),
    ("checkpoint/rematted_computation/mlp", "mlp"),
    ("vmap(jvp(a))/b", "a/b"),
    ("layer/attn/qkv", "layer/attn/qkv"),
    ("", ""),
])
def test_normalize_stack_reference_examples(stack, want):
    assert tpolicy.normalize_stack(stack) == want
    assert jpolicy.normalize_stack(stack) == want


def test_join_stack():
    for a, b in itertools.product(("", "x", "x/y"), ("", "z", "z/w")):
        assert tpolicy.join_stack(a, b) == jpolicy.join_stack(a, b)


@pytest.mark.parametrize("name", sorted(JP))
def test_rule_for_agrees_with_reference(name):
    """Same decision on a grid of (stack, primitive, dtype): whether a rule
    matches, and which one (by its format, scope and flags)."""
    jp, tp = JP[name], TP[name]
    for stack, prim, (_, jdt, tdt) in itertools.product(STACKS, PRIMS, DTYPES):
        jr = jp.rule_for(stack, prim, jnp.dtype(jdt))
        tr = tp.rule_for(stack, prim, tdt)
        assert (jr is None) == (tr is None), (stack, prim, tdt)
        if jr is not None:
            assert jr.to_json() == tr.to_json(), (stack, prim, tdt)


@pytest.mark.parametrize("name", sorted(JP))
def test_to_json_equals_reference(name):
    assert TP[name].to_json() == JP[name].to_json()
    again = tc.TruncationPolicy.from_json(
        json.loads(json.dumps(TP[name].to_json())))
    assert again == TP[name]
    assert again.cache_key() == TP[name].cache_key()
    # each package loads the other's JSON into an equal policy
    assert jc.TruncationPolicy.from_json(TP[name].to_json()) == JP[name]


def test_from_flag_rules():
    p = tc.TruncationPolicy.from_flag("64_to_5_14;32_to_3_8")
    assert [(r.from_width, r.fmt.exp_bits, r.fmt.man_bits)
            for r in p.rules] == [(64, 5, 14), (32, 3, 8)]
    assert p.rule_for("x", "add", torch.float64).fmt.man_bits == 14
    assert p.rule_for("x", "add", torch.float32).fmt.man_bits == 8
    assert p.rule_for("x", "add", torch.bfloat16) is None


def test_parse_and_resolve_policy():
    assert tc.parse_policy(None) is None and tc.parse_policy("") is None
    p = tc.parse_policy("scope:**/mlp=e5m7")
    assert p == tc.TruncationPolicy.scoped("**/mlp", "e5m7")
    assert p.to_json() == jc.parse_policy("scope:**/mlp=e5m7").to_json()
    assert tc.parse_policy(p) is p
    assert tc.resolve_policy().policy is None
    assert tc.resolve_policy(p).policy is p
    assert tc.resolve_policy("64_to_5_14").policy == \
        tc.TruncationPolicy.from_flag("64_to_5_14")
    with pytest.raises(ValueError):
        tc.resolve_policy(p, "bench_model")
    # the registry branch is not ported yet: it must say so, not guess
    with pytest.raises(NotImplementedError, match="registry"):
        tc.resolve_policy("bench_model@v3")
    with pytest.raises(NotImplementedError, match="registry"):
        tc.resolve_policy(artifact_ref="bench_model")


def test_committed_artifact_policy_loads_and_round_trips():
    """``artifacts/bench_model.json``'s policy is the same JSON in both
    packages, byte for byte after a round trip."""
    with open(os.path.join(ROOT, "artifacts", "bench_model.json")) as f:
        data = json.load(f)["policy"]
    tp = tc.TruncationPolicy.from_json(data)
    jp = jc.TruncationPolicy.from_json(data)
    assert len(tp.rules) == len(data["rules"]) == 17
    dump = lambda d: json.dumps(d, sort_keys=True, indent=2)  # noqa: E731
    assert dump(tp.to_json()) == dump(data) == dump(jp.to_json())
    r = tp.rule_for("layer0/mlp", "dot_general", torch.float32)
    assert (r.fmt.exp_bits, r.fmt.man_bits) == (8, 2)
    assert tp.rule_for("final_norm/rmsnorm", "mul", torch.float32) is None


def test_mask_rules_refuse_to_serialise_and_key_distinctly():
    m1, m2 = tc.magnitude_below(1e-3), tc.magnitude_below(1e-3)
    p1 = tc.TruncationPolicy.everywhere("e5m7", mask=m1)
    p2 = tc.TruncationPolicy.everywhere("e5m7", mask=m2)
    with pytest.raises(tc.NotSerializableError):
        p1.to_json()
    assert p1.cache_key() == p1.cache_key() != p2.cache_key()
    assert tpolicy._mask_token(m1) != tpolicy._mask_token(m2)
    x = torch.tensor([1e-4, -1e-4, 0.5, -2.0])
    assert m1(x).tolist() == [True, True, False, False]
    assert tc.magnitude_above(0.4)(x).tolist() == [False, False, True, True]


def test_rule_for_is_memoised():
    p = tc.TruncationPolicy.scoped("layer/mlp", "e5m7")
    before = tpolicy.MATCHER_EVALS
    for _ in range(5):
        p.rule_for("layer/mlp", "add", torch.float32)
    assert tpolicy.MATCHER_EVALS == before + 1


def test_structural_primitives_and_formats_agree():
    assert tpolicy.STRUCTURAL_PRIMS == jpolicy.STRUCTURAL_PRIMS
    for spec in ("bf16", "fp16", "e4m3", "e4m3fn", "e5m2", "tf32", "e5m14",
                 "5_14", "e6m9s"):
        t, j = tc.parse_format(spec), jc.parse_format(spec)
        assert t.to_json() == j.to_json()
        assert (t.cache_key, t.max_finite, t.min_normal, t.min_subnormal) == \
            (j.cache_key, j.max_finite, j.min_normal, j.min_subnormal)
        assert tc.FPFormat.from_json(t.to_json()) == t
