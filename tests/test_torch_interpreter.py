"""The port's op-mode walk (``truncate`` / ``truncate_sweep``) against the
reference package's, on programs small enough to compare bit for bit.

The straight-line program uses add, sub, mul and div only: IEEE basic
operations are correctly rounded by both XLA's CPU code and PyTorch's, so
with the same rounding after the same ops the two packages must produce the
same bits. One deviation of XLA's CPU code was found and the program narrowed
around it: where a multiply feeds an add or a subtract with no rounding
between them, XLA contracts the pair into a fused multiply-add (one rounding
instead of two) and differs from PyTorch by an ulp even with no policy at
all. So in this program no product is consumed by an add or a subtract.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jc

import repro_torch.core as tc
from repro_torch.core import interpreter as tinterp
from repro_torch.core import policy as tpolicy
from repro_torch.launch.mesh import make_probe_mesh

from test_torch_distributed import one_rank  # noqa: F401 (a fixture)

RUNGS = [f"e{e}m{m}" for e in (8, 5) for m in (23, 15, 10, 7, 5, 3, 2, 1)] + [
    "e4m3", "e4m3fn", "e5m2", "e2m1"]


def inputs(n=257, seed=0):
    r = np.random.RandomState(seed)
    a = (r.randn(n) * 10 ** r.uniform(-3, 3, n)).astype(np.float32)
    b = (r.randn(n) * 4 + 0.1).astype(np.float32)
    c = (r.randn(n) * 10 ** r.uniform(-2, 2, n)).astype(np.float32)
    return a, b, c


def jprog(a, b, c):
    with jax.named_scope("outer"):
        x = a + b
        with jax.named_scope("inner"):
            y = x * c
            z = y / b
        w = z - a
    with jax.named_scope("tail"):
        t = w / x
        return (t - y) * c


def tprog(a, b, c):
    with tc.scope("outer"):
        x = a + b
        with tc.scope("inner"):
            y = x * c
            z = y / b
        w = z - a
    with tc.scope("tail"):
        t = w / x
        return (t - y) * c


def same_bits(t, j):
    np.testing.assert_array_equal(
        t.detach().numpy().view(np.uint32),
        np.asarray(j, np.float32).view(np.uint32))


def J(xs):
    return [jnp.asarray(x) for x in xs]


def T(xs):
    return [torch.from_numpy(x) for x in xs]


def policies(mod, fmt):
    P = mod.TruncationPolicy
    return {"everywhere": P.everywhere(fmt),
            "inner": P.scoped("outer/inner", fmt),
            "outer_minus_inner": P.scoped("outer", fmt).excluding(
                "outer/inner"),
            "mul_only": P.everywhere(fmt, ops=("mul",)),
            "no_div": P.everywhere(fmt, exclude_ops=("div",))}


# ---------------------------------------------------------------------------
# bit-for-bit against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", RUNGS)
def test_truncate_matches_reference_every_rung(fmt):
    xs = inputs()
    got = tc.truncate(tprog, tc.TruncationPolicy.everywhere(fmt))(*T(xs))
    want = jc.truncate(jprog, jc.TruncationPolicy.everywhere(fmt))(*J(xs))
    same_bits(got, want)


@pytest.mark.parametrize("which", ["inner", "outer_minus_inner", "mul_only",
                                   "no_div"])
@pytest.mark.parametrize("fmt", ["e5m7", "e8m3", "e4m3"])
def test_truncate_matches_reference_scoped_policies(fmt, which):
    xs = inputs(seed=1)
    got = tc.truncate(tprog, policies(tc, fmt)[which])(*T(xs))
    want = jc.truncate(jprog, policies(jc, fmt)[which])(*J(xs))
    same_bits(got, want)


@pytest.fixture(scope="module")
def handles():
    xs = inputs(seed=2)
    th = tc.truncate_sweep(tprog, tc.TruncationPolicy.everywhere("e5m2"))(
        *T(xs))
    jh = jc.truncate_sweep(jprog, jc.TruncationPolicy.everywhere("e5m2"))(
        *J(xs))
    return xs, th, jh


def test_sites_match_reference(handles):
    _, th, jh = handles
    assert th.num_sites == jh.num_sites == 7
    assert [(s.scope, s.prim) for s in th.sites] == \
        [(s.scope, s.prim) for s in jh.sites]
    np.testing.assert_array_equal(th.identity_table(), jh.identity_table())


@pytest.mark.parametrize("fmt", RUNGS)
def test_sweep_matches_reference_every_rung(handles, fmt):
    xs, th, jh = handles
    tt = th.table(tc.TruncationPolicy.everywhere(fmt))
    jt = jh.table(jc.TruncationPolicy.everywhere(fmt))
    np.testing.assert_array_equal(tt, jt)
    same_bits(th(tt), jh(jt))


@pytest.mark.parametrize("which", ["inner", "outer_minus_inner", "mul_only",
                                   "no_div"])
def test_sweep_matches_reference_scoped_tables(handles, which):
    xs, th, jh = handles
    tt, jt = th.table(policies(tc, "e5m7")[which]), \
        jh.table(policies(jc, "e5m7")[which])
    np.testing.assert_array_equal(tt, jt)
    same_bits(th(tt), jh(jt))


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------

def test_identity_table_is_the_plain_function(handles):
    xs, th, _ = handles
    same_bits(th(th.identity_table()), tprog(*T(xs)).numpy())
    empty = tc.truncate(tprog, tc.TruncationPolicy(rules=()))
    same_bits(empty(*T(xs)), tprog(*T(xs)).numpy())


@pytest.mark.parametrize("fmt", ["e8m7", "e5m10", "e5m7", "e8m3", "e4m3"])
@pytest.mark.parametrize("which", ["everywhere", "inner", "no_div"])
def test_truncate_equals_its_table(handles, which, fmt):
    """``truncate(fn, P)`` and ``handle(handle.table(P))`` agree bit for bit,
    e8m7 / e5m10 included, where the first takes a convert pair."""
    xs, th, _ = handles
    p = policies(tc, fmt)[which]
    same_bits(th(th.table(p)), tc.truncate(tprog, p)(*T(xs)).numpy())


def test_batch_equals_stacked_single_calls(handles):
    xs, th, _ = handles
    ps = [tc.TruncationPolicy.everywhere(f) for f in ("e8m10", "e5m7", "e4m3")]
    tables = th.tables(ps)
    assert tables.shape == (3, th.num_sites, 4)
    out = th.batch(tables)
    assert out.shape == (3, 257)
    for k, p in enumerate(ps):
        same_bits(out[k], th(th.table(p)).numpy())

    def two_outputs(a, b, c):
        y = tprog(a, b, c)
        return {"y": y, "s": y.sum()}
    h2 = tc.truncate_sweep(two_outputs,
                           tc.TruncationPolicy.everywhere("e5m2"))(*T(xs))
    out2 = h2.batch(h2.tables(ps))
    assert out2["y"].shape == (3, 257) and out2["s"].shape == (3,)


def test_one_trace_per_input_signature():
    sweep = tc.truncate_sweep(tprog, tc.TruncationPolicy.everywhere("e5m2"))
    xs = T(inputs())
    h = sweep(*xs)
    for fmt in RUNGS:
        h(h.table(tc.TruncationPolicy.everywhere(fmt)))
        sweep(*xs)                       # a new handle is not a new trace
    assert sweep.n_traces == 1 and sweep.cache_size() == 1
    sweep(*T(inputs(n=64)))              # another shape is
    assert sweep.n_traces == 2 and sweep.cache_size() == 2
    sweep(*[x.double() for x in xs])     # and another dtype
    assert sweep.n_traces == 3
    sweep.cache_clear()
    assert sweep.cache_size() == 0
    sweep(*xs)
    assert sweep.n_traces == 4

    lossy = tc.truncate(tprog, tc.TruncationPolicy.everywhere("e5m7"))
    first = lossy(*xs)
    for _ in range(3):
        same_bits(lossy(*xs), first.numpy())
    assert lossy.n_traces == 1 and lossy.cache_size() == 1
    lossy(*T(inputs(n=64)))
    assert lossy.n_traces == 2
    uncached = tc.truncate(tprog, tc.TruncationPolicy.everywhere("e5m7"),
                           cache=False)
    uncached(*xs), uncached(*xs)
    assert uncached.n_traces == 2 and uncached.cache_size() == 0


def layered(x, ws, scan_layers=True):
    for i, w in enumerate(ws):
        with tc.scope("layer" if scan_layers else f"layer{i}"):
            with tc.scope("mlp"):
                x = x * w
            x = x + 1.0
    return x


def test_repeated_body_under_one_scope_is_one_set_of_sites():
    x = torch.from_numpy(inputs()[0])
    ws = [torch.full((257,), 1.0 + 0.1 * i) for i in range(5)]
    site_policy = tc.TruncationPolicy.everywhere("e5m2")
    h = tc.truncate_sweep(layered, site_policy)(x, ws)
    assert [(s.scope, s.prim) for s in h.sites] == [("layer/mlp", "mul"),
                                                    ("layer", "add")]
    assert h.site_executions == 10
    h5 = tc.truncate_sweep(layered, site_policy)(x, ws, scan_layers=False)
    assert h5.num_sites == 10
    assert [s.scope for s in h5.sites][:3] == ["layer0/mlp", "layer0",
                                               "layer1/mlp"]
    # one row steers all five iterations, exactly like the policy does
    p = tc.TruncationPolicy.scoped("layer/mlp", "e5m7")
    same_bits(h(h.table(p)), tc.truncate(layered, p)(x, ws).numpy())
    assert not torch.equal(h(h.table(p)), layered(x, ws))


def test_loop_body_shares_sites_without_naming_a_scope():
    def chunks(x):
        acc = torch.zeros(())
        with tc.scope("mix"):
            for i in range(4):
                with tc.loop_body("chunk"):
                    acc = acc + (x[i * 8:(i + 1) * 8] * 0.5).sum()
            return acc * 2.0
    x = torch.from_numpy(inputs()[0])
    h = tc.truncate_sweep(chunks, tc.TruncationPolicy.everywhere("e5m2"))(x)
    assert [(s.scope, s.prim) for s in h.sites] == [
        ("mix", "mul"), ("mix", "reduce_sum"), ("mix", "add"), ("mix", "mul")]
    assert h.site_executions == 13
    p = tc.TruncationPolicy.scoped("mix", "e8m3")
    same_bits(h(h.table(p)).reshape(1), tc.truncate(chunks, p)(x).reshape(1)
              .numpy())


def test_tables_take_plain_output_rules_only(handles):
    _, th, _ = handles
    masked = tc.TruncationPolicy.everywhere(
        "e5m7", mask=tc.magnitude_below(1.0))
    dots = tc.TruncationPolicy.everywhere("e5m7", quantize_dot_inputs=True)
    for bad in (masked, dots):
        with pytest.raises(ValueError, match="plain output-quantize"):
            th.table(bad)
        with pytest.raises(ValueError, match="plain output-quantize"):
            tc.truncate_sweep(tprog, bad)(*T(inputs()))
    with pytest.raises(ValueError, match="table must be int32"):
        th(np.zeros((3, 4), np.int32))


def test_excluding_fences_a_region():
    xs = T(inputs(seed=3))
    p = tc.TruncationPolicy.everywhere("e5m2")
    fenced = p.excluding("outer", "tail")
    same_bits(tc.truncate(tprog, fenced)(*xs), tprog(*xs).numpy())
    h = tc.truncate_sweep(tprog, p.excluding("outer/inner"))(*xs)
    assert all(s.scope != "outer/inner" for s in h.sites) and h.num_sites == 5


def test_unmapped_aten_op_raises_with_its_name():
    x = torch.from_numpy(inputs()[1]).abs()
    with pytest.raises(NotImplementedError, match="lgamma"):
        tc.truncate(torch.lgamma, tc.TruncationPolicy.everywhere("e5m7"))(x)
    with pytest.raises(NotImplementedError, match="ATEN_TO_PRIM"):
        tc.truncate_sweep(torch.lgamma,
                          tc.TruncationPolicy.everywhere("e5m7"))(x)
    # even with an empty policy: no silent default for an unknown op
    with pytest.raises(NotImplementedError):
        tc.truncate(torch.lgamma, tc.TruncationPolicy(rules=()))(x)


def test_vocabulary_is_the_reference_primitives():
    structural = {p for p in tinterp.ATEN_TO_PRIM.values()
                  if p in tpolicy.STRUCTURAL_PRIMS}
    assert {"reshape", "transpose", "select_n", "gather", "max",
            "reduce_max", "concatenate"} <= structural
    for aten, prim in (("mm", "dot_general"), ("bmm", "dot_general"),
                       ("add", "add"), ("exp", "exp"), ("rsqrt", "rsqrt"),
                       ("sigmoid", "logistic"), ("sum", "reduce_sum"),
                       ("_to_copy", "convert_element_type")):
        assert tinterp.ATEN_TO_PRIM[aten] == prim
    assert tinterp.prim_name(torch.ops.aten.add_.Tensor) == ("add", True)
    assert tinterp.prim_name(torch.ops.aten.mm.default) == ("dot_general",
                                                            False)


def test_mask_rule_truncates_only_where_the_predicate_holds():
    xs = inputs(seed=4)
    tp = tc.TruncationPolicy.everywhere("e8m3", mask=tc.magnitude_below(1.0))
    jp = jc.TruncationPolicy.everywhere("e8m3", mask=jc.magnitude_below(1.0))
    got = tc.truncate(tprog, tp)(*T(xs))
    same_bits(got, jc.truncate(jprog, jp)(*J(xs)))
    full = tc.truncate(tprog, tc.TruncationPolicy.everywhere("e8m3"))(*T(xs))
    assert not torch.equal(got, full)


def test_dot_input_quantization_rounds_inputs_not_output():
    r = np.random.RandomState(5)
    a = r.randn(16, 8).astype(np.float32)
    b = r.randn(8, 12).astype(np.float32)
    pol = tc.TruncationPolicy.everywhere("e4m3", quantize_dot_inputs=True)
    got = tc.truncate(torch.matmul, pol)(*T((a, b)))
    from repro_torch.kernels.quantize_em.ops import quantize
    qa, qb = quantize(torch.from_numpy(a), "e4m3"), \
        quantize(torch.from_numpy(b), "e4m3")
    assert torch.equal(got, qa @ qb)
    assert not torch.equal(got, quantize(got, "e4m3"))   # output left alone
    jpol = jc.TruncationPolicy.everywhere("e4m3", quantize_dot_inputs=True)
    want = jc.truncate(jnp.matmul, jpol)(*J((a, b)))
    # e4m3 inputs have 4 significant bits and K = 8, so every partial sum is
    # exact in f32 whatever the order: the products agree bit for bit
    same_bits(got, want)


def test_from_width_rule_selects_by_storage_width():
    a, b, c = inputs(seed=6)
    pol = tc.TruncationPolicy.from_flag("64_to_5_14;32_to_8_3")
    f32 = tc.truncate(tprog, pol)(*T((a, b, c)))
    same_bits(f32, tc.truncate(
        tprog, tc.TruncationPolicy.everywhere("e8m3"))(*T((a, b, c))).numpy())
    xs64 = [torch.from_numpy(x.astype(np.float64)) for x in (a, b, c)]
    f64 = tc.truncate(tprog, pol)(*xs64)
    want = tc.truncate(tprog, tc.TruncationPolicy.everywhere("e5m14"))(*xs64)
    assert f64.dtype == torch.float64 and torch.equal(f64, want, )


def test_in_place_ops_keep_their_aliasing():
    def prog(a, b):
        with tc.scope("s"):
            y = a * b
            y.add_(b)
            return y
    a, b, _ = T(inputs(seed=7))
    pol = tc.TruncationPolicy.everywhere("e8m3")

    def expected(a, b):
        from repro_torch.kernels.quantize_em.ops import quantize
        return quantize(quantize(a * b, "e8m3") + b, "e8m3")
    assert torch.equal(tc.truncate(prog, pol)(a, b), expected(a, b))


def test_scope_rules_and_keywords_not_ported_yet(one_rank):
    """Scope names are one plain segment. ``native_fp8`` is ported
    (``test_torch_fp8_dot.py``): with no ``quantize_dot_inputs`` rule it
    changes no bit. So are ``mesh`` / ``in_shardings``: on a mesh of one
    rank the output is the plain one bit for bit, anything but a mesh is
    refused, and ``in_shardings`` that are no prefix of the arguments raise
    jit's ``ValueError`` (the multi-rank cases: ``test_torch_spmd.py``)."""
    with pytest.raises(ValueError):
        tc.scope("a/b")
    with pytest.raises(ValueError):
        tc.scope("")
    pol = tc.TruncationPolicy.everywhere("e4m3")
    xs = T(inputs(seed=8))
    assert torch.equal(tc.truncate(tprog, pol, native_fp8=True)(*xs),
                       tc.truncate(tprog, pol)(*xs))
    with pytest.raises(TypeError, match="mesh"):
        tc.truncate(tprog, pol, mesh=object())
    mesh = make_probe_mesh(device="cpu")
    assert torch.equal(tc.truncate(tprog, pol, mesh=mesh)(*xs),
                       tc.truncate(tprog, pol)(*xs))
    with pytest.raises(ValueError, match="prefix"):
        tc.truncate_sweep(tprog, pol, mesh=mesh,
                          in_shardings=[None] * (len(xs) + 1))(*xs)


def test_transform_called_under_a_scope_keeps_it():
    xs = T(inputs(seed=8))
    pol = tc.TruncationPolicy.scoped("wrap/outer/inner", "e5m2")
    lossy = tc.truncate(tprog, pol)
    with tc.scope("wrap"):
        inside = lossy(*xs)
    same_bits(inside, tc.truncate(
        tprog, tc.TruncationPolicy.scoped("outer/inner", "e5m2"))(*xs).numpy())
    assert tinterp.current_stack() == ""


def test_empty_policy_never_runs_the_matcher():
    xs = T(inputs())
    before = tpolicy.MATCHER_EVALS
    tc.truncate(tprog, tc.TruncationPolicy(rules=()))(*xs)
    assert tpolicy.MATCHER_EVALS == before


def test_table_on_cpu_goes_through_the_prepared_path(handles):
    """On CPU tensors a swept evaluation derives the row constants once for
    the whole table; the result equals the per-row dynamic quantizer."""
    xs, th, _ = handles
    t = th.table(tc.TruncationPolicy.everywhere("e5m7"))
    same_bits(th(t), th(torch.from_numpy(t)).numpy())
    assert th.device_table(t).dtype == torch.int32
