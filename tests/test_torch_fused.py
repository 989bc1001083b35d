"""Routing a site's format row into a fused kernel's epilogue, under
``truncate`` and ``truncate_sweep``, on the CPU.

The port's flash-attention and WKV6 kernels are ``torch.library`` custom ops
that a policy sees as the reference's ``pallas_call``; with
``impl='interpret'`` the op runs its plain version, so the routing runs here
as it does on the card. The contract (``kernels/fused.py``): a routed run is
bit for bit the unfused op followed by ``quantize_dynamic`` on the same row,
the covered output takes no separate quantize pass, every other output
(WKV6's recurrence state) does, a masked rule is never routed, and the site
lists equal the reference's."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jc
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.rwkv6.kernel import wkv6_pallas

import repro_torch.core as tc
from repro_torch.core import interpreter
from repro_torch.kernels import fused
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.quantize_em import ops as qops
from repro_torch.kernels.quantize_em.ops import (
    IDENTITY_ROW, format_row, quantize_dynamic,
)
from repro_torch.kernels.rwkv6 import ops as wops

FLASH_OP = torch.ops.repro_torch.flash_attention.default
WKV6_OP = torch.ops.repro_torch.wkv6.default


def flash_args(seed=2):
    r = np.random.RandomState(seed)
    return [(r.randn(1, 2, 128, 32) * 4).astype(np.float32)
            for _ in range(3)]


def wkv_args(seed=0):
    r = np.random.RandomState(seed)
    B, H, S, hd = 1, 2, 64, 16
    rr, k, v = (r.randn(B, H, S, hd).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-r.randn(B, H, S, hd)))).astype(np.float32)
    u = (r.randn(H, hd) * 0.1).astype(np.float32)
    s0 = np.zeros((B, H, hd, hd), np.float32)
    return [rr, k, v, w, u, s0]


def flash_prog(q, k, v):
    return fops.flash_attention(q, k, v, causal=True, impl="interpret",
                                out_fmt=IDENTITY_ROW)


def wkv_prog(r, k, v, w, u, s0):
    with tc.scope("wkv"):
        return wops.wkv6(r, k, v, w, u, s0, chunk=32, impl="interpret",
                         out_fmt=IDENTITY_ROW)


def unfused(name, xs):
    """The op without a row: the value the covered output is rounded from."""
    if name == "flash":
        return fops.flash_attention(*xs, causal=True, impl="interpret")
    return wops.wkv6(*xs, chunk=32, impl="interpret")


PROGRAMS = {"flash": (flash_prog, flash_args), "wkv6": (wkv_prog, wkv_args)}


def T(xs):
    return [torch.from_numpy(x) for x in xs]


def bits(t):
    return t.view(torch.int32)


@pytest.fixture
def spy(monkeypatch):
    """Shapes of every value the walk hands to a separate quantize pass."""
    seen = []

    def wrap(name):
        real = getattr(qops, name)

        def f(x, *a, **kw):
            seen.append(tuple(x.shape))
            return real(x, *a, **kw)
        monkeypatch.setattr(qops, name, f)

    for name in ("quantize", "quantize_dynamic", "quantize_prepared"):
        wrap(name)
    return seen


# --------------------------------------------------------------------------
# recognition
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op,want", [
    (FLASH_OP, (0,)), (WKV6_OP, (0,)),
    (torch.ops.aten.add.Tensor, None), (torch.ops.aten.mm.default, None),
    (torch.ops.aten.exp.default, None), (torch.ops.aten.where.self, None),
], ids=["flash", "wkv6", "add", "mm", "exp", "where"])
def test_fused_outputs_recognises_the_two_ops_and_nothing_else(op, want):
    assert fused.fused_outputs(op) == want
    if want is not None:
        assert interpreter.prim_name(op) == ("pallas_call", False)
        assert op._schema.arguments[fused.row_argument(op)].name == "row"


def test_covered_dtype_is_known_before_the_op_runs():
    q = torch.zeros(1, 1, 4, 16, dtype=torch.bfloat16)
    assert fused.covered_dtype(FLASH_OP, (q,)) == torch.bfloat16
    assert fused.covered_dtype(WKV6_OP, (q,)) == torch.float32


# --------------------------------------------------------------------------
# routing under truncate and truncate_sweep
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["flash", "wkv6"])
def test_truncate_routes_the_rule_into_the_epilogue(name, spy):
    prog, make = PROGRAMS[name]
    xs = T(make())
    pol = tc.TruncationPolicy.everywhere("e8m3")
    got = tc.truncate(prog, pol, impl="interpret")(*xs)
    passes = list(spy)
    plain = unfused(name, xs)
    row = format_row("e8m3")
    if name == "flash":
        assert torch.equal(bits(got), bits(quantize_dynamic(plain, row,
                                                             impl="ref")))
        assert passes == []         # the covered output took no second pass
    else:
        y, sT = got
        assert torch.equal(bits(y), bits(quantize_dynamic(plain[0], row,
                                                          impl="ref")))
        assert torch.equal(bits(sT), bits(qops.quantize(plain[1], "e8m3")))
        assert passes == [tuple(sT.shape)]


@pytest.mark.parametrize("name", ["flash", "wkv6"])
def test_sweep_routes_the_table_row_into_the_epilogue(name, spy):
    prog, make = PROGRAMS[name]
    xs = T(make())
    pol = tc.TruncationPolicy.everywhere("e8m3")
    handle = tc.truncate_sweep(prog, pol, impl="interpret", device="cpu")(*xs)
    del spy[:]                      # the enumeration run quantizes nothing
    got = handle(handle.table(pol))
    passes = list(spy)
    plain = unfused(name, xs)
    row = format_row("e8m3")
    if name == "flash":
        assert torch.equal(bits(got), bits(quantize_dynamic(plain, row,
                                                             impl="ref")))
        assert passes == []
    else:
        y, sT = got
        assert torch.equal(bits(y), bits(quantize_dynamic(plain[0], row,
                                                          impl="ref")))
        assert torch.equal(bits(sT), bits(quantize_dynamic(plain[1], row,
                                                           impl="ref")))
        assert passes == [tuple(sT.shape)]


def test_masked_rule_is_not_routed(spy):
    """A rule with a mask keeps the separate (masked) pass, as in the
    reference: the row wired into the op stays the identity."""
    xs = T(flash_args())
    rule = tc.TruncationRule(fmt="e8m3",
                             mask=tc.magnitude_below(1.0))
    got = tc.truncate(flash_prog, tc.TruncationPolicy(rules=(rule,)),
                      impl="interpret")(*xs)
    passes = list(spy)
    plain = unfused("flash", xs)
    want = torch.where(plain.abs() < 1.0, qops.quantize(plain, "e8m3"),
                       plain)
    assert torch.equal(bits(got), bits(want))
    assert passes == [tuple(plain.shape)]


def test_call_without_a_row_stays_an_ordinary_site(spy):
    """No row wired in: no epilogue to route into, so the output is an
    ordinary site with its own quantize pass."""
    xs = T(flash_args())

    def prog(q, k, v):
        return fops.flash_attention(q, k, v, causal=True, impl="interpret")

    got = tc.truncate(prog, tc.TruncationPolicy.everywhere("e8m3"),
                      impl="interpret")(*xs)
    passes = list(spy)
    plain = unfused("flash", xs)
    assert torch.equal(bits(got), bits(qops.quantize(plain, "e8m3")))
    assert passes == [tuple(plain.shape)]


def test_policy_row_is_made_once_per_plan():
    """The rule's row tensor lives in the plan: later calls of the same
    signature reuse it (on the card: no host-to-device copy per call)."""
    xs = T(flash_args())
    f = tc.truncate(flash_prog, tc.TruncationPolicy.everywhere("e5m2"),
                    impl="interpret")
    a = f(*xs)
    (plan,) = f._cache.values()
    rows = {k: v for k, v in plan.items() if k[0] == "fused_row"}
    assert len(rows) == 1
    (row,) = rows.values()
    assert row.tolist() == list(format_row("e5m2"))
    b = f(*xs)
    (row2,) = [v for k, v in plan.items() if k[0] == "fused_row"]
    assert row2 is row and f.n_traces == 1
    assert torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("spec", ["e8m3", "e5m2", "e4m3fn", "e8m10"])
@pytest.mark.parametrize("name", ["flash", "wkv6"])
def test_table_row_equals_truncate_under_the_same_policy(name, spec):
    prog, make = PROGRAMS[name]
    xs = T(make())
    pol = tc.TruncationPolicy.everywhere(spec)
    got = tc.truncate(prog, pol, impl="interpret")(*xs)
    sweep = tc.truncate_sweep(prog, tc.TruncationPolicy.everywhere("e5m2"),
                              impl="interpret", device="cpu")
    handle = sweep(*xs)
    swept = handle(handle.table(pol))
    got = got if isinstance(got, tuple) else (got,)
    swept = swept if isinstance(swept, tuple) else (swept,)
    for a, b in zip(got, swept):
        assert torch.equal(bits(a), bits(b))
    ident = handle(handle.identity_table())
    ident = ident if isinstance(ident, tuple) else (ident,)
    plain = prog(*xs)
    plain = plain if isinstance(plain, tuple) else (plain,)
    for a, b in zip(ident, plain):
        assert torch.equal(bits(a), bits(b))


# --------------------------------------------------------------------------
# site lists against the reference
# --------------------------------------------------------------------------

def jax_flash_prog(q, k, v):
    return flash_attention_pallas(q, k, v, causal=True, block_q=64,
                                  block_k=64, interpret=True,
                                  out_fmt=jnp.asarray(IDENTITY_ROW))


def jax_wkv_prog(r, k, v, w, u, s0):
    with jax.named_scope("wkv"):
        return wkv6_pallas(r, k, v, w, u, s0, chunk=32, interpret=True,
                           out_fmt=jnp.asarray(IDENTITY_ROW))


@pytest.mark.parametrize("name,n_sites", [("flash", 1), ("wkv6", 2)])
def test_site_lists_equal_the_reference(name, n_sites):
    prog, make = PROGRAMS[name]
    jprog = {"flash": jax_flash_prog, "wkv6": jax_wkv_prog}[name]
    xs = make()
    pol_j = jc.TruncationPolicy.everywhere("e8m3")
    pol_t = tc.TruncationPolicy.everywhere("e8m3")
    h_j = jc.truncate_sweep(jprog, pol_j, impl="interpret")(
        *[jnp.asarray(x) for x in xs])
    h_t = tc.truncate_sweep(prog, pol_t, impl="interpret",
                            device="cpu")(*T(xs))
    want = [(s.stack, s.prim) for s in h_j.sites]
    got = [(s.stack, s.prim) for s in h_t.sites]
    assert got == want
    assert len(got) == n_sites and {p for _, p in got} == {"pallas_call"}
    assert h_t.site_executions == n_sites


def grid_step(x, e: int, m: int):
    """Spacing of the (e, m) grid at |x| (subnormal spacing below the
    normal range)."""
    min_exp = 2 - (1 << (e - 1))
    ex = np.floor(np.log2(np.maximum(np.abs(x), 1e-45)))
    return np.exp2(np.maximum(ex, min_exp) - m)


@pytest.mark.parametrize("spec", ["e8m3", "e5m2"])
@pytest.mark.parametrize("name", ["flash", "wkv6"])
def test_routed_truncate_agrees_with_the_reference_truncate(name, spec):
    """The port's routed ``truncate`` against the reference's ``truncate``
    of the same Pallas program on the same inputs. The kernels take their
    sums in another order, so the unrounded outputs differ within the
    kernels' tolerance (flash 2e-5 of max |out|, these inputs being scaled
    by 4; WKV6 1e-4, y and sT alike); rounding onto the format's grid then
    maps two such values onto the same or a neighbouring grid point."""
    prog, make = PROGRAMS[name]
    jprog = {"flash": jax_flash_prog, "wkv6": jax_wkv_prog}[name]
    xs = make()
    got = tc.truncate(prog, tc.TruncationPolicy.everywhere(spec),
                      impl="interpret")(*T(xs))
    want = jc.truncate(jprog, jc.TruncationPolicy.everywhere(spec),
                       impl="interpret")(*[jnp.asarray(x) for x in xs])
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    e, m = (int(c) for c in format_row(spec)[:2])
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and np.isfinite(a).all()
        tol = (2e-5 * max(1.0, float(np.abs(b).max())) if name == "flash"
               else 1e-4)
        diff = np.abs(a - b)
        assert (diff <= grid_step(np.maximum(np.abs(a), np.abs(b)), e, m)
                + tol).all()
        # and most elements land on the very same grid point
        assert (diff == 0).mean() > 0.9


# --------------------------------------------------------------------------
# impl argument checks
# --------------------------------------------------------------------------

def fake_cuda(*shapes):
    """Tensors that claim to lie on the card, made without one: enough to
    reach the argument checks, which must refuse before any launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return [torch.empty(s, device="cuda") for s in shapes]


def test_cuda_impl_on_cpu_tensors_raises():
    q, k, v = T(flash_args())
    with pytest.raises(ValueError, match="impl='cuda'"):
        fops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda'"):
        wops.wkv6(*T(wkv_args()), impl="cuda")


def test_interpret_impl_is_refused_for_the_card():
    q, k, v = fake_cuda((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16))
    assert q.is_cuda
    with pytest.raises(ValueError, match="impl='interpret'"):
        fops.flash_attention(q, k, v, impl="interpret")
    r, k2, v2, w = fake_cuda(*[(1, 2, 8, 16)] * 4)
    u, s0 = fake_cuda((2, 16), (1, 2, 16, 16))
    with pytest.raises(ValueError, match="impl='interpret'"):
        wops.wkv6(r, k2, v2, w, u, s0, impl="interpret")
    with pytest.raises(ValueError, match="impl='interpret'"):
        qops.quantize(q, "e5m7", impl="interpret")


def test_unknown_impl_and_arguments_raise():
    q, k, v = T(flash_args())
    with pytest.raises(ValueError, match="unknown impl"):
        fops.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(TypeError, match="unexpected"):
        fops.flash_attention(q, k, v, impl="ref", q_chunk=64)
    with pytest.raises(ValueError, match="unknown impl"):
        wops.wkv6(*T(wkv_args()), impl="xla")
