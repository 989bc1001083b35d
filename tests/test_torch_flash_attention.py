"""The port's flash attention (plain oracle, chunked plain version, and the
custom op's CPU registration that ``impl='interpret'`` runs) against the
reference package's oracle and its Pallas kernel in interpret mode, and the
fused quantize epilogue against unfused attention + ``quantize_dynamic``.

The CUDA kernel itself has no CPU mode: ``chip_smoke.py`` holds it against
these plain versions on the card. Inputs are made with numpy from a seed and
handed to both packages."""
import functools

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp
import torch

import repro.core  # noqa: F401  (import order of the reference package)
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.quantize_em.ops import IDENTITY_ROW, quantize_dynamic

# tests/test_kernels.py FLASH_CASES: B, Hq, Hkv, S, D, window, causal, dtype
FLASH_CASES = [
    (2, 4, 2, 128, 32, None, True, "float32"),
    (1, 8, 8, 64, 16, None, True, "float32"),
    (2, 4, 1, 128, 32, 32, True, "float32"),
    (1, 2, 2, 256, 64, None, False, "float32"),
    (2, 6, 3, 128, 32, None, True, "bfloat16"),
    (1, 4, 4, 128, 128, 64, True, "float32"),
]
CASE_IDS = [f"{B}x{Hq}/{Hkv}x{S}x{D}-w{w}-{'c' if c else 'nc'}-{dt}"
            for B, Hq, Hkv, S, D, w, c, dt in FLASH_CASES]

# tests/test_fused_epilogue.py ROWS
ROWS = [
    ("e8m15", [8, 15, 0, 1]), ("e8m10", [8, 10, 0, 1]),
    ("e8m7", [8, 7, 0, 1]), ("e8m5", [8, 5, 0, 1]), ("e8m3", [8, 3, 0, 1]),
    ("e8m2", [8, 2, 0, 1]), ("e5m2", [5, 2, 0, 1]), ("e4m3s", [4, 3, 1, 0]),
    ("e4m3fn", [4, 3, 0, 0]), ("e4m3fn+fault31", [4, 3, 0, 64]),
    ("identity", list(IDENTITY_ROW)),
]
ROW_IDS = [n for n, _ in ROWS]
ROW_VALS = [np.array(r, np.int32) for _, r in ROWS]


def tol_for(dtype: str) -> float:
    return 2e-2 if dtype == "bfloat16" else 2e-5


@functools.lru_cache(maxsize=None)
def case_data(i):
    """numpy inputs of one case and the reference package's two outputs
    (oracle, Pallas kernel in interpret mode), as float32 numpy arrays."""
    B, Hq, Hkv, S, D, win, causal, dt = FLASH_CASES[i]
    r = np.random.RandomState(1000 + i)
    q = r.randn(B, Hq, S, D).astype(np.float32)
    k = r.randn(B, Hkv, S, D).astype(np.float32)
    v = r.randn(B, Hkv, S, D).astype(np.float32)
    jdt = getattr(jnp, dt)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    o_ref = jax_attention_ref(jq, jk, jv, causal=causal, window=win)
    o_pal = flash_attention_pallas(jq, jk, jv, causal=causal, window=win,
                                   block_q=64, block_k=64, interpret=True)
    as32 = lambda o: np.asarray(o.astype(jnp.float32))
    return (q, k, v), as32(o_ref), as32(o_pal)


def port_inputs(i):
    (q, k, v), _, _ = case_data(i)
    dt = getattr(torch, FLASH_CASES[i][-1])
    return tuple(torch.from_numpy(x).to(dt) for x in (q, k, v))


def port_output(i, which: str):
    B, Hq, Hkv, S, D, win, causal, dt = FLASH_CASES[i]
    q, k, v = port_inputs(i)
    if which == "oracle":
        return attention_ref(q, k, v, causal=causal, window=win)
    return fops.flash_attention(q, k, v, causal=causal, window=win,
                                impl=which)


@pytest.mark.parametrize("which", ["oracle", "ref", "interpret"])
@pytest.mark.parametrize("i", range(len(FLASH_CASES)), ids=CASE_IDS)
def test_port_matches_reference(i, which):
    """Each plain version of the port against the reference's oracle and
    its Pallas kernel body, at the reference's own tolerance."""
    _, o_ref, o_pal = case_data(i)
    dt = FLASH_CASES[i][-1]
    got = port_output(i, which)
    assert got.dtype == getattr(torch, dt)
    assert tuple(got.shape) == o_ref.shape
    got = got.to(torch.float32).numpy()
    tol = tol_for(dt)
    assert np.abs(got - o_ref).max() < tol
    assert np.abs(got - o_pal).max() < tol


@pytest.mark.parametrize("i", range(len(FLASH_CASES)), ids=CASE_IDS)
def test_interpret_is_one_op_with_the_chunked_arithmetic(i):
    """The custom op's CPU registration runs the chunked plain version: the
    same bits as ``impl='ref'``, in one op."""
    a = port_output(i, "interpret")
    b = port_output(i, "ref")
    assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                              else torch.int32),
                       b.view(torch.int16 if b.dtype == torch.bfloat16
                              else torch.int32))


@given(seed=st.integers(0, 10 ** 6))
@settings(max_examples=10, deadline=None)
def test_constant_values_give_that_constant(seed):
    """Attention of a constant V is that constant (the softmax sums to one
    over the causal mask), as in tests/test_kernels.py."""
    r = np.random.RandomState(seed)
    q = torch.from_numpy(r.randn(1, 2, 64, 16).astype(np.float32))
    k = torch.from_numpy(r.randn(1, 2, 64, 16).astype(np.float32))
    v = torch.full((1, 2, 64, 16), 3.5)
    for impl in ("interpret", "ref"):
        o = fops.flash_attention(q, k, v, causal=True, impl=impl)
        assert float((o - 3.5).abs().max()) < 1e-5


def fused_args(seed=0):
    r = np.random.RandomState(seed)
    return tuple(torch.from_numpy((r.randn(1, 2, 128, 32) * 4)
                                  .astype(np.float32)) for _ in range(3))


@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("row", ROW_VALS, ids=ROW_IDS)
def test_fused_equals_unfused_then_quantize(row, impl):
    """With a row wired in, the output is bit for bit the unfused output
    followed by ``quantize_dynamic`` on the same row."""
    q, k, v = fused_args()
    fused = fops.flash_attention(q, k, v, causal=True, impl=impl,
                                 out_fmt=row)
    plain = fops.flash_attention(q, k, v, causal=True, impl=impl)
    want = quantize_dynamic(plain, row, impl="ref")
    assert torch.equal(fused.view(torch.int32), want.view(torch.int32))


def grid_step(x, e: int, m: int):
    """Spacing of the (e, m) grid at |x| (subnormal spacing below the
    normal range)."""
    min_exp = 2 - (1 << (e - 1))
    ex = np.floor(np.log2(np.maximum(np.abs(x), 1e-45)))
    return np.exp2(np.maximum(ex, min_exp) - m)


@pytest.mark.parametrize("row", ROW_VALS, ids=ROW_IDS)
def test_fused_against_reference_kernel(row):
    """The port's fused output against the reference's fused Pallas kernel.
    The attention sums are taken in another order in the two packages, so
    the unrounded outputs differ by a few f32 ulps of the output's scale
    (these inputs are scaled by 4, so the outputs reach ~10 and the flash
    tolerance 2e-5 is taken relative to max |out|). Rounding onto a coarse
    grid then maps two such values onto the same or a neighbouring grid
    point: held within that tolerance for the identity row, within one grid
    step of the row's format plus that tolerance for the others."""
    q, k, v = fused_args()
    got = fops.flash_attention(q, k, v, causal=True, impl="interpret",
                               out_fmt=row).numpy()
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    want = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=True, block_q=64, block_k=64, interpret=True,
        out_fmt=jnp.asarray(row)))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    diff = np.abs(got - want)
    e, m = int(row[0]), int(row[1])
    if m >= 23:
        assert diff.max() < tol
    else:
        step = grid_step(np.maximum(np.abs(got), np.abs(want)), e, m)
        assert (diff <= step + tol).all()
        # and most elements land on the very same grid point
        assert (diff == 0).mean() > 0.9


def test_window_and_ragged_shapes_of_the_plain_versions():
    """A window wider than the sequence is no window; the chunked version
    keeps working when S is not a multiple of its chunk but divides it."""
    r = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(r.randn(1, 2, 48, 16).astype(np.float32))
               for _ in range(3))
    a = fops.flash_attention(q, k, v, window=4096, impl="interpret")
    b = attention_ref(q, k, v)
    assert float((a - b).abs().max()) < 2e-5


@pytest.mark.parametrize("shapes,dtype,error", [
    (((1, 4, 8, 80), (1, 2, 8, 80), (1, 2, 8, 80)), "bfloat16", None),
    (((1, 4, 8, 16), (1, 3, 8, 16), (1, 3, 8, 16)), "float32", ValueError),
    (((1, 4, 8, 160), (1, 2, 8, 160), (1, 2, 8, 160)), "float32", ValueError),
    (((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 48)), "float32", ValueError),
    (((1, 4, 8, 16), (1, 2, 9, 16), (1, 2, 9, 16)), "float32", ValueError),
    (((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)), "float16", TypeError),
], ids=["path-like", "heads", "head-dim", "value-dim", "seq", "dtype"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(shapes, dtype,
                                                              error):
    """The CUDA wrapper's shape and dtype checks are plain Python: held here
    on CPU tensors, before any launch could be attempted."""
    from repro_torch.kernels.flash_attention import kernel as fk
    q, k, v = (torch.zeros(s, dtype=getattr(torch, dtype)) for s in shapes)
    if error is None:
        fk.check_shapes(q, k, v)
    else:
        with pytest.raises(error):
            fk.check_shapes(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fk.flash_attention_cuda(q, k, v, None, True, None, 1.0)


def bf16_ulps(got, want):
    """The largest |got - want| less 1e-6, in units of the bf16 spacing at
    |want| (``chip_smoke.py``'s measure)."""
    got, want = got.double(), want.double()
    _, e = torch.frexp(want.abs().clamp_min(torch.finfo(torch.bfloat16).tiny))
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    return float((((got - want).abs() - 1e-6).clamp_min(0) / ulp).max())


def split_bf16(p, terms):
    """p (f32) as ``terms`` bf16 values whose sum approximates it: each term
    rounds what the ones before it left (the differences are exact)."""
    parts, rest = [], p
    for _ in range(terms):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = rest - part
    return parts


@pytest.mark.parametrize("terms,within", [(1, False), (2, False), (3, True)],
                         ids=["rounded-once", "hi-lo", "hi-mid-lo"])
def test_p_split_in_three_bf16_terms_keeps_two_bf16_units(terms, within):
    """The bf16 kernel's arithmetic on P, emulated on the reference's case
    (2, 4 q heads, 1 KV head, S 128, D 32, window 32) with the inputs
    ``chip_smoke.py`` gives it (numpy seed 2, cast to bf16): S = q k^T in
    f32, the scale after the product, p = exp(s - max) and l = sum p in
    f32, then P V with P as bf16 terms (the products exact, summed in f64
    here). The output, rounded to bf16, is held against an f64 attention
    within 2 bf16 units of |want| + 1e-6, the card's check, which outputs
    near zero (a tiny unit) make strict. P rounded once misses it by
    thousands of units; two terms (2^-17 of p left) by a few, as the card
    measured; three terms hold all of an f32 p and keep it."""
    B, Hq, Hkv, S, D, W = 2, 4, 1, 128, 32, 32
    r = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(r.randn(B, H, S, D).astype(np.float32))
               .to(torch.bfloat16).float() for H in (Hq, Hkv, Hkv))
    k, v = (x.repeat_interleave(Hq // Hkv, 1) for x in (k, v))
    scale = np.float32(1.0 / np.sqrt(D))
    i = torch.arange(S)
    mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < W)
    s64 = (q.double() @ k.double().transpose(-1, -2)) * float(scale)
    want = torch.softmax(s64.masked_fill(~mask, -np.inf), -1) @ v.double()
    s = ((q @ k.transpose(-1, -2)) * scale).masked_fill(~mask, -1e30)
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    l = p.sum(-1, keepdim=True)
    P = sum(t.double() for t in split_bf16(p, terms))
    got = ((P @ v.double()) / l.double()).float().to(torch.bfloat16)
    assert (bf16_ulps(got, want) <= 2.0) == within


def test_split_terms_bound_the_relative_error():
    """What each form of P keeps of p (round to nearest, the differences
    exact): one bf16 term 2^-8 relative, two 2^-17, three all 24 bits of
    an f32 p."""
    r = np.random.RandomState(1)
    p = torch.from_numpy(np.exp(-r.rand(100000) * 20).astype(np.float32))
    for terms, bound in ((1, 2.0 ** -8), (2, 2.0 ** -17), (3, 0.0)):
        rel = ((sum(t.double() for t in split_bf16(p, terms)) - p.double())
               .abs() / p.double()).max()
        assert float(rel) <= bound
        assert float(rel) >= bound / 2


def test_bf16_operands_pad_to_one_head_dim_and_keep_aligned_views():
    """The bf16 kernel reads q, k, v through TMA at one head dim: the
    binding pads to the smallest of ``HEAD_DIMS_V`` that holds D and Dv,
    passes the path's permuted views through uncopied, and copies a base
    off the 16-byte alignment."""
    from repro_torch.kernels.flash_attention import kernel as fk
    bf = torch.bfloat16
    q, k, v = (torch.zeros(s, dtype=bf) for s in
               ((1, 4, 8, 24), (1, 2, 8, 24), (1, 2, 8, 32)))
    q2, k2, v2 = fk.bf16_operands(q, k, v)
    assert q2.shape[-1] == k2.shape[-1] == v2.shape[-1] == 32
    x = torch.randn(1, 8, 2, 80).to(bf).permute(0, 2, 1, 3)   # (B,S,H,D) seen
    q2, k2, v2 = fk.bf16_operands(x, x, x)                      # as (B,H,S,D)
    assert q2 is x and k2 is x and v2 is x
    off = torch.randn(2000).to(bf)[1:641].view(1, 1, 8, 80)
    q2, _, _ = fk.bf16_operands(off, off, off)
    assert q2 is not off and q2.data_ptr() % 16 == 0 and torch.equal(q2, off)
