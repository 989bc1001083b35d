"""The port's (e, m) quantizer against the reference package, bit for bit.

Same inputs, made with numpy from a seed, go through the JAX functions (the
plain reference, and the Pallas kernels in interpret mode), through the
independent integer oracle, and through the port on the CPU, where its
wrappers take the plain PyTorch versions. Every comparison is on the bit
patterns: the quantizer's contract is bit-exactness, so the tolerance is 0.
"""
import functools
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core  # noqa: F401  (the reference's kernels import core first)
from repro.compat import enable_x64
from repro.core.formats import FPFormat as JFPFormat
from repro.kernels.quantize_em import ops as jops, ref as jref
from repro.kernels.quantize_em.kernel import (
    LANES, quantize_2d, quantize_2d_dynamic,
)

from repro_torch.core.formats import FPFormat
from repro_torch.kernels.quantize_em import kernel as tkernel
from repro_torch.kernels.quantize_em import ops as tops, ref as tref

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "conformance"))
from bit_oracle import all_float16_values, oracle_quantize  # noqa: E402

RUNG_M = (23, 15, 10, 7, 5, 3, 2, 1)
RUNG_E = (8, 5, 4, 2)
OVERFLOW = ((False, True), (True, True), (False, False), (True, False))
FAULT_BITS = (0, 1, 24, 31, 32)


@functools.lru_cache(maxsize=None)
def sweep() -> np.ndarray:
    """All 65536 float16 bit patterns widened to f32, random f32 over the
    whole exponent range, random bit patterns (NaN payloads), f32
    subnormals, and the specials. 90,123 elements: not a multiple of 4."""
    r = np.random.RandomState(0)
    wide = (r.randn(12000) * np.exp(r.randn(12000) * 20)).astype(np.float32)
    bits = r.randint(0, 1 << 32, 8000, dtype=np.uint64).astype(np.uint32) \
        .view(np.float32)
    sub = (r.randint(1, 1 << 23, 4576).astype(np.uint32)
           | (r.randint(0, 2, 4576).astype(np.uint32) << 31)).view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 65504.0, 448.0,
                        464.0, 57344.0, 3.4028235e38, 1e-45], np.float32)
    x = np.concatenate([all_float16_values(), wide, bits, sub, special])
    assert x.size % 4 != 0 and x.size % 1024 != 0
    return x


def small() -> np.ndarray:
    return sweep()[::37].copy()


def bits_of(a) -> np.ndarray:
    """Bit pattern of a numpy / jax / torch array as unsigned integers."""
    if isinstance(a, torch.Tensor):
        width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a = a.contiguous().view(width).numpy()
    else:
        a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def assert_same_bits(got, want, nan_payload=True):
    """Equal bit patterns. ``nan_payload=False`` is for results that went
    through a narrowing conversion (bf16 / f16 storage, the convert-pair
    shortcut): XLA keeps the top payload bits of a NaN there and PyTorch
    stores the canonical quiet NaN, which is the frameworks' own cast and no
    part of the quantizer — NaNs must then sit at the same places and every
    other element must still be equal bit for bit."""
    g, w = bits_of(got), bits_of(want)
    if not nan_payload:
        gn = np.isnan(np.asarray(got.float()) if isinstance(got, torch.Tensor)
                      else np.asarray(got, np.float32))
        wn = np.isnan(np.asarray(want, np.float32))
        np.testing.assert_array_equal(gn, wn)
        g, w = g[~gn], w[~wn]
    np.testing.assert_array_equal(g, w)


# the reference's runtime-format path dispatches ~60 scalar ops eagerly; the
# format is data, so one jit serves every row
_jit_dynamic = jax.jit(lambda x, row: jops.quantize_dynamic(x, row,
                                                            impl="ref"))


def row_of(e, m, sat, inf, fault=0):
    return np.array([e, m, int(sat), int(inf) | (fault << 1)], np.int32)


# ---------------------------------------------------------------------------
# the rung grid: static and dynamic plain versions, f32 carrier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sat,inf", OVERFLOW)
@pytest.mark.parametrize("m", RUNG_M)
@pytest.mark.parametrize("e", RUNG_E)
def test_static_ref_matches_jax_and_oracle(e, m, sat, inf):
    x = sweep()
    got = tref.quantize_ref(torch.from_numpy(x), e, m, sat, inf)
    assert_same_bits(got, jref.quantize_ref(jnp.asarray(x), e, m, sat, inf))
    assert_same_bits(got, oracle_quantize(x, e, m, sat, inf))


@pytest.mark.parametrize("sat,inf", OVERFLOW)
@pytest.mark.parametrize("m", RUNG_M)
@pytest.mark.parametrize("e", RUNG_E)
def test_dynamic_matches_jax_and_static(e, m, sat, inf):
    x = sweep()
    xt = torch.from_numpy(x)
    row = row_of(e, m, sat, inf)
    want = _jit_dynamic(jnp.asarray(x), jnp.asarray(row))
    assert_same_bits(tref.quantize_ref_dynamic(xt, e, m, int(sat), int(inf)),
                     want)
    assert_same_bits(tops.quantize_dynamic(xt, row), want)
    assert_same_bits(tops.quantize_dynamic(xt, torch.from_numpy(row)), want)
    # every rung fits the carrier, so the dynamic path equals the static one
    assert_same_bits(tref.quantize_ref(xt, e, m, sat, inf), want)


@pytest.mark.parametrize("sat,inf", OVERFLOW)
@pytest.mark.parametrize("m", (10, 3))
@pytest.mark.parametrize("e", (8, 5, 4))
def test_matches_pallas_static_kernel_interpret(e, m, sat, inf):
    """The reference's TPU kernel ``quantize_2d`` run in interpret mode (one
    compile per format, hence the thinner grid and the float16 sweep only:
    64 rows of 1024 lanes)."""
    x = all_float16_values()
    want = quantize_2d(jnp.asarray(x).reshape(-1, LANES), exp_bits=e,
                       man_bits=m, saturate=sat, ieee_inf=inf, interpret=True)
    got = tref.quantize_ref(torch.from_numpy(x), e, m, sat, inf)
    assert_same_bits(got, np.asarray(want).reshape(-1))


@pytest.mark.parametrize("sat,inf", OVERFLOW)
@pytest.mark.parametrize("m", RUNG_M)
@pytest.mark.parametrize("e", RUNG_E)
def test_matches_pallas_dynamic_kernel_interpret(e, m, sat, inf):
    """``quantize_2d_dynamic`` in interpret mode: the format is data, so one
    compile serves the whole grid."""
    x = all_float16_values()
    row = row_of(e, m, sat, inf)
    want = quantize_2d_dynamic(jnp.asarray(x).reshape(-1, LANES),
                               jnp.asarray(row), interpret=True)
    got = tops.quantize_dynamic(torch.from_numpy(x), row)
    assert_same_bits(got, np.asarray(want).reshape(-1))


# ---------------------------------------------------------------------------
# public ops: shortcuts, storage types, prepared tables, fault channel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["fp32", "bf16", "fp16", "tf32", "e5m2",
                                  "e4m3", "e4m3fn", "e5m7", "e8m5", "e8m3",
                                  "e6m9s", "e2m1", "e5m14", "e4m0"])
def test_quantize_op_matches_jax(spec):
    """``quantize`` with its identity and convert-pair shortcuts."""
    x = sweep()
    want = jops.quantize(jnp.asarray(x), spec, impl="ref")
    exact = spec not in ("bf16", "fp16")          # those are convert pairs
    assert_same_bits(tops.quantize(torch.from_numpy(x), spec), want, exact)
    assert_same_bits(tops.quantize(torch.from_numpy(x), spec, impl="ref"),
                     want, exact)


@pytest.mark.parametrize("spec", ["bf16", "fp16"])
def test_convert_pair_equals_dynamic_row(spec):
    """``truncate`` takes the convert pair for e8m7 / e5m10, ``truncate_sweep``
    the row: the two must agree bit for bit (NaN payloads aside, which a
    convert pair does not keep)."""
    x = sweep()
    x = torch.from_numpy(x[~np.isnan(x)])
    assert_same_bits(tops.quantize(x, spec),
                     tops.quantize_dynamic(x, tops.format_row(spec)))


@pytest.mark.parametrize("spec", ["e5m7", "e8m3", "e4m3", "e5m2", "e8m10"])
@pytest.mark.parametrize("storage", ["bfloat16", "float16"])
def test_narrow_storage_matches_jax(storage, spec):
    """bf16 / f16 storage: widen, round on the f32 carrier, narrow with RNE
    — double rounding included (e8m10 on bf16 rounds twice)."""
    x = small()
    jx = jnp.asarray(x).astype(getattr(jnp, storage))
    tx = torch.from_numpy(x).to(getattr(torch, storage))
    assert_same_bits(tx, jx, False)                # same storage going in
    assert_same_bits(tops.quantize(tx, spec),
                     jops.quantize(jx, spec, impl="ref"), False)
    row = tops.format_row(spec)
    assert_same_bits(tops.quantize_dynamic(tx, row),
                     _jit_dynamic(jx, jnp.asarray(row)), False)
    assert tops.quantize(tx, spec).dtype == tx.dtype


@pytest.mark.parametrize("fault", FAULT_BITS)
@pytest.mark.parametrize("e,m,sat,inf", [(5, 7, False, True),
                                         (4, 3, True, False),
                                         (8, 23, False, True),
                                         (11, 52, False, True)])
def test_fault_channel_matches_jax(e, m, sat, inf, fault):
    """``field3 = ieee_inf | (bit + 1) << 1``: bit 31 wraps to the sign bit,
    fault 0 is an exact no-op."""
    x = small()
    row = row_of(e, m, sat, inf, fault)
    want = _jit_dynamic(jnp.asarray(x), jnp.asarray(row))
    got = tops.quantize_dynamic(torch.from_numpy(x), row)
    assert_same_bits(got, want)
    if fault:
        clean = tops.quantize_dynamic(torch.from_numpy(x),
                                      row_of(e, m, sat, inf))
        flipped = bits_of(clean) ^ np.uint32(1 << (fault - 1))
        np.testing.assert_array_equal(bits_of(got), flipped)


def test_bitflip_helpers_match_jax():
    x = small()
    for fault in FAULT_BITS:
        want = jops._bitflip(jnp.asarray(x), jnp.asarray(fault, jnp.int32))
        assert_same_bits(tops._bitflip(torch.from_numpy(x), fault), want)
        assert_same_bits(tref.bitflip32(torch.from_numpy(x), fault), want)


def test_identity_row_returns_input_bits():
    x = sweep()
    got = tops.quantize_dynamic(torch.from_numpy(x), tops.IDENTITY_ROW)
    assert_same_bits(got, x)
    np.testing.assert_array_equal(tops.IDENTITY_ROW, jops.IDENTITY_ROW)
    np.testing.assert_array_equal(tops.format_row("e4m3"),
                                  jops.format_row("e4m3"))


def test_prepared_table_and_table_site_match_jax():
    """A row read from the middle of a (num_sites, 4) table, through the
    prepared path and through ``(table, site)``."""
    x = small()
    table = np.stack([tops.IDENTITY_ROW, row_of(5, 2, 0, 1),
                      row_of(8, 3, 0, 1), row_of(4, 3, 1, 0),
                      row_of(5, 7, 0, 1, fault=24), row_of(2, 1, 0, 1)])
    jprep = jops.prepare_dynamic(table)
    tprep = tops.prepare_dynamic(table)
    tt = torch.from_numpy(table)
    for site in range(len(table)):
        want = jops.quantize_prepared(jnp.asarray(x), jprep, site)
        assert_same_bits(
            tops.quantize_prepared(torch.from_numpy(x), tprep, site), want)
        assert_same_bits(
            tops.quantize_dynamic(torch.from_numpy(x), (tt, site)), want)
        assert_same_bits(
            tops.quantize_dynamic(torch.from_numpy(x), table[site]), want)


def test_epilogue_matches_jax():
    x = small()
    for row in (row_of(5, 7, 0, 1), row_of(4, 3, 1, 0, fault=3),
                tops.IDENTITY_ROW):
        want = jref.quantize_epilogue(jnp.asarray(x), jnp.asarray(row))
        assert_same_bits(tref.quantize_epilogue(torch.from_numpy(x),
                                                torch.from_numpy(row)), want)


@pytest.mark.parametrize("e,m,sat,inf", [(11, 52, False, True),
                                         (8, 23, False, True),
                                         (5, 10, False, True),
                                         (5, 14, False, True),
                                         (4, 3, True, False),
                                         (4, 3, False, False),
                                         (11, 30, False, True)])
def test_f64_carrier_matches_jax(e, m, sat, inf):
    """float64 stays on the f64 carrier (plain-only in both packages)."""
    r = np.random.RandomState(1)
    x = np.concatenate([
        r.randn(3000) * np.exp(r.randn(3000) * 30),
        small()[~np.isnan(small())].astype(np.float64),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324, 1e308])])
    fmt = FPFormat(e, m, sat, inf)
    jfmt = JFPFormat(e, m, sat, inf)       # each package parses its own class
    with enable_x64():
        jx = jnp.asarray(x, jnp.float64)
        want_s = np.asarray(jops.quantize(jx, jfmt, impl="ref"))
        want_d = np.asarray(jops.quantize_dynamic(jx, jops.format_row(jfmt),
                                                  impl="ref"))
    tx = torch.from_numpy(x)
    assert_same_bits(tops.quantize(tx, fmt), want_s)
    assert_same_bits(tops.quantize_dynamic(tx, tops.format_row(fmt)), want_d)


# ---------------------------------------------------------------------------
# shapes and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 3, 5, 1023, 1025, 4099])
def test_sizes_off_the_vector_and_tile_widths(n):
    x = sweep()[1000:1000 + n]
    want = jops.quantize(jnp.asarray(x), "e5m7", impl="interpret")
    got = tops.quantize(torch.from_numpy(x), "e5m7")
    assert got.shape == (n,)
    assert_same_bits(got, want)


def test_non_contiguous_and_nd_input():
    x = sweep()[:4096].reshape(64, 64)
    want = np.asarray(jops.quantize(jnp.asarray(x), "e4m3", impl="ref"))
    got = tops.quantize(torch.from_numpy(x).t(), "e4m3")
    assert_same_bits(got.t(), want)


def test_non_float_input_passes_through():
    i = torch.arange(5)
    assert tops.quantize(i, "e5m2") is i
    assert tops.quantize_dynamic(i, tops.format_row("e5m2")) is i
    assert tops.quantize_prepared(i, {}, 0) is i
    assert tops.quantize(3, "e5m2") == 3


def test_impl_dispatch_never_hides_the_device():
    x = torch.from_numpy(small())
    with pytest.raises(ValueError, match="card"):
        tops.quantize(x, "e5m7", impl="cuda")
    with pytest.raises(ValueError, match="card"):
        tops.quantize_dynamic(x, tops.format_row("e5m7"), impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tops.quantize(x, "e5m7", impl="pallas")
    # the kernel wrappers take CUDA tensors only: no plain path inside them
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tkernel.quantize_em_static(x, FPFormat(5, 7))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tkernel.quantize_em_dynamic(x, torch.from_numpy(tops.IDENTITY_ROW))
    assert tkernel.quantize_em_static.launches == 0
    assert tkernel.quantize_em_dynamic.launches == 0


def test_static_constants_are_what_the_kernel_takes():
    """The struct handed to the CUDA kernel by value carries the constants
    the plain version rounds with."""
    for spec, k, mode in (("e5m7", 16, 1), ("e4m3", 20, 0), ("e4m3fn", 20, 2)):
        fmt = tops.parse_format(spec)
        c = tref.static_constants(fmt.exp_bits, fmt.man_bits, fmt.saturate,
                                  fmt.ieee_inf)
        p = tkernel.static_params(fmt)
        assert (p.k, p.ovf_mode, bool(p.knz)) == (k, mode, True)
        assert p.keep == (~((1 << k) - 1)) & 0xFFFFFFFF
        assert p.half_m1 == (1 << (k - 1)) - 1
        assert p.max_finite == np.float32(fmt.max_finite)
        assert p.ss * p.ssinv == 1.0 and p.ss == c["ss"]
