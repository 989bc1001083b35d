"""Plain PyTorch versions of the (e, m) round-to-nearest-even quantizers.

These are the functions the two CUDA kernels in ``csrc/quantize_em.cu`` are
held against, bit for bit. They run on any device; the CPU tests compare them
with the reference package's quantizer and with the integer oracle, and the
on-card check compares each kernel with them on the same inputs. Nothing on
the main path calls them for a tensor that lies on the card.

Instead of a scalar correctly-rounded library call per operation, the
*carrier* (f32/f64) result of each op is rounded onto the representable grid
of the target ``FPFormat`` with pure bit manipulation.

Semantics:
  * round-to-nearest, ties-to-even on the target grid
  * gradual underflow onto the target's subnormal grid
  * overflow -> +/-inf (IEEE layouts) / NaN (fn layouts) / +/-max_finite
    (``saturate`` formats)
  * NaN preserved (payload included), +/-inf preserved, +/-0 preserved
Known carrier-precision floor: inputs that are subnormal *in the carrier*
combined with a target whose exponent range exceeds the carrier's cannot be
re-normalized; irrelevant for every profiling configuration in this repo.
"""
from __future__ import annotations

import numpy as np
import torch

# carrier dtype -> (integer view dtype, stored mantissa bits, exponent bits)
_CARRIER = {
    torch.float32: (torch.int32, 23, 8),
    torch.float64: (torch.int64, 52, 11),
}
_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _carrier(dt):
    if dt not in _CARRIER:
        raise TypeError(f"carrier must be f32/f64, got {dt}")
    return _CARRIER[dt]


def _format_constants(exp_bits: int, man_bits: int, ieee_inf: bool):
    bias = (1 << (exp_bits - 1)) - 1
    max_exp = (1 << exp_bits) - (2 if ieee_inf else 1) - bias
    min_exp = 1 - bias
    if ieee_inf:
        max_finite = 2.0 ** max_exp * (2.0 - 2.0 ** (-min(man_bits, 52)))
    else:
        max_finite = 2.0 ** max_exp * (2.0 - 2.0 ** (1 - min(man_bits, 52)))
    min_normal = 2.0 ** min_exp
    sub_scale = 2.0 ** (min_exp - man_bits)
    return max_exp, max_finite, min_normal, sub_scale


def _wrap_int(v: int, bits: int) -> int:
    """Python int -> the two's-complement value an int of ``bits`` holds."""
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def static_constants(exp_bits: int, man_bits: int, saturate: bool,
                     ieee_inf: bool, dtype=torch.float32) -> dict:
    """Everything ``quantize_ref`` derives from a compile-time format, as
    python scalars already rounded to the carrier. The static CUDA kernel
    takes exactly these by value, so the plain version and the kernel share
    one derivation."""
    _, c_man, c_exp = _carrier(dtype)
    npf = _NP[dtype]
    finfo = np.finfo(npf)
    _, max_finite, min_normal, sub_scale = _format_constants(
        exp_bits, man_bits, ieee_inf)
    k = c_man - man_bits
    use_sub = exp_bits < c_exp and sub_scale >= float(finfo.tiny)
    ovf_gate = max_finite <= float(finfo.max)
    ss = float(npf(sub_scale)) if use_sub else 1.0
    return dict(
        k=max(k, 0), knz=k > 0,
        half_m1=(1 << (k - 1)) - 1 if k > 0 else 0,
        keep=_wrap_int(~((1 << k) - 1), c_man + c_exp + 1) if k > 0 else -1,
        use_sub=use_sub, ss=ss,
        # exact: ss is a power of two >= the carrier's tiny
        ssinv=1.0 / ss,
        min_normal=float(npf(min_normal)) if use_sub else 0.0,
        ovf_gate=ovf_gate,
        max_finite=float(npf(max_finite)) if ovf_gate else 0.0,
        # 0 saturate, 1 +/-inf, 2 NaN
        ovf_mode=0 if saturate else (1 if ieee_inf else 2),
    )


def quantize_ref(x, exp_bits: int, man_bits: int, saturate: bool = False,
                 ieee_inf: bool = True):
    """Quantize ``x`` (f32 or f64) to the (exp_bits, man_bits) grid, RNE.

    Returns a tensor of the same dtype as ``x`` whose values all lie on the
    target format's representable grid.
    """
    dt = x.dtype
    int_dtype, _, _ = _carrier(dt)
    c = static_constants(exp_bits, man_bits, saturate, ieee_inf, dt)

    # ---- 1) normal-range mantissa RNE via the bit trick --------------------
    if c["knz"]:
        bits = x.view(int_dtype)
        # bit k of a two's-complement int is shift-direction agnostic, so
        # the arithmetic shift stands in for the logical one
        lsb = (bits >> c["k"]) & 1
        rounded = (bits + c["half_m1"] + lsb) & c["keep"]
        y = rounded.view(dt)
    else:
        y = x

    # ---- 2) subnormal range: RNE onto the fixed-point grid -----------------
    # Only needed when the target exponent range is narrower than the
    # carrier's (otherwise the carrier-aligned bit trick already lands on the
    # right subnormal grid).
    if c["use_sub"]:
        x_sub = torch.round(x * c["ssinv"]) * c["ss"]
        y = torch.where(x.abs() < c["min_normal"], x_sub, y)

    # ---- 3) overflow --------------------------------------------------------
    if c["ovf_gate"]:
        mf = torch.tensor(c["max_finite"], dtype=dt, device=x.device)
        ovf = y.abs() > mf
        if c["ovf_mode"] == 0:
            y = torch.where(ovf, torch.copysign(mf, y), y)
        elif c["ovf_mode"] == 1:
            y = torch.where(ovf, torch.copysign(torch.full_like(mf, np.inf),
                                                y), y)
        else:  # fn layout, non-saturating: overflow is the positive NaN
            y = torch.where(ovf, torch.full_like(mf, np.nan), y)

    # ---- 4) specials: restore the input bits (NaN payload included) --------
    return torch.where(torch.isnan(x) | torch.isinf(x), x, y)


def quantize_ref_fmt(x, fmt):
    """Convenience wrapper taking an ``FPFormat``."""
    return quantize_ref(x, fmt.exp_bits, fmt.man_bits, fmt.saturate,
                        fmt.ieee_inf)


# ---------------------------------------------------------------------------
# runtime-parameterized variant: (e, m, saturate, ieee_inf) as tensor values
# ---------------------------------------------------------------------------
#
# ``quantize_ref`` specializes on the format in python. The dynamic variant
# takes the format fields as *data* (python ints, 0-d tensors or whole
# ``(num_sites,)`` table columns): every static branch becomes an elementwise
# ``where`` gate and the identity fast path becomes the ``man_bits >= carrier``
# gate, which is what the dynamic CUDA kernel does per launch from one table
# row it reads itself.


def _pow2(n, dt):
    """Exact 2**n in carrier dtype ``dt`` for an int32 tensor ``n``, built by
    writing the exponent field directly. Saturates to 0 below the normal
    range and to +inf above it; both ends are gated off by the callers."""
    int_dtype, man, c_exp = _carrier(dt)
    bias, emax = (1 << (c_exp - 1)) - 1, (1 << c_exp) - 1
    biased = torch.clamp(n + bias, 0, emax).to(int_dtype)
    return (biased << man).view(dt)


def _shl_one(shift, int_dtype):
    """``1 << shift`` on ``int_dtype`` with the reference's semantics: a
    shift of the full width or more gives 0 (never undefined), and a shift
    onto the top bit wraps to the sign bit."""
    width = 32 if int_dtype == torch.int32 else 64
    one = torch.ones((), dtype=int_dtype, device=shift.device)
    safe = torch.clamp(shift, 0, width - 1)
    return torch.where(shift < width, one << safe, torch.zeros_like(one))


def dynamic_row_params(exp_bits, man_bits, saturate, ieee_inf, fault=0,
                       dtype=torch.float32, device=None):
    """Derived rounding constants for the runtime quantizer, elementwise.

    Every quantity ``quantize_ref_dynamic`` derives from the format fields —
    rounding masks, range bounds, gates, the fault XOR mask — but none of
    the array-side math. Inputs may be python ints, 0-d tensors, or whole
    ``(num_sites,)`` table columns: the math is elementwise, so one call
    derives the constants for an entire format table at once. Returns a dict
    of tensors parallel to the inputs.
    """
    int_dtype, c_man, c_exp = _carrier(dtype)
    npf = _NP[dtype]
    finfo = np.finfo(npf)
    if device is None:
        device = next((v.device for v in (exp_bits, man_bits, saturate,
                                          ieee_inf, fault)
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))

    def as_i32(v):
        return torch.as_tensor(v, device=device).to(torch.int32)

    e, m, fault = as_i32(exp_bits), as_i32(man_bits), as_i32(fault)
    sat = torch.as_tensor(saturate, device=device) != 0
    inf = torch.as_tensor(ieee_inf, device=device) != 0
    one32 = torch.ones((), dtype=torch.int32, device=device)

    bias = (one32 << (e - 1)) - 1
    max_exp = (one32 << e) - torch.where(inf, 2, 1) - bias
    min_exp = 1 - bias
    m_eff = torch.clamp(m, max=c_man)
    max_finite = _pow2(max_exp, dtype) * (
        2.0 - _pow2(torch.where(inf, -m_eff, 1 - m_eff), dtype))
    min_normal = _pow2(min_exp, dtype)
    sub_scale = _pow2(min_exp - m, dtype)

    k = torch.clamp(c_man - m, 0, c_man)
    kk = k.to(int_dtype)
    half = _shl_one(torch.clamp(kk - 1, min=0), int_dtype)
    keep = ~(_shl_one(kk, int_dtype) - 1)
    use_sub = (e < c_exp) & (sub_scale >= float(finfo.tiny))
    unit = torch.ones((), dtype=dtype, device=device)
    ss = torch.where(use_sub, sub_scale, unit)
    # exact reciprocal: ss is a power of two >= the carrier's tiny, so 1/ss
    # is finite and x * (1/ss) == x / ss bit for bit
    ssinv = torch.where(use_sub, unit / ss, unit)
    ovf_gate = max_finite <= float(finfo.max)
    # overflow magnitude for the sign-carrying cases; the fn (overflow->NaN)
    # case is selected separately in apply so the stored NaN stays the
    # positive quiet-NaN constant, never a sign-flipped product
    ovf_mag = torch.where(sat, max_finite, unit * np.inf)
    ovf_nan = ~sat & ~inf
    identity = (m >= c_man) & (e >= c_exp) & inf & ~sat
    fshift = torch.clamp(fault - 1, min=0).to(int_dtype)
    fmask = torch.where(fault > 0, _shl_one(fshift, int_dtype),
                        torch.zeros((), dtype=int_dtype, device=device))
    return dict(kk=kk, half=half, keep=keep, knz=k > 0,
                use_sub=use_sub, ss=ss, ssinv=ssinv, min_normal=min_normal,
                ovf_gate=ovf_gate, max_finite=max_finite, ovf_mag=ovf_mag,
                ovf_nan=ovf_nan, identity=identity, fmask=fmask)


def apply_row_params(x, p):
    """Quantize carrier tensor ``x`` with precomputed row constants ``p``
    (one row of :func:`dynamic_row_params`, i.e. 0-d entries), including
    the fault-channel XOR (``fmask == 0`` is an exact bit no-op)."""
    dt = x.dtype
    int_dtype, _, _ = _carrier(dt)

    # ---- 1) normal-range mantissa RNE, runtime shift amounts ---------------
    bits = x.view(int_dtype)
    lsb = (bits >> p["kk"]) & 1
    rounded = (bits + (p["half"] - 1) + lsb) & p["keep"]
    y = torch.where(p["knz"], rounded.view(dt), x)

    # ---- 2) subnormal range: RNE onto the fixed-point grid -----------------
    x_sub = torch.round(x * p["ssinv"]) * p["ss"]
    y = torch.where(p["use_sub"] & (x.abs() < p["min_normal"]), x_sub, y)

    # ---- 3) overflow --------------------------------------------------------
    ovf = p["ovf_gate"] & (y.abs() > p["max_finite"])
    nan = torch.full((), np.nan, dtype=dt, device=x.device)
    ovf_val = torch.where(p["ovf_nan"], nan, torch.copysign(p["ovf_mag"], y))
    y = torch.where(ovf, ovf_val, y)

    # ---- 4) specials + identity gate (all branches restore x) --------------
    y = torch.where(torch.isnan(x) | torch.isinf(x) | p["identity"], x, y)

    # ---- 5) fault channel ---------------------------------------------------
    return (y.view(int_dtype) ^ p["fmask"]).view(dt)


def quantize_ref_dynamic(x, exp_bits, man_bits, saturate, ieee_inf):
    """Quantize carrier tensor ``x`` (f32/f64) onto the (e, m) grid where the
    format fields are *runtime* scalars (python ints or int32 tensors).

    Bit-for-bit identical to ``quantize_ref`` for any format whose mantissa
    fits the carrier (``man_bits <= nmant``); formats at least as fine as the
    carrier grid (and with IEEE overflow) are returned unchanged via the
    identity gate."""
    _carrier(x.dtype)
    p = dynamic_row_params(exp_bits, man_bits, saturate, ieee_inf,
                           dtype=x.dtype, device=x.device)
    return apply_row_params(x, p)


# ---------------------------------------------------------------------------
# the full runtime row, applied to a value about to be stored
# ---------------------------------------------------------------------------


def bitflip32(y, fault):
    """XOR bit ``fault - 1`` into each element's f32 bit pattern; ``fault == 0``
    is an exact no-op."""
    fault = torch.as_tensor(fault, device=y.device).to(torch.int32)
    shift = torch.clamp(fault - 1, min=0)
    mask = torch.where(fault > 0, _shl_one(shift, torch.int32),
                       torch.zeros((), dtype=torch.int32, device=y.device))
    return (y.view(torch.int32) ^ mask).view(torch.float32)


def quantize_epilogue(y, fmt_row):
    """Apply a runtime format row to a value: decode
    ``field3 = ieee_inf | (bit_index + 1) << 1``, quantize on the f32
    carrier, XOR the armed fault bit, cast back to ``y.dtype``.

    ``fmt_row`` is a (4,) int32 tensor. This is, operation for operation,
    what the dynamic CUDA kernel does in one pass for one table row; the
    identity row (and any clean row with fault 0) passes values through
    unchanged."""
    e, m, s, f3 = fmt_row[0], fmt_row[1], fmt_row[2], fmt_row[3]
    p = dynamic_row_params(e, m, s, f3 & 1, f3 >> 1, device=y.device)
    return apply_row_params(y.to(torch.float32), p).to(y.dtype)
