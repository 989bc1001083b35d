"""Abstract value domain for static numerical analysis (the port's copy of
the reference package's ``analysis/domain.py``: same names, same lattice,
same transfer table keyed by the reference's primitive names).

Every value the analysis follows is abstracted as an :class:`AbsVal` — a
magnitude interval plus *exactness* facts:

  * ``hi``       — upper bound on ``|x|`` over all elements. ``inf`` means
                   "unknown / possibly non-finite"; a finite ``hi`` is a
                   proof that every element is finite (no NaN, no inf).
  * ``lo``       — lower bound on ``max |x|`` (0 = no information). Only
                   consumed by the overflow verdict, which additionally
                   requires a finite ``hi``.
  * ``min_nz``   — lower bound on ``|x|`` of non-zero finite elements
                   (0 = no information).
  * ``ulp_exp``  — every finite element is an integer multiple of
                   ``2**ulp_exp`` (``-inf`` = unknown).
  * ``rel_bits`` — every finite element is ``+/- a * 2**k`` with
                   ``1 <= a < 2`` and ``a`` having at most ``rel_bits``
                   fractional bits (``inf`` = unknown).
  * ``nonneg``   — all finite elements are >= 0.

A value whose ``rel_bits`` / ``ulp_exp`` fit a target format's mantissa /
subnormal grid (and whose ``hi`` fits its range) quantizes to itself bit
for bit: the EXACT verdict. :func:`seal` meets a transfer result with its
carrier dtype (the reference's soundness argument holds unchanged).
Magnitude bounds get a ``(1 +/- 2**-20)`` inflate / deflate margin.

What differs from the reference is where a transfer's facts come from.
There a transfer reads an equation's params and its operands' avals; here
it reads a :class:`Call`: the shapes and dtypes of the aten call's operands
and outputs, and the params the interpreter derives from the call's
arguments (``dimension_numbers`` becomes the contraction size ``n``,
``axes`` the reduced size ``n_reduced``, ``integer_pow``'s ``y`` the
exponent). Dtypes are torch dtypes (numpy dtypes are accepted too).
:func:`from_concrete` reduces a tensor on its own device and makes one
host transfer; its facts are the reference's on the same array (a
bfloat16 or float8 array is the top in both).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import FPFormat

_MARGIN = 1.0 + 2.0 ** -20

__all__ = [
    "AbsVal", "Aval", "Call", "carrier_format", "of_aval", "top_for_dtype",
    "from_concrete", "join", "join_all", "leq", "seal", "transfer",
]


def _up(x: float) -> float:
    """Inflate an upper bound by the safety margin."""
    if not math.isfinite(x):
        return math.inf
    return x * _MARGIN if x > 0 else 0.0


def _dn(x: float) -> float:
    """Deflate a lower bound by the safety margin."""
    if not math.isfinite(x) or x <= 0:
        return 0.0
    return x / _MARGIN


@dataclasses.dataclass(frozen=True)
class AbsVal:
    hi: float = math.inf
    lo: float = 0.0
    min_nz: float = 0.0
    ulp_exp: float = -math.inf
    rel_bits: float = math.inf
    nonneg: bool = False

    def drop_lo(self) -> "AbsVal":
        """Forget the max-magnitude lower bound (element selection)."""
        if self.lo == 0.0:
            return self
        return dataclasses.replace(self, lo=0.0)

    @property
    def finite(self) -> bool:
        return math.isfinite(self.hi)


_TOP = AbsVal()

_BOOL = AbsVal(hi=1.0, lo=0.0, min_nz=1.0, ulp_exp=0.0, rel_bits=0.0,
               nonneg=True)


@dataclasses.dataclass(frozen=True)
class Aval:
    """Shape and dtype of one operand or output of a call."""
    shape: Tuple[int, ...]
    dtype: Any


@dataclasses.dataclass(frozen=True)
class Call:
    """What a transfer reads of one aten call: its primitive name, the
    params derived from its arguments, and its operands' and outputs'
    avals (the reference's ``eqn``)."""
    prim: str
    params: Dict[str, Any]
    in_avals: Tuple[Aval, ...]
    out_avals: Tuple[Aval, ...]


def _rel_from(hi: float, ulp_exp: float) -> float:
    """Fractional-mantissa-bit bound implied by ``|x| <= hi`` on the
    ``2**ulp_exp`` grid."""
    if not math.isfinite(hi) or not math.isfinite(ulp_exp):
        return math.inf
    if hi <= 0:
        return 0.0
    _, e = math.frexp(hi)  # hi = m * 2**e, m in [0.5, 1)
    return float(max(0, (e - 1) - int(ulp_exp)))


_CARRIERS: Dict[str, FPFormat] = {
    "float64": FPFormat(11, 52),
    "float32": FPFormat(8, 23),
    "float16": FPFormat(5, 10),
    "bfloat16": FPFormat(8, 7),
    "float8_e4m3fn": FPFormat(4, 3, ieee_inf=False),
    "float8_e5m2": FPFormat(5, 2),
}


def _dtype_name(dtype: Any) -> Optional[str]:
    """``'float32'`` for ``torch.float32``, ``np.float32`` or the string."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rpartition(".")[2]
    if isinstance(dtype, str):
        return dtype
    try:
        return np.dtype(dtype).name
    except TypeError:
        return None


def _kind(dtype: Any) -> Optional[str]:
    """numpy's kind letter: ``f``, ``i``, ``u``, ``b`` (``None`` if
    unknown)."""
    if isinstance(dtype, torch.dtype):
        if dtype.is_floating_point:
            return "f"
        if dtype == torch.bool:
            return "b"
        if dtype.is_complex:
            return "c"
        return "u" if dtype == torch.uint8 else "i"
    name = _dtype_name(dtype)
    if name in _CARRIERS:
        return "f"
    try:
        return np.dtype(dtype).kind
    except TypeError:
        return None


def _int_range(dtype: Any) -> Tuple[float, int]:
    """(largest magnitude, bits) of an integer dtype."""
    if isinstance(dtype, torch.dtype):
        info = torch.iinfo(dtype)
        return float(max(abs(int(info.min)), int(info.max))), info.bits
    info = np.iinfo(np.dtype(dtype))
    return float(max(abs(int(info.min)), int(info.max))), info.bits


def carrier_format(dtype: Any) -> Optional[FPFormat]:
    """The FP format of a float dtype (None for non-floats)."""
    return _CARRIERS.get(_dtype_name(dtype))


def top_for_dtype(dtype: Any) -> AbsVal:
    """The no-information element for a dtype: everything the carrier can
    hold (including non-finites for float carriers)."""
    fmt = _CARRIERS.get(_dtype_name(dtype))
    if fmt is not None:
        return AbsVal(hi=math.inf, lo=0.0,
                      min_nz=fmt.min_subnormal,
                      ulp_exp=float(fmt.min_exp - fmt.man_bits),
                      rel_bits=float(fmt.man_bits), nonneg=False)
    kind = _kind(dtype)
    if kind in ("i", "u"):
        hi, bits = _int_range(dtype)
        return AbsVal(hi=hi, lo=0.0, min_nz=1.0, ulp_exp=0.0,
                      rel_bits=float(bits), nonneg=(kind == "u"))
    if kind == "b":
        return _BOOL
    return _TOP


def of_aval(aval: Any) -> AbsVal:
    dtype = getattr(aval, "dtype", None)
    return _TOP if dtype is None else top_for_dtype(dtype)


# float types numpy knows only as extension types (``ml_dtypes``): the
# reference abstracts an array of them as the top, and so does the port
_NOT_NUMPY_FLOATS = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _as_tensor(x: Any) -> Optional[Tuple[torch.Tensor, Any]]:
    """(tensor, its dtype) for a tensor, a numpy array or a Python number;
    ``None`` for what the reference abstracts as the top."""
    if isinstance(x, torch.Tensor):
        if x.dtype in _NOT_NUMPY_FLOATS:
            return None
        return x.detach(), x.dtype
    try:
        a = np.asarray(x)
    except Exception:
        return None
    if a.dtype.kind not in "fiub":
        return None
    return torch.from_numpy(np.ascontiguousarray(a)), a.dtype


def from_concrete(x: Any) -> AbsVal:
    """Abstract a concrete array exactly (ulp / rel via bit analysis): the
    reductions run on the tensor's device, then one host transfer. A
    ``bfloat16`` or ``float8`` array is the top, as in the reference (numpy
    does not see it as a float)."""
    got = _as_tensor(x)
    if got is None:
        return _TOP
    t, dtype = got
    kind = _kind(dtype)
    if kind == "b":
        return _BOOL
    if kind in ("i", "u"):
        if t.numel() == 0:
            return AbsVal(hi=0.0, lo=0.0, min_nz=0.0, ulp_exp=0.0,
                          rel_bits=0.0, nonneg=True)
        a64 = t.to(torch.float64)
        mags = a64.abs()
        stats = torch.stack([
            mags.max(),
            torch.where(mags > 0, mags, math.inf).min(),
            (a64 >= 0).all().to(torch.float64)]).tolist()
        mx, mn, nonneg = stats
        return AbsVal(hi=mx, lo=mx, min_nz=mn if math.isfinite(mn) else 0.0,
                      ulp_exp=0.0, rel_bits=_rel_from(mx, 0.0),
                      nonneg=bool(nonneg))
    if kind != "f":
        return _TOP
    if t.numel() == 0:
        return AbsVal(hi=0.0, lo=0.0, min_nz=0.0, ulp_exp=0.0, rel_bits=0.0,
                      nonneg=True)
    a = t.to(torch.float64)
    fin = torch.isfinite(a)
    a = torch.where(fin, a, 0.0)
    mags = a.abs()
    nzmask = mags > 0
    m, e = torch.frexp(a)  # a = m * 2**e, |m| in [0.5, 1) (0 for zeros)
    scaled = torch.round(m.abs() * 2.0 ** 53).to(torch.int64)
    tz = torch.zeros_like(scaled)
    v = scaled
    # trailing zero count, vectorized: strip factors of two in 6 passes
    for shift in (32, 16, 8, 4, 2, 1):
        mask = (v & ((1 << shift) - 1)) == 0
        v = torch.where(mask, v >> shift, v)
        tz = tz + torch.where(mask, shift, 0)
    ulp = torch.where(nzmask, e.to(torch.int64) - 53 + tz,
                      torch.iinfo(torch.int64).max).min()
    rel = torch.where(nzmask, 52 - tz, -1).max()
    stats = torch.stack([
        fin.all().to(torch.float64), mags.max(),
        torch.where(nzmask, mags, math.inf).min(),
        (a >= 0).all().to(torch.float64), nzmask.any().to(torch.float64),
        ulp.to(torch.float64), rel.to(torch.float64)]).tolist()
    finite, mx, min_nz, nonneg, any_nz, ulp, rel = stats
    if not finite:
        return dataclasses.replace(top_for_dtype(dtype), hi=math.inf)
    if not any_nz:
        # all-zero array: exactly on every grid
        return AbsVal(hi=0.0, lo=0.0, min_nz=0.0, ulp_exp=0.0, rel_bits=0.0,
                      nonneg=bool(nonneg))
    return AbsVal(hi=mx, lo=mx, min_nz=min_nz, ulp_exp=float(ulp),
                  rel_bits=float(rel), nonneg=bool(nonneg))


# --------------------------------------------------------------------------
# lattice ops
# --------------------------------------------------------------------------

def join(a: AbsVal, b: AbsVal) -> AbsVal:
    """Union over-approximation: facts that hold for both."""
    return AbsVal(hi=max(a.hi, b.hi), lo=min(a.lo, b.lo),
                  min_nz=min(a.min_nz, b.min_nz),
                  ulp_exp=min(a.ulp_exp, b.ulp_exp),
                  rel_bits=max(a.rel_bits, b.rel_bits),
                  nonneg=a.nonneg and b.nonneg)


def join_all(vals: Sequence[AbsVal]) -> AbsVal:
    out = vals[0]
    for v in vals[1:]:
        out = join(out, v)
    return out


def leq(a: AbsVal, b: AbsVal) -> bool:
    """True when ``a`` is at least as precise as ``b`` (a refines b)."""
    return (a.hi <= b.hi and a.lo >= b.lo and a.min_nz >= b.min_nz
            and a.ulp_exp >= b.ulp_exp and a.rel_bits <= b.rel_bits
            and (a.nonneg or not b.nonneg))


def seal(v: AbsVal, dtype: Any) -> AbsVal:
    """Meet a transfer result with its carrier dtype."""
    fmt = carrier_format(dtype)
    if fmt is None:
        return v
    hi = v.hi if v.hi <= fmt.max_finite else math.inf
    return AbsVal(
        hi=hi,
        lo=_dn(v.lo),
        min_nz=max(v.min_nz, fmt.min_subnormal),
        ulp_exp=max(v.ulp_exp, float(fmt.min_exp - fmt.man_bits)),
        rel_bits=min(v.rel_bits, float(fmt.man_bits)),
        nonneg=v.nonneg)


# --------------------------------------------------------------------------
# transfer functions (``eqn`` is a :class:`Call`)
# --------------------------------------------------------------------------

def _shape(aval: Any) -> Tuple[int, ...]:
    return tuple(getattr(aval, "shape", ()) or ())


def _is_scalar(aval: Any) -> bool:
    return _shape(aval) == ()


def _mul_hi(a: float, b: float) -> float:
    if a == 0.0 or b == 0.0:
        return 0.0
    return _up(a * b)


def _passthrough(ins: List[AbsVal], *_a: Any) -> List[AbsVal]:
    return [ins[0]]


def _select(ins: List[AbsVal], *_a: Any) -> List[AbsVal]:
    return [ins[0].drop_lo()]


def _join_drop_lo(vals: Sequence[AbsVal]) -> AbsVal:
    return join_all(list(vals)).drop_lo()


def _t_concatenate(ins, eqn, in_avals, out_avals):
    out = join_all(ins)
    return [dataclasses.replace(out, lo=max(v.lo for v in ins))]


def _t_pad(ins, eqn, in_avals, out_avals):
    return [_join_drop_lo(ins[:2])]


def _t_select_n(ins, eqn, in_avals, out_avals):
    return [_join_drop_lo(ins[1:])]


def _t_clamp(ins, eqn, in_avals, out_avals):
    return [_join_drop_lo(ins)]


def _t_dus(ins, eqn, in_avals, out_avals):
    return [_join_drop_lo(ins[:2])]


def _t_max(ins, eqn, in_avals, out_avals):
    a, b = ins[0], ins[1]
    out = join(a, b)
    lo = 0.0
    if a.nonneg and b.nonneg:
        lo = max(a.lo, b.lo)
    elif a.nonneg:
        lo = a.lo
    elif b.nonneg:
        lo = b.lo
    return [dataclasses.replace(out, lo=lo, nonneg=a.nonneg or b.nonneg)]


def _t_min(ins, eqn, in_avals, out_avals):
    return [_join_drop_lo(ins[:2])]


def _t_abs(ins, eqn, in_avals, out_avals):
    return [dataclasses.replace(ins[0], nonneg=True)]


def _t_neg(ins, eqn, in_avals, out_avals):
    return [dataclasses.replace(ins[0], nonneg=ins[0].hi == 0.0)]


def _t_sign(ins, eqn, in_avals, out_avals):
    return [AbsVal(hi=1.0, lo=0.0, min_nz=1.0, ulp_exp=0.0, rel_bits=0.0,
                   nonneg=ins[0].nonneg)]


def _t_round(ins, eqn, in_avals, out_avals):
    a = ins[0]
    hi = _up(a.hi + 1.0)
    ulp = max(a.ulp_exp, 0.0)
    return [AbsVal(hi=hi, lo=0.0, min_nz=1.0 if a.finite else 0.0,
                   ulp_exp=ulp, rel_bits=_rel_from(hi, ulp),
                   nonneg=a.nonneg)]


def _t_iota(ins, eqn, in_avals, out_avals):
    shape = eqn.params.get("shape", _shape(out_avals[0]))
    dim = eqn.params.get("dimension", 0)
    n = int(shape[dim]) if shape else 1
    hi = float(max(n - 1, 0))
    return [AbsVal(hi=hi, lo=hi, min_nz=1.0 if n > 1 else 0.0, ulp_exp=0.0,
                   rel_bits=_rel_from(hi, 0.0), nonneg=True)]


def _t_add(ins, eqn, in_avals, out_avals):
    a, b = ins[0], ins[1]
    hi = _up(a.hi + b.hi)
    ulp = min(a.ulp_exp, b.ulp_exp)
    rel = min(_rel_from(hi, ulp), a.rel_bits + b.rel_bits + 54)
    nonneg = a.nonneg and b.nonneg
    lo = _dn(max(a.lo, b.lo)) if nonneg else 0.0
    return [AbsVal(hi=hi, lo=lo, min_nz=0.0, ulp_exp=ulp, rel_bits=rel,
                   nonneg=nonneg)]


def _t_sub(ins, eqn, in_avals, out_avals):
    a, b = ins[0], ins[1]
    hi = _up(a.hi + b.hi)
    ulp = min(a.ulp_exp, b.ulp_exp)
    return [AbsVal(hi=hi, lo=0.0, min_nz=0.0, ulp_exp=ulp,
                   rel_bits=_rel_from(hi, ulp),
                   nonneg=a.nonneg and b.hi == 0.0)]


def _t_mul(ins, eqn, in_avals, out_avals):
    a, b = ins[0], ins[1]
    hi = _mul_hi(a.hi, b.hi)
    ulp = a.ulp_exp + b.ulp_exp
    rel = a.rel_bits + b.rel_bits
    min_nz = _dn(a.min_nz * b.min_nz)
    lo = 0.0
    # a scalar factor of known magnitude scales the max element directly
    if _is_scalar(in_avals[1]) and b.nonneg and b.lo > 0:
        lo = _dn(a.lo * b.lo)
    elif _is_scalar(in_avals[0]) and a.nonneg and a.lo > 0:
        lo = _dn(b.lo * a.lo)
    return [AbsVal(hi=hi, lo=lo, min_nz=min_nz, ulp_exp=ulp, rel_bits=rel,
                   nonneg=a.nonneg and b.nonneg)]


def _t_div(ins, eqn, in_avals, out_avals):
    a, b = ins[0], ins[1]
    hi = math.inf
    lo = 0.0
    if _is_scalar(in_avals[1]) and b.nonneg and b.lo > 0:
        # scalar divisor bounded away from zero: |a/b| <= hi_a / b
        hi = _up(a.hi / b.lo) if math.isfinite(a.hi) else math.inf
        if math.isfinite(b.hi) and b.hi > 0:
            lo = _dn(a.lo / b.hi)
    min_nz = _dn(a.min_nz / b.hi) if (math.isfinite(b.hi) and b.hi > 0
                                      and a.min_nz > 0) else 0.0
    return [AbsVal(hi=hi, lo=lo, min_nz=min_nz, ulp_exp=-math.inf,
                   rel_bits=math.inf, nonneg=a.nonneg and b.nonneg)]


def _t_dot(ins, eqn, in_avals, out_avals):
    a, b = ins[0], ins[1]
    n = max(int(eqn.params.get("n", 1)), 1)
    hi = _mul_hi(float(n), _mul_hi(a.hi, b.hi))
    ulp = a.ulp_exp + b.ulp_exp
    return [AbsVal(hi=hi, lo=0.0, min_nz=0.0, ulp_exp=ulp,
                   rel_bits=_rel_from(hi, ulp),
                   nonneg=a.nonneg and b.nonneg)]


def _t_conv(ins, eqn, in_avals, out_avals):
    a, b = ins[0], ins[1]
    n = 1
    for d in _shape(in_avals[1]):
        n *= int(d)
    hi = _mul_hi(float(max(n, 1)), _mul_hi(a.hi, b.hi))
    ulp = a.ulp_exp + b.ulp_exp
    return [AbsVal(hi=hi, lo=0.0, min_nz=0.0, ulp_exp=ulp,
                   rel_bits=_rel_from(hi, ulp),
                   nonneg=a.nonneg and b.nonneg)]


def _reduced_size(eqn, in_avals) -> int:
    return max(int(eqn.params.get("n_reduced", 1)), 1)


def _t_reduce_sum(ins, eqn, in_avals, out_avals):
    a = ins[0]
    n = _reduced_size(eqn, in_avals)
    hi = _mul_hi(float(n), a.hi)
    lo = _dn(a.lo) if a.nonneg else 0.0
    min_nz = _dn(a.min_nz) if a.nonneg else 0.0
    return [AbsVal(hi=hi, lo=lo, min_nz=min_nz, ulp_exp=a.ulp_exp,
                   rel_bits=_rel_from(hi, a.ulp_exp), nonneg=a.nonneg)]


def _t_cumsum(ins, eqn, in_avals, out_avals):
    a = ins[0]
    n = _reduced_size(eqn, in_avals)
    hi = _mul_hi(float(max(n, 1)), a.hi)
    lo = _dn(a.lo) if a.nonneg else 0.0
    return [AbsVal(hi=hi, lo=lo, min_nz=0.0, ulp_exp=a.ulp_exp,
                   rel_bits=_rel_from(hi, a.ulp_exp), nonneg=a.nonneg)]


def _t_reduce_max(ins, eqn, in_avals, out_avals):
    a = ins[0]
    return [dataclasses.replace(a, lo=a.lo if a.nonneg else 0.0)]


def _t_reduce_min(ins, eqn, in_avals, out_avals):
    return [ins[0].drop_lo()]


def _t_reduce_prod(ins, eqn, in_avals, out_avals):
    a = ins[0]
    n = _reduced_size(eqn, in_avals)
    try:
        hi = _up(max(a.hi ** n, 1.0))
    except OverflowError:
        hi = math.inf
    ulp = a.ulp_exp * n if math.isfinite(a.ulp_exp) else -math.inf
    rel = a.rel_bits * n if math.isfinite(a.rel_bits) else math.inf
    return [AbsVal(hi=hi, lo=0.0, min_nz=0.0, ulp_exp=min(ulp, 0.0) if n
                   else 0.0, rel_bits=rel, nonneg=a.nonneg)]


def _safe_exp(x: float) -> float:
    if x > 700.0:
        return math.inf
    return math.exp(x)


def _t_exp(ins, eqn, in_avals, out_avals):
    a = ins[0]
    if not a.finite:
        return [AbsVal(hi=math.inf, nonneg=True)]
    hi = _up(_safe_exp(a.hi))
    floor = _dn(_safe_exp(-a.hi) if a.hi < 700.0 else 0.0)
    # every element satisfies x >= -hi, so exp(x) >= exp(-hi) > 0
    return [AbsVal(hi=hi, lo=floor, min_nz=floor, ulp_exp=-math.inf,
                   rel_bits=math.inf, nonneg=True)]


def _t_exp2(ins, eqn, in_avals, out_avals):
    a = ins[0]
    if not a.finite:
        return [AbsVal(hi=math.inf, nonneg=True)]
    hi = _up(_safe_exp(a.hi * math.log(2.0)))
    floor = _dn(1.0 / hi) if math.isfinite(hi) and hi > 0 else 0.0
    return [AbsVal(hi=hi, lo=floor, min_nz=floor, ulp_exp=-math.inf,
                   rel_bits=math.inf, nonneg=True)]


def _t_sqrt(ins, eqn, in_avals, out_avals):
    a = ins[0]
    if not (a.finite and a.nonneg):
        return [AbsVal(hi=math.inf, nonneg=True)]
    return [AbsVal(hi=_up(math.sqrt(a.hi)), lo=_dn(math.sqrt(a.lo)),
                   min_nz=_dn(math.sqrt(a.min_nz)), ulp_exp=-math.inf,
                   rel_bits=math.inf, nonneg=True)]


def _t_rsqrt(ins, eqn, in_avals, out_avals):
    a = ins[0]
    min_nz = _dn(1.0 / math.sqrt(a.hi)) if (a.finite and a.hi > 0) else 0.0
    return [AbsVal(hi=math.inf, lo=0.0, min_nz=min_nz, ulp_exp=-math.inf,
                   rel_bits=math.inf, nonneg=True)]


def _bounded(cap: float, keep_nonneg: bool = True
             ) -> Callable[..., List[AbsVal]]:
    def t(ins, eqn, in_avals, out_avals):
        a = ins[0]
        return [AbsVal(hi=min(_up(a.hi), cap), lo=0.0, min_nz=0.0,
                       ulp_exp=-math.inf, rel_bits=math.inf,
                       nonneg=a.nonneg and keep_nonneg)]
    return t


def _t_logistic(ins, eqn, in_avals, out_avals):
    return [AbsVal(hi=1.0, lo=0.0, min_nz=0.0, ulp_exp=-math.inf,
                   rel_bits=math.inf, nonneg=True)]


def _t_cos(ins, eqn, in_avals, out_avals):
    return [AbsVal(hi=1.0)]


def _t_integer_pow(ins, eqn, in_avals, out_avals):
    a = ins[0]
    y = int(eqn.params.get("y", 2))
    if y <= 0:
        return [AbsVal(hi=math.inf, nonneg=(y == 0))]
    try:
        hi = _up(a.hi ** y) if a.finite else math.inf
    except OverflowError:
        hi = math.inf
    ulp = a.ulp_exp * y if math.isfinite(a.ulp_exp) else -math.inf
    rel = a.rel_bits * y if math.isfinite(a.rel_bits) else math.inf
    try:
        min_nz = _dn(a.min_nz ** y)
        lo = _dn(a.lo ** y)
    except OverflowError:
        min_nz, lo = 0.0, 0.0
    return [AbsVal(hi=hi, lo=lo, min_nz=min_nz, ulp_exp=ulp, rel_bits=rel,
                   nonneg=a.nonneg or y % 2 == 0)]


def _t_convert(ins, eqn, in_avals, out_avals):
    a = ins[0]
    out_dt = out_avals[0].dtype
    kind = _kind(out_dt)
    if kind == "f":
        # rounding onto the new carrier can raise |x| by <= half an ulp,
        # comfortably inside the _up margin; grid facts are resealed below
        return [dataclasses.replace(a, hi=_up(a.hi))]
    if kind in ("i", "u"):
        cap, _ = _int_range(out_dt)
        hi = min(a.hi, cap)
        return [AbsVal(hi=hi, lo=0.0, min_nz=0.0, ulp_exp=0.0,
                       rel_bits=_rel_from(hi, 0.0), nonneg=a.nonneg)]
    if kind == "b":
        return [_BOOL]
    return [_TOP]


def _t_scatter_add(ins, eqn, in_avals, out_avals):
    op, upd = ins[0], ins[2]
    n = 1
    for d in _shape(in_avals[2]):
        n *= int(d)
    hi = _up(op.hi + max(n, 1) * upd.hi)
    ulp = min(op.ulp_exp, upd.ulp_exp)
    return [AbsVal(hi=hi, lo=0.0, min_nz=0.0, ulp_exp=ulp,
                   rel_bits=_rel_from(hi, ulp),
                   nonneg=op.nonneg and upd.nonneg)]


def _t_scatter(ins, eqn, in_avals, out_avals):
    return [_join_drop_lo([ins[0], ins[2]])]


def _t_bool(ins, eqn, in_avals, out_avals):
    return [_BOOL for _ in out_avals]


def _t_log1p(ins, eqn, in_avals, out_avals):
    a = ins[0]
    if a.finite and a.nonneg:
        return [AbsVal(hi=_up(math.log1p(a.hi)), nonneg=True)]
    return [AbsVal(hi=math.inf)]


def _t_expm1(ins, eqn, in_avals, out_avals):
    a = ins[0]
    if not a.finite:
        return [AbsVal(hi=math.inf, nonneg=a.nonneg)]
    hi = _up(max(_safe_exp(a.hi), 1.0))
    return [AbsVal(hi=hi, nonneg=a.nonneg)]


_TRANSFERS: Dict[str, Callable[..., List[AbsVal]]] = {
    # structure-preserving (all facts, including lo)
    "reshape": _passthrough, "transpose": _passthrough, "rev": _passthrough,
    "copy": _passthrough, "squeeze": _passthrough,
    "expand_dims": _passthrough, "broadcast_in_dim": _passthrough,
    "broadcast": _passthrough, "stop_gradient": _passthrough,
    "optimization_barrier": _passthrough, "sharding_constraint": _passthrough,
    "layout_constraint": _passthrough, "real": _passthrough,
    "device_put": _passthrough, "sort": _passthrough, "copy_p": _passthrough,
    "reduce_precision": _passthrough,
    # element selection (drop lo)
    "slice": _select, "gather": _select, "dynamic_slice": _select,
    "split": lambda ins, eqn, ia, oa: [ins[0].drop_lo() for _ in oa],
    "select_n": _t_select_n, "clamp": _t_clamp,
    "dynamic_update_slice": _t_dus, "scatter": _t_scatter,
    "concatenate": _t_concatenate, "pad": _t_pad,
    "max": _t_max, "min": _t_min,
    "reduce_max": _t_reduce_max, "reduce_min": _t_reduce_min,
    "cummax": _t_reduce_max, "cummin": _t_reduce_min,
    # sign-structure
    "abs": _t_abs, "neg": _t_neg, "sign": _t_sign,
    "floor": _t_round, "ceil": _t_round, "round": _t_round,
    "iota": _t_iota,
    # arithmetic
    "add": _t_add, "sub": _t_sub, "mul": _t_mul, "div": _t_div,
    "dot_general": _t_dot, "conv_general_dilated": _t_conv,
    "ragged_dot": _t_conv,
    "reduce_sum": _t_reduce_sum, "cumsum": _t_cumsum,
    "reduce_prod": _t_reduce_prod,
    "integer_pow": _t_integer_pow,
    "scatter-add": _t_scatter_add,
    # transcendental
    "exp": _t_exp, "exp2": _t_exp2, "log1p": _t_log1p, "expm1": _t_expm1,
    "sqrt": _t_sqrt, "rsqrt": _t_rsqrt,
    "tanh": _bounded(1.0), "erf": _bounded(1.0),
    "sin": _bounded(1.0, keep_nonneg=False), "cos": _t_cos,
    "logistic": _t_logistic,
    "atan": _bounded(1.5708, keep_nonneg=False),
    "atan2": lambda ins, eqn, ia, oa: [AbsVal(hi=3.1416)],
    "convert_element_type": _t_convert,
    # predicates
    "eq": _t_bool, "ne": _t_bool, "lt": _t_bool, "le": _t_bool,
    "gt": _t_bool, "ge": _t_bool, "and": _t_bool, "or": _t_bool,
    "not": _t_bool, "xor": _t_bool, "is_finite": _t_bool,
    "reduce_and": _t_bool, "reduce_or": _t_bool,
}


def transfer(call: Call, invals: List[AbsVal]) -> List[AbsVal]:
    """Abstractly evaluate one call; results are sealed with each output's
    carrier dtype. Unknown primitives fall back to the carrier top — the
    conservative default that keeps everything sound."""
    out_avals = list(call.out_avals)
    in_avals = list(call.in_avals)
    fn = _TRANSFERS.get(call.prim)
    if fn is None:
        outs: List[AbsVal] = [of_aval(a) for a in out_avals]
    else:
        try:
            outs = fn(invals, call, in_avals, out_avals)
        except Exception:
            outs = [of_aval(a) for a in out_avals]
        if len(outs) != len(out_avals):
            outs = [of_aval(a) for a in out_avals]
    return [seal(o, a.dtype) for o, a in zip(outs, out_avals)]
