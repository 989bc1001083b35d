"""Floating-point format algebra (framework-free; the port's own copy of
the reference package's ``core/formats.py``, same names and same JSON).

The paper's truncation target is a pair ``(exponent_bits, mantissa_bits)``
(RAPTOR flag ``--raptor-truncate-all=64_to_5_14``).  ``FPFormat`` captures
that pair plus the overflow convention, and knows how to describe its own
representable grid (bias, min/max exponent, subnormal spacing) — everything
the quantizer and the speedup model need.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FPFormat:
    """An IEEE-754-style binary format with 1 sign bit, ``exp_bits`` exponent
    bits and ``man_bits`` *stored* mantissa bits (implicit leading one).

    ``saturate``: on overflow, clamp to the max finite value (OCP e4m3
    convention) instead of producing ±inf (e5m2 / IEEE convention).
    """

    exp_bits: int
    man_bits: int
    saturate: bool = False
    ieee_inf: bool = True  # False = "fn" layout: no inf, top exponent reclaimed
    name: Optional[str] = None

    def __post_init__(self):
        if not (1 <= self.exp_bits <= 11):
            raise ValueError(f"exp_bits must be in [1, 11], got {self.exp_bits}")
        if not (0 <= self.man_bits <= 52):
            raise ValueError(f"man_bits must be in [0, 52], got {self.man_bits}")

    # --- derived constants -------------------------------------------------
    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def max_exp(self) -> int:
        """Largest unbiased exponent of a finite normal number."""
        off = 2 if self.ieee_inf else 1
        return (1 << self.exp_bits) - off - self.bias

    @property
    def min_exp(self) -> int:
        """Smallest unbiased exponent of a normal number."""
        return 1 - self.bias

    @property
    def max_finite(self) -> float:
        if self.ieee_inf:
            return float(2.0 ** self.max_exp * (2.0 - 2.0 ** (-self.man_bits)))
        # fn layout: all-ones exponent+mantissa is NaN, so the top mantissa
        # slot at the top exponent is lost (e4m3fn max = 448).
        return float(2.0 ** self.max_exp * (2.0 - 2.0 ** (1 - self.man_bits)))

    @property
    def min_normal(self) -> float:
        return float(2.0 ** self.min_exp)

    @property
    def min_subnormal(self) -> float:
        return float(2.0 ** (self.min_exp - self.man_bits))

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    # --- identity ----------------------------------------------------------
    @property
    def key(self) -> str:
        sat = "s" if self.saturate else ""
        return self.name or f"e{self.exp_bits}m{self.man_bits}{sat}"

    @property
    def cache_key(self) -> str:
        """Unambiguous identity string: unlike ``key`` it always spells out
        the overflow convention, so two formats that round differently can
        never alias in a trace cache."""
        return (f"e{self.exp_bits}m{self.man_bits}"
                f"{'s' if self.saturate else ''}"
                f"{'' if self.ieee_inf else 'fn'}")

    def __str__(self) -> str:
        return self.key

    def with_mantissa(self, man_bits: int) -> "FPFormat":
        return dataclasses.replace(self, man_bits=man_bits, name=None)

    # --- lossless JSON round trip -------------------------------------------
    def to_json(self) -> dict:
        """Every field spelled out — unlike ``key`` (which elides the inf
        convention) this can never alias two formats that round differently."""
        return {"exp_bits": self.exp_bits, "man_bits": self.man_bits,
                "saturate": self.saturate, "ieee_inf": self.ieee_inf,
                "name": self.name}

    @staticmethod
    def from_json(data: dict) -> "FPFormat":
        return FPFormat(exp_bits=int(data["exp_bits"]),
                        man_bits=int(data["man_bits"]),
                        saturate=bool(data["saturate"]),
                        ieee_inf=bool(data["ieee_inf"]),
                        name=data.get("name"))


# --- registry of common formats ---------------------------------------------
FP64 = FPFormat(11, 52, name="fp64")
FP32 = FPFormat(8, 23, name="fp32")
TF32 = FPFormat(8, 10, name="tf32")
BF16 = FPFormat(8, 7, name="bf16")
FP16 = FPFormat(5, 10, name="fp16")
E5M2 = FPFormat(5, 2, name="e5m2")
# OCP 8-bit formats. Both e4m3 entries use the "fn" exponent layout (no inf,
# top exponent reclaimed, max finite = 448 = ml_dtypes.float8_e4m3fn.max);
# they differ ONLY in overflow handling:
#   E4M3FN — overflow -> NaN, exactly the ml_dtypes/OCP cast convention
#            (cross-checked bit-for-bit in tests/test_formats_fp8.py)
#   E4M3   — overflow saturates to +/-448, the training-friendly convention
#            hardware quantizers use (e.g. TE's saturating cast)
E4M3 = FPFormat(4, 3, saturate=True, ieee_inf=False, name="e4m3")
E4M3FN = FPFormat(4, 3, saturate=False, ieee_inf=False, name="e4m3fn")

_REGISTRY = {f.key: f for f in (FP64, FP32, TF32, BF16, FP16, E5M2, E4M3, E4M3FN)}


def parse_format(spec) -> FPFormat:
    """Parse ``'bf16'``, ``'e5m14'``, ``'5_14'`` or an FPFormat instance."""
    if isinstance(spec, FPFormat):
        return spec
    s = str(spec).strip().lower()
    if s in _REGISTRY:
        return _REGISTRY[s]
    if s.startswith("e") and "m" in s:
        e, m = s[1:].split("m")
        sat = m.endswith("s")
        m = m.rstrip("s")
        return FPFormat(int(e), int(m), saturate=sat)
    if "_" in s:  # RAPTOR-style "5_14"
        e, m = s.split("_")
        return FPFormat(int(e), int(m))
    raise ValueError(f"unknown FP format spec: {spec!r}")


def is_hardware_format(fmt: FPFormat) -> bool:
    """True when ``fmt`` matches a storage type torch has on every device
    (float32, bfloat16, float16), in which case truncation can be a plain
    convert pair (RAPTOR's zero-overhead hardware path)."""
    return (fmt.exp_bits, fmt.man_bits) in {(8, 23), (8, 7), (5, 10)}
