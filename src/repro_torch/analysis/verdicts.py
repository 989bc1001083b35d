"""Per-scope, per-rung static verdicts over an :class:`AnalysisResult`
(the port's copy of the reference package's ``analysis/verdicts.py``, over
the port's ``SiteIndex``: a record's key is the site's lookup key).

For each candidate ``(exp_bits, man_bits)`` rung of each search scope:

  * ``EXACT`` — every site the rung's solo rule matches holds values that
    are bit-exactly representable in the rung's format, so the solo
    truncated run is bit-identical to the reference (quantize is the
    identity on every value that reaches it, by induction over program
    order). The dynamic probe would measure ``metric(ref, ref)``.
  * ``OVERFLOW_CERTAIN`` — some matched site provably reaches the format's
    round-to-inf boundary (its ``lo`` lower-bounds the max magnitude), the
    format maps overflow to ``inf`` (IEEE, non-saturating), and the
    non-finite provably propagates to a program output (the site is
    *critical*). The dynamic probe would measure a non-finite error.
  * ``UNKNOWN`` — keep dynamic probing.

Per-site records soundly over-approximate the concrete reference run
whether or not the *abstract* envelope of the program outputs stays
finite, so verdicts are decided from the records alone. The one fact
that cannot be established here — that ``metric(ref, ref)`` is exactly
``0.0``, which is what an EXACT rung's probe would measure — is
validated *dynamically* by the search driver against the concrete
reference outputs it computes anyway (a loud error on violation, never
a silent divergence from the unpruned search).

*Universal* exactness is the stronger, value-independent fact that the
rung's format can represent every value of the site's carrier dtype
(grid ⊇ carrier grid, range ⊇ carrier range, infs preserved): the
quantize is then the literal identity on ANY input — including inputs
already perturbed by truncation elsewhere — which is what licenses
skipping a scope's trial-exclusion eval inside a joint policy.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.formats import FPFormat
from repro_torch.core.policy import TruncationPolicy, TruncationRule
from repro_torch.analysis.domain import (
    AbsVal, carrier_format, top_for_dtype,
)
from repro_torch.analysis.interp import AnalysisResult

_MARGIN = 1.0 + 2.0 ** -20


class Verdict(str, enum.Enum):
    EXACT = "EXACT"
    OVERFLOW_CERTAIN = "OVERFLOW_CERTAIN"
    UNKNOWN = "UNKNOWN"


def rne_overflow_boundary(fmt: FPFormat) -> float:
    """Magnitudes at or above this round to ``inf`` under round-to-nearest-
    even in ``fmt`` (the midpoint between ``max_finite`` and the first
    non-representable binade step)."""
    return float(2.0 ** fmt.max_exp * (2.0 - 2.0 ** -(fmt.man_bits + 1)))


def exact_in(fmt: FPFormat, v: AbsVal,
             carrier: Optional[FPFormat]) -> bool:
    """Every concrete value in ``v`` quantizes to itself in ``fmt``."""
    range_ok = v.hi <= fmt.max_finite or (
        carrier is not None
        and carrier.max_finite <= fmt.max_finite
        and fmt.ieee_inf and not fmt.saturate)
    return (range_ok
            and v.rel_bits <= fmt.man_bits
            and v.ulp_exp >= fmt.min_exp - fmt.man_bits)


def universally_exact(fmt: FPFormat, dtype: Any) -> bool:
    """``fmt`` represents every value of carrier ``dtype`` bit-exactly —
    quantize is the identity on arbitrary inputs of that dtype."""
    carrier = carrier_format(dtype)
    if carrier is None:
        return False
    return exact_in(fmt, top_for_dtype(dtype), carrier)


def overflow_certain(fmt: FPFormat, v: AbsVal, critical: bool) -> bool:
    """Quantizing ``v`` in ``fmt`` provably yields ``inf`` at every
    execution, and that inf provably reaches a program output."""
    return (critical
            and fmt.ieee_inf and not fmt.saturate
            and math.isfinite(v.hi)
            and v.lo >= rne_overflow_boundary(fmt) * _MARGIN)


@dataclasses.dataclass
class StaticVerdicts:
    """Rung verdicts for a search frontier, plus the universal-exact sets."""

    verdicts: Dict[str, Dict[int, Verdict]]
    universal: Dict[str, frozenset]
    outputs_finite: bool
    n_decided: int

    def get(self, path: str, man_bits: int) -> Verdict:
        return self.verdicts.get(path, {}).get(man_bits, Verdict.UNKNOWN)

    def is_universal(self, path: str, man_bits: int) -> bool:
        return man_bits in self.universal.get(path, frozenset())

    def to_json(self) -> Dict[str, Dict[str, str]]:
        return {path: {f"m{w}": v.value for w, v in sorted(rungs.items(),
                                                           reverse=True)}
                for path, rungs in self.verdicts.items()}


def scope_rung_verdicts(result: AnalysisResult, index: Any,
                        scope_paths: Sequence[str],
                        cand_widths: Sequence[int],
                        exp_bits: int) -> StaticVerdicts:
    """Judge every ``(scope, man_bits)`` rung of the search ladder.

    ``index`` is the search's ``SiteIndex`` (enumerated from the same call
    as ``result`` was analysed, so record keys line up). A rung is EXACT
    only if ALL sites its solo rule matches are exact (zero matched sites
    is vacuously exact: the rung's policy is a no-op); OVERFLOW_CERTAIN if
    ANY matched site certainly overflows into an output."""
    keys = index.site_keys()
    outputs_finite = result.outputs_finite
    verdicts: Dict[str, Dict[int, Verdict]] = {}
    universal: Dict[str, frozenset] = {}
    n_decided = 0
    probe_fmt = FPFormat(exp_bits, 0)
    for path in scope_paths:
        probe = TruncationPolicy(rules=(
            TruncationRule(fmt=probe_fmt, scope=path),))
        # rule matching is format-independent: resolve the matched site
        # set once per scope
        matched = [s for s in index.sites
                   if probe.rule_for(s.stack, s.prim, s.dtype) is not None]
        rungs: Dict[int, Verdict] = {}
        uni: List[int] = []
        for w in cand_widths:
            fmt = FPFormat(exp_bits, int(w))
            if all(universally_exact(fmt, s.dtype) for s in matched):
                uni.append(int(w))
            all_exact = True
            any_overflow = False
            for s in matched:
                key = keys[s.index]
                v = result.records.get(key)
                if v is None:
                    # no record for this site: exact only when the format
                    # covers the site's whole carrier grid (any sealed
                    # record would pass exact_in then, so this subsumes it)
                    if not universally_exact(fmt, s.dtype):
                        all_exact = False
                    continue
                if not exact_in(fmt, v, carrier_format(s.dtype)):
                    all_exact = False
                if overflow_certain(fmt, v, result.critical_at(key)):
                    any_overflow = True
            if any_overflow:
                rungs[int(w)] = Verdict.OVERFLOW_CERTAIN
            elif all_exact:
                rungs[int(w)] = Verdict.EXACT
            else:
                rungs[int(w)] = Verdict.UNKNOWN
        n_decided += sum(1 for v in rungs.values() if v != Verdict.UNKNOWN)
        verdicts[path] = rungs
        universal[path] = frozenset(uni)
    return StaticVerdicts(verdicts=verdicts, universal=universal,
                          outputs_finite=outputs_finite,
                          n_decided=n_decided)
