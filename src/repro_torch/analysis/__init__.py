"""Static numerical analysis: abstract interpretation of one run of a
program (range / exactness facts, overflow criticality), per-rung search
verdicts, and the policy / artifact linter — the reference package's
``repro.analysis`` names, with ``analyze(fn, args)`` in place of
``analyze_closed(jaxpr)``."""
from repro_torch.analysis.domain import (
    AbsVal, carrier_format, from_concrete, join, leq, of_aval, seal,
    top_for_dtype, transfer,
)
from repro_torch.analysis.interp import AnalysisResult, DotInputs, analyze
from repro_torch.analysis.verdicts import (
    StaticVerdicts, Verdict, exact_in, overflow_certain,
    rne_overflow_boundary, scope_rung_verdicts, universally_exact,
)
from repro_torch.analysis.lint import (
    ArtifactLintError, Finding, lint_artifact, lint_policy,
)

__all__ = [
    "AbsVal", "AnalysisResult", "ArtifactLintError", "DotInputs",
    "Finding", "StaticVerdicts", "Verdict", "analyze",
    "carrier_format", "exact_in", "from_concrete", "join", "leq",
    "lint_artifact", "lint_policy", "of_aval", "overflow_certain",
    "rne_overflow_boundary", "scope_rung_verdicts", "seal",
    "top_for_dtype", "transfer", "universally_exact",
]
