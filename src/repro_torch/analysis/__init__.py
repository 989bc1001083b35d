"""Static analysis of policies. Ported so far: the policy/artifact linter
(its structural and site checks); the abstract interpretation and per-rung
verdicts of the reference package are not ported yet."""
from repro_torch.analysis.lint import (
    ArtifactLintError, Finding, lint_artifact, lint_policy,
)

__all__ = ["ArtifactLintError", "Finding", "lint_artifact", "lint_policy"]
