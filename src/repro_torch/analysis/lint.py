"""Static linting of truncation policies and policy artifacts: the checks
that need no execution, only the policy structure and (optionally) the
quantize sites of the model it will be deployed against.

  * ``mask-not-serializable`` — a rule carries a dynamic-mask callable;
    such a policy cannot round-trip through a ``PolicyArtifact``
    (error when ``serializable_required``, warning otherwise).
  * ``shadowed-rule`` — a rule is fully covered by an earlier rule (or,
    with model sites, matches sites but first-match never selects it).
  * ``excluded-rule`` — a policy-level exclude covers a rule's whole
    scope, so the rule can never fire.
  * ``dead-rule`` — with model sites: a rule that matches zero enumerable
    quantize sites (typo'd scope, wrong dtype filter, ...).
  * ``scope-drift-missing`` / ``scope-drift-new`` — an artifact's
    per-scope assignments vs the current model's scope frontier: a
    committed assignment whose scope no longer exists is an error; a new
    frontier scope the artifact has never judged is a warning.

``Registry.save`` runs ``lint_artifact`` before publishing (errors block,
warnings are recorded in provenance), as the reference package's does, so
an artifact published by either package carries the same lint record. Not
ported yet: the ``dot-accumulator-risk`` check (it needs the static range
analysis) and the command line.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.policy import (
    TruncationPolicy, TruncationRule, compile_scope, normalize_stack,
    scope_matches,
)

ERROR = "error"
WARNING = "warning"


class ArtifactLintError(ValueError):
    """An artifact failed lint with error-level findings; raised by
    ``Registry.save`` to block publication."""

    def __init__(self, findings: Sequence["Finding"]):
        self.findings = list(findings)
        lines = [f.render() for f in self.findings if f.level == ERROR]
        super().__init__("policy artifact failed lint:\n  "
                         + "\n  ".join(lines))


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str
    level: str                      # "error" | "warning"
    message: str
    scope: Optional[str] = None
    rule_index: Optional[int] = None

    def render(self) -> str:
        where = ""
        if self.rule_index is not None:
            where = f" [rule #{self.rule_index}]"
        elif self.scope is not None:
            where = f" [{self.scope}]"
        return f"{self.level.upper()} {self.code}{where}: {self.message}"


def errors(findings: Sequence[Finding]) -> List[Finding]:
    return [f for f in findings if f.level == ERROR]


# --------------------------------------------------------------------------
# structural rule coverage (no model needed)
# --------------------------------------------------------------------------

def _scope_covers(pa: str, pb: str) -> bool:
    """Conservative: True only when every stack pattern ``pb`` can match
    is also matched by ``pa``."""
    if pa == "**" or pa == pb:
        return True
    if "*" not in pb and "?" not in pb:
        # pb is concrete; scope matching extends over '/'-suffixes, and
        # pa matching pb implies pa matches every pb/... extension too
        return scope_matches(compile_scope(pa), pb)
    return False


def _ops_cover(a: TruncationRule, b: TruncationRule) -> bool:
    """True only when every primitive ``b`` can match is matched by ``a``."""
    if a.ops is None:
        if not a.exclude_ops:
            return True
        if b.ops is not None:
            return not (set(a.exclude_ops)
                        & (set(b.ops) - set(b.exclude_ops)))
        return set(a.exclude_ops) <= set(b.exclude_ops)
    if b.ops is None:
        return False
    return ((set(b.ops) - set(b.exclude_ops))
            <= (set(a.ops) - set(a.exclude_ops)))


def covers(a: TruncationRule, b: TruncationRule) -> bool:
    """``a`` earlier than ``b`` in a first-match-wins list: does ``a``
    match everything ``b`` matches (making ``b`` dead)? Conservative —
    False whenever coverage cannot be proven."""
    if a.from_width is not None and a.from_width != b.from_width:
        return False
    return _scope_covers(a.scope, b.scope) and _ops_cover(a, b)


# --------------------------------------------------------------------------
# policy lint
# --------------------------------------------------------------------------

def _rule_matches_site(policy: TruncationPolicy, rule_idx: int,
                       site: Any) -> bool:
    stack = normalize_stack(site.stack)
    for rx in policy._ex_rx:
        if scope_matches(rx, stack):
            return False
    return policy.rules[rule_idx].matches(stack, site.prim, site.dtype)


def _winning_rule(policy: TruncationPolicy, site: Any) -> Optional[int]:
    stack = normalize_stack(site.stack)
    for rx in policy._ex_rx:
        if scope_matches(rx, stack):
            return None
    for i, rule in enumerate(policy.rules):
        if rule.matches(stack, site.prim, site.dtype):
            return i
    return None


def lint_policy(policy: TruncationPolicy, *,
                sites: Optional[Sequence[Any]] = None,
                analysis_result: Any = None,
                index: Any = None,
                serializable_required: bool = False) -> List[Finding]:
    """Lint one policy. ``sites`` (``QuantizeSite``-like: ``.stack`` /
    ``.prim`` / ``.dtype`` / ``.index``) enables the model-aware checks.
    ``analysis_result`` + ``index`` (the accumulator-risk check) need the
    range analysis, which is not ported yet: they raise."""
    if analysis_result is not None or index is not None:
        raise NotImplementedError(
            "lint_policy(analysis_result=..., index=...) needs the static "
            "range analysis, which is not ported yet")
    findings: List[Finding] = []

    for i, rule in enumerate(policy.rules):
        if rule.mask is not None:
            findings.append(Finding(
                code="mask-not-serializable",
                level=ERROR if serializable_required else WARNING,
                message=(f"rule scope={rule.scope!r} carries dynamic mask "
                         f"{getattr(rule.mask, '__name__', rule.mask)!r}; "
                         "it cannot be serialized into a policy artifact"),
                scope=rule.scope, rule_index=i))

    # structural shadowing / exclusion (first matching rule wins)
    for i, rule in enumerate(policy.rules):
        for pat in policy.excludes:
            if _scope_covers(pat, rule.scope):
                findings.append(Finding(
                    code="excluded-rule", level=WARNING,
                    message=(f"rule scope={rule.scope!r} is entirely "
                             f"covered by policy exclude {pat!r} and can "
                             "never fire"),
                    scope=rule.scope, rule_index=i))
                break
        else:
            for j in range(i):
                if covers(policy.rules[j], rule):
                    findings.append(Finding(
                        code="shadowed-rule", level=WARNING,
                        message=(f"rule scope={rule.scope!r} is fully "
                                 f"shadowed by earlier rule #{j} "
                                 f"(scope={policy.rules[j].scope!r}); "
                                 "first match wins, so it never fires"),
                        scope=rule.scope, rule_index=i))
                    break

    if sites is not None:
        structurally_dead = {f.rule_index for f in findings
                             if f.code in ("shadowed-rule", "excluded-rule")}
        wins: Dict[int, int] = {}
        for s in sites:
            w = _winning_rule(policy, s)
            if w is not None:
                wins[w] = wins.get(w, 0) + 1
        for i, rule in enumerate(policy.rules):
            if i in structurally_dead or wins.get(i):
                continue
            if any(_rule_matches_site(policy, i, s) for s in sites):
                findings.append(Finding(
                    code="shadowed-rule", level=WARNING,
                    message=(f"rule scope={rule.scope!r} matches sites in "
                             "this model, but an earlier rule wins every "
                             "one of them"),
                    scope=rule.scope, rule_index=i))
            else:
                findings.append(Finding(
                    code="dead-rule", level=WARNING,
                    message=(f"rule scope={rule.scope!r} matches zero "
                             "enumerable quantize sites in this model"),
                    scope=rule.scope, rule_index=i))

    return findings


# --------------------------------------------------------------------------
# artifact lint
# --------------------------------------------------------------------------

def lint_artifact(artifact: Any, *,
                  scopes: Optional[Sequence[str]] = None,
                  sites: Optional[Sequence[Any]] = None,
                  analysis_result: Any = None,
                  index: Any = None) -> List[Finding]:
    """Lint a ``PolicyArtifact`` (duck-typed: ``.policy``,
    ``.assignments``, ``.name``). ``scopes`` is the current model's
    enumerable scope frontier (``discover_scopes`` paths) for the
    drift checks."""
    findings = lint_policy(artifact.policy, sites=sites,
                           analysis_result=analysis_result, index=index,
                           serializable_required=True)
    if scopes is not None:
        current = set(scopes)
        assigned = set(artifact.assignments)
        for path in sorted(assigned - current):
            findings.append(Finding(
                code="scope-drift-missing", level=ERROR,
                message=(f"artifact assigns scope {path!r} which is not on "
                         "the current model's scope frontier — the "
                         "deployed policy no longer matches the model it "
                         "was searched on"),
                scope=path))
        for path in sorted(current - assigned):
            findings.append(Finding(
                code="scope-drift-new", level=WARNING,
                message=(f"model scope {path!r} is not judged by the "
                         "artifact (stays full precision); re-search to "
                         "cover it"),
                scope=path))
    return findings


__all__ = ["ArtifactLintError", "Finding", "errors", "covers",
           "lint_artifact", "lint_policy"]
