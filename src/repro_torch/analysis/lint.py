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

  * ``dot-accumulator-risk`` — with model sites and a static analysis
    (``analysis.analyze``): a ``quantize_dot_inputs`` rule whose quantized
    operands can accumulate past the carrier's finite range.

``Registry.save`` runs ``lint_artifact`` before publishing (errors block,
warnings are recorded in provenance), as the reference package's does, so
an artifact published by either package carries the same lint record.

Command line (the reference's flags, messages and exit codes)::

    python -m repro_torch.analysis.lint artifacts/ [--no-model] [--strict]

An artifact named ``bench_model`` is also checked against the port's copy
of the benchmark model it was searched on (its scope frontier and sites).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.formats import FPFormat, parse_format
from repro_torch.core.policy import (
    TruncationPolicy, TruncationRule, compile_scope, normalize_stack,
    scope_matches,
)
from repro_torch.analysis.domain import carrier_format

ERROR = "error"
WARNING = "warning"

_DOT_PRIMS = frozenset({"dot_general", "conv_general_dilated", "ragged_dot"})


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
    ``.prim`` / ``.dtype`` / ``.index``) enables the model-aware checks;
    with ``analysis_result`` (``analysis.analyze`` of the same call) and
    ``index`` (its ``SiteIndex``) too, the accumulator-risk check."""
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

    if (sites is not None and analysis_result is not None
            and index is not None):
        findings.extend(_lint_dot_accumulators(policy, sites,
                                               analysis_result, index))
    return findings


def _lint_dot_accumulators(policy: TruncationPolicy, sites: Sequence[Any],
                           analysis_result: Any, index: Any
                           ) -> List[Finding]:
    findings: List[Finding] = []
    keys = index.site_keys()
    for s in sites:
        if s.prim not in _DOT_PRIMS:
            continue
        w = _winning_rule(policy, s)
        if w is None or not policy.rules[w].quantize_dot_inputs:
            continue
        d = analysis_result.dot_inputs.get(keys[s.index])
        carrier = carrier_format(s.dtype)
        if d is None or carrier is None:
            continue
        fmt = parse_format(policy.rules[w].fmt)
        qa = min(d.lhs.hi, fmt.max_finite)
        qb = min(d.rhs.hi, fmt.max_finite)
        acc = d.n * qa * qb
        if acc > carrier.max_finite or not math.isfinite(acc):
            findings.append(Finding(
                code="dot-accumulator-risk", level=WARNING,
                message=(f"quantize_dot_inputs on {s.prim} at "
                         f"{s.scope!r}: worst-case accumulator "
                         f"{d.n} * {qa:.3g} * {qb:.3g} exceeds the "
                         f"{carrier.key} carrier's finite range — input "
                         "quantization cannot keep the accumulation "
                         "finite"),
                scope=s.scope, rule_index=w))
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


# --------------------------------------------------------------------------
# CLI: python -m repro_torch.analysis.lint <paths...>
# --------------------------------------------------------------------------

# the benchmark model ``artifacts/bench_model.json`` was searched on (the
# reference's ``benchmarks/common.bench_model`` and ``bench_batch``)
BENCH_CONFIG = dict(name="bench", family="dense", n_layers=4, d_model=128,
                    n_heads=8, n_kv_heads=4, d_ff=512, vocab=512,
                    dtype="float32", remat=False, scan_layers=False)


def _all_sites(fn, args) -> Any:
    """Enumerate every float quantize site of one run of ``fn(*args)``."""
    from repro_torch.core import interpreter
    everywhere = TruncationPolicy(rules=(
        TruncationRule(fmt=FPFormat(8, 0), scope="**"),))
    return interpreter.enumerate_sites(fn, args, {}, everywhere)


def _bench_model_context() -> Tuple[List[str], Any]:
    """(scope frontier, SiteIndex) of the benchmark model on the CPU — the
    model ``artifacts/bench_model.json`` is deployed against."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import Model
    from repro_torch.search.scopes import discover_scopes

    cfg = ArchConfig(**BENCH_CONFIG)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (8, 65))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
    with torch.no_grad():
        paths = [s.path for s in discover_scopes(model.loss, (params, batch))]
        return paths, _all_sites(model.loss, (params, batch))


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import os
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Statically lint policy artifact JSON files.")
    ap.add_argument("paths", nargs="+",
                    help="artifact JSON files or directories of them")
    ap.add_argument("--no-model", action="store_true",
                    help="skip the model-aware checks (scope drift, dead "
                         "rules) even for artifacts with a known model")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on warnings too")
    args = ap.parse_args(argv)

    from repro_torch.artifacts import load_artifact_file

    files: List[str] = []
    for p in args.paths:
        if os.path.isdir(p):
            files.extend(sorted(
                os.path.join(root, f)
                for root, _, names in os.walk(p)
                for f in names if f.endswith(".json")))
        else:
            files.append(p)
    if not files:
        print("no artifact files found", file=sys.stderr)
        return 1

    bench_ctx: Any = None  # built once, shared across files
    n_err = n_warn = 0
    for path in files:
        try:
            art = load_artifact_file(path)
        except Exception as e:
            print(f"{path}: ERROR unreadable artifact: {e}")
            n_err += 1
            continue
        kw: Dict[str, Any] = {}
        note = ""
        if not args.no_model and art.name == "bench_model":
            if bench_ctx is None:
                try:
                    bench_ctx = _bench_model_context()
                except Exception as e:
                    bench_ctx = e
            if isinstance(bench_ctx, tuple):
                paths_ctx, idx = bench_ctx
                kw = {"scopes": paths_ctx, "sites": idx.sites}
            else:
                note = (" (structural checks only: bench model "
                        f"unavailable: {bench_ctx})")
        findings = lint_artifact(art, **kw)
        errs = [f for f in findings if f.level == ERROR]
        warns = [f for f in findings if f.level == WARNING]
        n_err += len(errs)
        n_warn += len(warns)
        status = "clean" if not findings else \
            f"{len(errs)} error(s), {len(warns)} warning(s)"
        print(f"{path}: {status}{note}")
        for f in findings:
            print(f"  {f.render()}")
    print(f"lint: {len(files)} artifact(s), {n_err} error(s), "
          f"{n_warn} warning(s)")
    return 1 if n_err or (args.strict and n_warn) else 0


__all__ = ["ArtifactLintError", "Finding", "errors", "covers",
           "lint_artifact", "lint_policy", "main"]


if __name__ == "__main__":
    import sys
    sys.exit(main())
