"""PolicyArtifact: the deployable product of a profiling run.

RAPTOR's output is not a number, it is a *policy* — which scopes tolerate
which (e, m) formats — plus the evidence behind it. Until now that bundle
died with the process: a ``SearchResult`` lived in one interpreter,
serving re-parsed ad-hoc ``--policy`` flags, and warm-start hints from a
trajectory profile had to be recomputed per run. :class:`PolicyArtifact`
makes the whole bundle one versioned, JSON-serializable value:

  * ``policy``       — the :class:`TruncationPolicy` itself (lossless round
                       trip; mask-fn rules raise ``NotSerializableError``)
  * ``assignments``  — the per-scope site table of the search (mantissa
                       width, error at accept, excluded flag, FLOPs share)
  * ``provenance``   — threshold / budget / evals / dispatches / compile
                       counts and the search history (the audit trail)
  * ``hints``        — ladder warm-start hints (``scope -> man_bits`` or
                       ``None`` = pinned full precision) so a later
                       ``autosearch(warm_start=artifact.hints)`` re-search
                       skips the trajectory profile entirely
  * ``oracle``       — an FP64-oracle verdict attached by ``apps.oracle``
  * ``bench``        — an optional BENCH row (measured perf context)

Producers: ``SearchResult.to_artifact`` and ``OracleVerdict.attach``.
Consumers: the registry (``repro_torch.artifacts.Registry``),
``resolve_policy`` and ``autosearch(warm_start=artifact)``.

**Shared with the reference package.** The registry is shared between
builds, so an artifact either package wrote loads in the other with the
same digest: ``dumps`` gives the reference's text byte for byte for the
same artifact. ``json`` has no encoding for a numpy or torch scalar, and a
numpy float32 would not survive the trip, so ``to_json`` turns every such
scalar (and 0-d tensor or array) into the Python number it holds first.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.policy import TruncationPolicy

# Bump when the JSON layout changes incompatibly. Loading an artifact with
# a NEWER schema than this library understands fails loudly (never a silent
# partial parse): the registry is shared between builds of the application,
# exactly the cross-build workflow the paper frames profiling around.
SCHEMA_VERSION = 1


class ArtifactSchemaError(ValueError):
    """The artifact's schema version is ahead of this library."""


def _plain(x):
    """``x`` with every numpy / torch scalar (and 0-d array or tensor) in it
    replaced by the Python number it holds, so ``json`` encodes it as the
    reference package's artifacts do."""
    if isinstance(x, Mapping):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.generic, np.ndarray, torch.Tensor)):
        return _plain(x.tolist())
    return x


@dataclasses.dataclass(frozen=True)
class ScopeRow:
    """One row of the artifact's scope table: the searched assignment for
    one frontier scope, with enough context to re-rank and re-render it."""

    man_bits: int
    error_at_accept: float
    excluded: bool = False
    flops: float = 0.0
    fraction: float = 0.0
    n_eqns: int = 0

    def to_json(self) -> dict:
        return {"man_bits": int(self.man_bits),
                "error_at_accept": float(self.error_at_accept),
                "excluded": bool(self.excluded), "flops": float(self.flops),
                "fraction": float(self.fraction),
                "n_eqns": int(self.n_eqns)}

    @staticmethod
    def from_json(data: dict) -> "ScopeRow":
        return ScopeRow(
            man_bits=int(data["man_bits"]),
            error_at_accept=float(data["error_at_accept"]),
            excluded=bool(data.get("excluded", False)),
            flops=float(data.get("flops", 0.0)),
            fraction=float(data.get("fraction", 0.0)),
            n_eqns=int(data.get("n_eqns", 0)))


@dataclasses.dataclass(frozen=True)
class PolicyArtifact:
    """The versioned, serializable bundle a profiling run produces."""

    name: str
    policy: TruncationPolicy
    assignments: Dict[str, ScopeRow] = dataclasses.field(default_factory=dict)
    provenance: Dict[str, Any] = dataclasses.field(default_factory=dict)
    hints: Dict[str, Optional[int]] = dataclasses.field(default_factory=dict)
    oracle: Optional[Dict[str, Any]] = None
    bench: Optional[Dict[str, Any]] = None
    schema_version: int = SCHEMA_VERSION

    # ---- derived additions (frozen -> return new artifacts) ---------------
    def with_oracle(self, verdict) -> "PolicyArtifact":
        """Attach an FP64-oracle verdict (an ``apps.oracle.OracleVerdict``
        or its JSON dict)."""
        data = verdict if isinstance(verdict, Mapping) \
            else verdict.to_json()
        return dataclasses.replace(self, oracle=dict(data))

    def with_bench(self, row: Mapping) -> "PolicyArtifact":
        """Attach a measured BENCH row (perf context for the policy)."""
        return dataclasses.replace(self, bench=dict(row))

    def with_hints(self, hints: Mapping) -> "PolicyArtifact":
        return dataclasses.replace(self, hints=dict(hints))

    def with_guardrail_log(self, log) -> "PolicyArtifact":
        """Attach a runtime intervention log (a
        guardrail log with a ``to_json`` method, or its JSON list) under
        ``provenance["guardrail_log"]`` so checkpoints, serving, and CI can
        audit what the guardrail controller did under this policy."""
        data = log if isinstance(log, list) else log.to_json()
        prov = dict(self.provenance)
        prov["guardrail_log"] = data
        return dataclasses.replace(self, provenance=prov)

    # ---- JSON round trip ---------------------------------------------------
    def to_json(self) -> dict:
        return {
            "schema_version": self.schema_version,
            "name": self.name,
            "policy": self.policy.to_json(),
            "assignments": {p: r.to_json()
                            for p, r in self.assignments.items()},
            "provenance": _plain(dict(self.provenance)),
            "hints": _plain(dict(self.hints)),
            "oracle": _plain(self.oracle),
            "bench": _plain(self.bench),
        }

    @staticmethod
    def from_json(data: Mapping) -> "PolicyArtifact":
        version = int(data.get("schema_version", 0))
        if version > SCHEMA_VERSION:
            raise ArtifactSchemaError(
                f"artifact {data.get('name', '?')!r} has schema version "
                f"{version}, but this library understands at most "
                f"{SCHEMA_VERSION}; upgrade the library (a partial parse "
                "could silently deploy the wrong policy)")
        hints = {str(k): (None if v is None else int(v))
                 for k, v in dict(data.get("hints", {})).items()}
        return PolicyArtifact(
            name=str(data["name"]),
            policy=TruncationPolicy.from_json(data["policy"]),
            assignments={str(p): ScopeRow.from_json(r)
                         for p, r in dict(data.get("assignments", {})).items()},
            provenance=dict(data.get("provenance", {})),
            hints=hints,
            oracle=data.get("oracle"),
            bench=data.get("bench"),
            schema_version=version)

    def dumps(self) -> str:
        """Canonical text form: sorted keys, fixed separators — the digest
        is computed over exactly these bytes, so two equal artifacts always
        hash equal regardless of construction order."""
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"))

    @staticmethod
    def loads(text: str) -> "PolicyArtifact":
        return PolicyArtifact.from_json(json.loads(text))

    @property
    def digest(self) -> str:
        """sha256 of the canonical JSON — the identity a checkpoint manifest
        records so a restored run can verify it resumes under the same
        policy."""
        return hashlib.sha256(self.dumps().encode("utf-8")).hexdigest()

    def table(self) -> str:
        """Render the scope table like ``SearchResult.table`` (the paper's
        per-region heatmap, textual form)."""
        lines = [f"  {'scope':<32} {'flops%':>7} {'m-bits':>7} "
                 f"{'err@accept':>11}  status"]
        for path, r in sorted(self.assignments.items()):
            status = ("excluded" if r.excluded
                      else ("full" if r.man_bits >= 23 else "truncated"))
            lines.append(f"  {path:<32} {r.fraction * 100:>6.1f}% "
                         f"{r.man_bits:>7d} {r.error_at_accept:>11.3e}  "
                         f"{status}")
        return "\n".join(lines)

    def __str__(self) -> str:
        prov = self.provenance
        bits = [f"PolicyArtifact {self.name!r} "
                f"({len(self.policy.rules)} rules, "
                f"{len(self.assignments)} scopes"]
        if "final_error" in prov and "threshold" in prov:
            bits.append(f", err {prov['final_error']:.3e} "
                        f"@ thr {prov['threshold']:.1e}")
        if self.oracle is not None:
            bits.append(f", oracle {'PASS' if self.oracle.get('passed') else 'FAIL'}")
        bits.append(")")
        return "".join(bits)


__all__ = ["PolicyArtifact", "ScopeRow", "ArtifactSchemaError",
           "SCHEMA_VERSION"]
