"""GuardrailLog: the audit trail of every runtime intervention.

Framework-free, and the reference package's shapes exactly: ``to_json`` is
the same list in both packages, so an artifact's
``provenance["guardrail_log"]`` is the same JSON whichever package wrote it.

Every action the controller takes — injected faults (during chaos runs),
monitor alarms, site escalations, checkpoint rollbacks, the final FP32
degrade — is appended as an :class:`Intervention` and survives as JSON:
attached to the :class:`~repro_torch.artifacts.PolicyArtifact` provenance
(``artifact.with_guardrail_log(log)``) so serving and CI can audit what the
controller did under a deployed policy, and dumped to
``$RAPTOR_ARTIFACTS_DIR`` by the chaos tier so a red CI run explains
itself.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterator, List, Mapping, Optional

KINDS = ("fault_injected", "alarm", "escalate_sites", "rollback",
         "degrade_fp32", "drift_detected", "research_paged")


@dataclasses.dataclass
class Intervention:
    """One logged controller action."""

    step: int
    kind: str                    # one of KINDS
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {"step": int(self.step), "kind": self.kind,
                "detail": dict(self.detail)}

    @staticmethod
    def from_json(data: Mapping) -> "Intervention":
        return Intervention(step=int(data["step"]), kind=str(data["kind"]),
                            detail=dict(data.get("detail") or {}))


class GuardrailLog:
    """Append-only list of interventions with a lossless JSON round trip."""

    def __init__(self, interventions: Optional[List[Intervention]] = None):
        self.interventions: List[Intervention] = list(interventions or [])

    def record(self, step: int, kind: str, **detail) -> Intervention:
        if kind not in KINDS:
            raise ValueError(f"unknown intervention kind {kind!r}; "
                             f"known: {KINDS}")
        iv = Intervention(step=int(step), kind=kind, detail=detail)
        self.interventions.append(iv)
        return iv

    def __len__(self) -> int:
        return len(self.interventions)

    def __iter__(self) -> Iterator[Intervention]:
        return iter(self.interventions)

    def by_kind(self, kind: str) -> List[Intervention]:
        return [iv for iv in self.interventions if iv.kind == kind]

    def kinds(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for iv in self.interventions:
            out[iv.kind] = out.get(iv.kind, 0) + 1
        return out

    # ---- JSON round trip ---------------------------------------------------
    def to_json(self) -> list:
        return [iv.to_json() for iv in self.interventions]

    @staticmethod
    def from_json(data) -> "GuardrailLog":
        return GuardrailLog([Intervention.from_json(d) for d in data])

    def save(self, path: str) -> None:
        """Atomic single-file dump (the chaos tier's CI artifact)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp_{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "GuardrailLog":
        with open(path) as f:
            return GuardrailLog.from_json(json.load(f))

    # ---- artifact attachment -----------------------------------------------
    def attach(self, artifact):
        """``artifact.with_guardrail_log(self)`` — a new frozen artifact
        whose provenance carries this log."""
        return artifact.with_guardrail_log(self)

    @staticmethod
    def from_artifact(artifact) -> Optional["GuardrailLog"]:
        data = artifact.provenance.get("guardrail_log")
        return None if data is None else GuardrailLog.from_json(data)

    def summary(self) -> str:
        counts = self.kinds()
        head = ", ".join(f"{k}={counts[k]}" for k in KINDS if k in counts) \
            or "no interventions"
        lines = [f"guardrail log: {head}"]
        for iv in self.interventions:
            extras = " ".join(f"{k}={v}" for k, v in iv.detail.items())
            lines.append(f"  step {iv.step:>6d}  {iv.kind:<15s} {extras}")
        return "\n".join(lines)


__all__ = ["Intervention", "GuardrailLog", "KINDS"]
