"""Runtime numerical guardrails: fault injection, divergence-triggered
precision escalation, and checkpoint-rollback recovery
(``repro.guardrails``).

The closed loop over the hot-swap format table:

  * :mod:`~repro_torch.guardrails.faults` -- inject faults as run-time
    transforms of the ``(num_sites, 4)`` format table (plus the
    quantizer's bit-flip channel): no new enumeration, so chaos campaigns
    are cheap.
  * :mod:`~repro_torch.guardrails.monitor` -- detect divergence online:
    non-finite flags, loss-spike z-scores, and a windowed filter over
    sampled trajectory probes that predicts budget crossings.
  * :mod:`~repro_torch.guardrails.controller` -- recover through the
    escalation ladder: widen blamed sites in the live table, roll back to
    the last durable checkpoint under the escalated table, finally degrade
    to FP32 -- every intervention recorded in a
    :class:`~repro_torch.guardrails.log.GuardrailLog` attachable to the
    deployed :class:`~repro_torch.artifacts.PolicyArtifact`'s provenance.
"""
from repro_torch.guardrails.controller import (
    EscalationLadder, GuardedLoop, GuardedTrainer, GuardrailConfig,
    GuardResult, NumericalFaultError, make_guarded_app_loop,
)
from repro_torch.guardrails.faults import (
    FaultPlan, FaultSpec, bitflip_row, clean_row, overflow_row,
    sites_for_scope,
)
from repro_torch.guardrails.log import KINDS, GuardrailLog, Intervention
from repro_torch.guardrails.monitor import (
    StepMonitor, TrendFilter, Verdict, probe_blame,
)

__all__ = [
    "EscalationLadder", "GuardedLoop", "GuardedTrainer", "GuardrailConfig",
    "GuardResult", "NumericalFaultError", "make_guarded_app_loop",
    "FaultPlan", "FaultSpec", "bitflip_row", "clean_row", "overflow_row",
    "sites_for_scope", "GuardrailLog", "Intervention",
    "StepMonitor", "TrendFilter", "Verdict", "probe_blame", "KINDS",
]
