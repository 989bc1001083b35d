"""Runtime numerical guardrails. Ported so far: the intervention log
(:class:`GuardrailLog`), which the serving engine's drift detector writes
into a deployed artifact's provenance. Fault injection, the monitor and the
escalation controller are not ported yet."""
from repro_torch.guardrails.log import KINDS, GuardrailLog, Intervention

__all__ = ["GuardrailLog", "Intervention", "KINDS"]
