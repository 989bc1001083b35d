"""The closed loop: fault-aware stepping, divergence monitoring and the
escalation ladder, wired into the checkpoint-restart supervisor
(``repro.guardrails.controller``).

The escalation ladder (one rung per alarm, never descending):

  1. **widen in place** -- rewrite the suspect sites' rows of the live
     ``(num_sites, 4)`` table to the identity row and keep stepping. A new
     table value for the hot-swap step: no new enumeration (asserted
     through the step's ``n_traces``).
  2. **widen + roll back** -- the same table surgery, then raise
     :class:`NumericalFaultError` so ``fault_tolerance.run_supervised``
     restores the last durable checkpoint; training resumes under the
     escalated table. Non-finite alarms land here directly -- once inf/NaN
     reached the parameters, widening alone cannot un-poison them.
  3. **degrade to FP32** -- replace the whole table with the identity table
     (every site at full precision) and roll back one final time.

Suspect ranking: rows that differ from the deployed baseline table rank
first (a corrupted row -- an injected fault -- is its own confession), then
sites under scopes blamed by the latest sampled trajectory probe, then the
narrowest remaining rows. Every action lands in the
:class:`~repro_torch.guardrails.log.GuardrailLog`.

The controller works on numpy tables and host floats; the steps it drives
run on the device of their parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.policy import resolve_policy
from repro_torch.distributed.fault_tolerance import (
    SupervisorConfig, run_supervised,
)
from repro_torch.guardrails.faults import FaultPlan, sites_for_scope
from repro_torch.guardrails.log import GuardrailLog
from repro_torch.guardrails.monitor import (
    StepMonitor, TrendFilter, Verdict, probe_blame,
)
from repro_torch.kernels.quantize_em.ops import IDENTITY_ROW


class NumericalFaultError(RuntimeError):
    """Raised inside the guarded loop to hand control to the supervisor:
    ``run_supervised`` catches it, restores the latest durable checkpoint
    and re-enters the loop -- which now runs under the escalated table."""


@dataclasses.dataclass(frozen=True)
class GuardrailConfig:
    window: int = 32            # loss-monitor rolling window
    warmup: int = 8             # steps before statistical alarms arm
    z_threshold: float = 6.0
    spike_factor: float = 10.0
    save_every: int = 10        # supervisor checkpoint cadence
    max_rollbacks: int = 3
    top_k: int = 4              # sites widened per rung when blame is vague
    probe_every: int = 0        # 0 = no sampled trajectory probes
    probe_steps: int = 3        # ring-buffer rows per probe
    probe_threshold: float = 1e-3
    predict_budget: float = 0.0   # alarm when the filter predicts crossing
    predict_horizon: int = 20     # ... within this many steps


class EscalationLadder:
    """Table-level escalation policy, shared by :class:`GuardedLoop` and the
    train entry point. Stateful: ``level`` only climbs (0 nominal, 1 after
    an in-place widen, 2 after a rollback, 3 once degraded to FP32)."""

    def __init__(self, baseline_table, site_index=None,
                 cfg: Optional[GuardrailConfig] = None,
                 log: Optional[GuardrailLog] = None):
        self.baseline = np.asarray(baseline_table, np.int32).copy()
        self.identity = np.tile(IDENTITY_ROW, (len(self.baseline), 1))
        self.site_index = site_index
        self.cfg = cfg or GuardrailConfig()
        self.log = log if log is not None else GuardrailLog()
        self.level = 0
        self.suspect_scopes: List[str] = []

    def _scope_of(self, i: int) -> Optional[str]:
        if self.site_index is None:
            return None
        return self.site_index.sites[i].scope

    def suspects(self, table) -> List[int]:
        """Ranked suspect rows; rows already at identity never qualify."""
        tab = np.asarray(table, np.int32)
        not_identity = [i for i in range(len(tab))
                        if not np.array_equal(tab[i], IDENTITY_ROW)]
        # 1) corruption: rows that drifted from the deployed baseline
        diff = [i for i in not_identity
                if not np.array_equal(tab[i], self.baseline[i])]
        if diff:
            return diff
        # 2) scopes blamed by the latest trajectory probe
        if self.suspect_scopes and self.site_index is not None:
            out: List[int] = []
            for scope in self.suspect_scopes:
                out.extend(i for i in sites_for_scope(self.site_index, scope)
                           if i in not_identity and i not in out)
            if out:
                return out[:self.cfg.top_k]
        # 3) the narrowest remaining rows (fewest mantissa, then exp bits)
        not_identity.sort(key=lambda i: (int(tab[i][1]), int(tab[i][0])))
        return not_identity[:self.cfg.top_k]

    def escalate(self, table, step: int,
                 verdict: Verdict) -> Tuple[np.ndarray, bool]:
        """One rung up: returns ``(new_table, rollback)``. Records the alarm
        and the escalation in the log; the caller owns raising
        :class:`NumericalFaultError` when ``rollback`` is True."""
        self.log.record(step, "alarm", reason=verdict.reason,
                        level=self.level, z=round(verdict.z, 3))
        tab = np.array(table, np.int32, copy=True)
        sus = self.suspects(tab)
        if self.level >= 2 or not sus:
            # final rung: every site at full precision
            tab = self.identity.copy()
            self.log.record(step, "degrade_fp32", reason=verdict.reason)
            self.level = 3
            return tab, True
        rollback = bool(verdict.nonfinite or self.level >= 1)
        scopes = sorted({s for s in (self._scope_of(i) for i in sus)
                         if s is not None})
        for i in sus:
            tab[i] = IDENTITY_ROW
        self.log.record(step, "escalate_sites", sites=[int(i) for i in sus],
                        scopes=scopes, reason=verdict.reason,
                        rollback=rollback)
        self.level = 2 if rollback else 1
        return tab, rollback


@dataclasses.dataclass
class GuardResult:
    final_step: int
    final_loss: Optional[float]
    rollbacks: int
    table: np.ndarray
    log: GuardrailLog
    state: Any = None


class GuardedLoop:
    """Run ``step_fn(state, step, table) -> (state, loss, nonfinite)`` for
    ``n_steps`` under the monitor, the escalation ladder, an optional
    :class:`FaultPlan` and the checkpoint-restart supervisor.

    ``step_fn`` must be deterministic in ``step`` (a rollback replays
    steps). ``probe_fn(state, step) -> (blame, peak)``, when given, is the
    sampled trajectory probe (:func:`~repro_torch.guardrails.monitor
    .probe_blame`) run every ``cfg.probe_every`` steps."""

    def __init__(self, step_fn: Callable, init_state: Any, table, *,
                 site_index=None, checkpointer=None,
                 cfg: Optional[GuardrailConfig] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 monitor: Optional[StepMonitor] = None,
                 log: Optional[GuardrailLog] = None,
                 probe_fn: Optional[Callable] = None,
                 artifact=None):
        self.cfg = cfg or GuardrailConfig()
        self.log = log if log is not None else GuardrailLog()
        self.monitor = monitor or StepMonitor(
            window=self.cfg.window, warmup=self.cfg.warmup,
            z_threshold=self.cfg.z_threshold,
            spike_factor=self.cfg.spike_factor)
        self.trend = TrendFilter()
        self.ladder = EscalationLadder(table, site_index, self.cfg, self.log)
        self.table = np.asarray(table, np.int32).copy()
        self.state = init_state
        self._init_state = init_state
        self._step_fn = step_fn
        self._probe_fn = probe_fn
        self.ck = checkpointer
        self.fault_plan = fault_plan
        self.artifact = artifact
        self.rollbacks = 0
        self.last_loss: Optional[float] = None

    # ---- supervisor plumbing ----------------------------------------------
    def _save(self, step: int) -> None:
        if self.ck is None:
            return
        self.ck.save(step, self.state,
                     extra={"table": np.asarray(self.table).tolist()},
                     policy_artifact=self.artifact)

    def _restore(self) -> int:
        self.monitor.reset()
        if self.ck is not None:
            # a save still being written is the last checkpoint: wait for
            # it before asking for the latest step
            self.ck.wait()
        if self.ck is None or self.ck.latest_step() is None:
            self.state = self._init_state   # no durable checkpoint: the top
            return 0
        self.state, manifest = self.ck.restore(self.state)
        return int(manifest["step"])

    def _probe(self, step: int) -> None:
        blame, peak = self._probe_fn(self.state, step)
        self.ladder.suspect_scopes = [
            b.scope for b in blame[:self.cfg.top_k] if b.scope]
        self.trend.update(step, peak)
        if self.cfg.predict_budget > 0:
            eta = self.trend.predicted_crossing(self.cfg.predict_budget)
            if eta is not None and eta <= self.cfg.predict_horizon:
                self._on_alarm(step, Verdict(
                    False, f"trajectory filter predicts deviation crossing "
                           f"{self.cfg.predict_budget:g} within {eta} steps"))

    def _on_alarm(self, step: int, verdict: Verdict) -> None:
        self.table, rollback = self.ladder.escalate(self.table, step, verdict)
        if rollback:
            self.rollbacks += 1
            self.log.record(step, "rollback", reason=verdict.reason,
                            rollbacks=self.rollbacks)
            raise NumericalFaultError(verdict.reason)

    # ---- the loop ----------------------------------------------------------
    def _one_step(self, step: int) -> float:
        if self.fault_plan is not None:
            table, fired = self.fault_plan.apply(self.table, step)
            for f in fired:
                self.log.record(step, "fault_injected", site=int(f.site),
                                fault=f.kind,
                                row=[int(v) for v in table[f.site]])
            self.table = table
        if (self._probe_fn is not None and self.cfg.probe_every > 0
                and step > 0 and step % self.cfg.probe_every == 0):
            self._probe(step)
        self.state, loss, nonfinite = self._step_fn(
            self.state, step, self.table)
        self.last_loss = loss
        verdict = self.monitor.update(step, loss, nonfinite=nonfinite)
        if verdict.alarm:
            self._on_alarm(step, verdict)
        return loss

    def run(self, n_steps: int) -> GuardResult:
        sup = SupervisorConfig(save_every=self.cfg.save_every,
                               max_restarts=self.cfg.max_rollbacks + 1,
                               retry_exceptions=(NumericalFaultError,))
        final, _restarts, _ = run_supervised(
            self._one_step, self._save, self._restore, n_steps, sup)
        if self.ck is not None:
            self.ck.wait()
        return GuardResult(final_step=int(final), final_loss=self.last_loss,
                           rollbacks=self.rollbacks, table=self.table,
                           log=self.log, state=self.state)


class _DeviceTable:
    """The live numpy table as the int32 tensor a step reads, copied to the
    device only when its value changes (a fault, an escalation)."""

    def __init__(self, to_device: Callable):
        self._to_device = to_device
        self._key = self._tensor = None

    def __call__(self, table) -> torch.Tensor:
        table = np.asarray(table, np.int32)
        key = table.tobytes()
        if key != self._key:
            self._key, self._tensor = key, self._to_device(table)
        return self._tensor


class GuardedTrainer:
    """Guardrails around the hot-swap train step.

    ``data_fn(step) -> batch`` must be deterministic per step (rollbacks
    replay). ``policy_or_artifact`` is a TruncationPolicy or a
    PolicyArtifact; an artifact's identity is recorded in every checkpoint
    manifest.

        trainer = GuardedTrainer(model, tc, artifact, params, data_fn,
                                 checkpointer=ck, cfg=GuardrailConfig(),
                                 fault_plan=plan)
        result = trainer.run(n_steps)
        audited = trainer.log.attach(artifact)   # provenance + log

    Escalation is table-only: the step is one ``truncate_sweep``
    enumeration, and every step asserts that its ``n_traces`` is 1 (the
    reference asserts one jit cache entry)."""

    def __init__(self, model, tc, policy_or_artifact, params, data_fn, *,
                 checkpointer=None, cfg: Optional[GuardrailConfig] = None,
                 fault_plan: Optional[FaultPlan] = None, site_policy=None):
        from repro_torch.train.trainer import (
            init_opt_state, make_hotswap_train_step,
        )

        res = resolve_policy(policy_or_artifact)
        policy, artifact = res.policy, res.artifact
        self.cfg = cfg or GuardrailConfig()
        example = data_fn(0)
        self._step, self.sites = make_hotswap_train_step(
            model, tc, site_policy if site_policy is not None else policy,
            params, example)
        self._loss_fn = model.loss
        self._policy = policy
        device = pytree.tree_leaves(params)[0].device
        opt = init_opt_state(model, params, tc, device=device)
        table = self.sites.table_for(policy)
        live_table = _DeviceTable(self._step.device_table)

        def step_fn(state, step, table):
            p, o, m = self._step(state["params"], state["opt"], data_fn(step),
                                 step, live_table(table))
            self.assert_zero_recompile()
            loss = float(m["loss"])
            return ({"params": p, "opt": o}, loss,
                    bool(m["nonfinite"]) or not np.isfinite(loss))

        probe_fn = None
        if self.cfg.probe_every > 0:
            def probe_fn(state, step):
                return probe_blame(
                    self._loss_fn, self._policy,
                    (state["params"], data_fn(step)),
                    self.cfg.probe_threshold, n_steps=self.cfg.probe_steps)

        self.loop = GuardedLoop(
            step_fn, {"params": params, "opt": opt}, table,
            site_index=self.sites, checkpointer=checkpointer, cfg=self.cfg,
            fault_plan=fault_plan, probe_fn=probe_fn, artifact=artifact)

    @property
    def log(self) -> GuardrailLog:
        return self.loop.log

    @property
    def table(self) -> np.ndarray:
        return self.loop.table

    def cache_size(self) -> int:
        """Enumerations of the hot-swap step (the reference's jit cache
        entries): 1 for a run whose escalations were table-only."""
        return int(self._step.sweep.n_traces)

    def assert_zero_recompile(self) -> None:
        cs = self.cache_size()
        if cs > 1:
            raise AssertionError(
                f"hot-swap train step re-enumerated ({cs} enumerations); "
                "site escalation must be table-only")

    def run(self, n_steps: int) -> GuardResult:
        return self.loop.run(n_steps)


def _max_abs(state) -> float:
    """max |x| over the floating-point leaves of ``state`` (one host
    synchronisation)."""
    leaves = [l.abs().max() for l in pytree.tree_leaves(state)
              if isinstance(l, torch.Tensor) and l.dtype.is_floating_point]
    return float(torch.stack(leaves).max()) if leaves else 0.0


def make_guarded_app_loop(app, policy_or_artifact, *, checkpointer=None,
                          cfg: Optional[GuardrailConfig] = None,
                          fault_plan: Optional[FaultPlan] = None,
                          signal_fn: Optional[Callable] = None,
                          device=None) -> Tuple[GuardedLoop, Any]:
    """Guardrails around a mini-app integration: each supervised step is one
    ``app.step`` evaluated through ``truncate_sweep``'s runtime-table path
    (one enumeration for the whole run). Returns ``(loop, sweep)``; run with
    ``loop.run(app.n_steps)``.

    The monitored scalar defaults to max|state| -- overflow-to-inf and NaN
    poisoning surface on the very step they happen; pass ``signal_fn(state)
    -> float`` for an app-specific residual. The state lives on ``device``
    (``None``: the card, as ``app.init_state`` has it)."""
    from repro_torch.core.api import truncate_sweep

    res = resolve_policy(policy_or_artifact)
    policy, artifact = res.policy, res.artifact
    sweep = truncate_sweep(app.step, policy)
    state0 = app.init_state(device=device)
    handle0 = sweep(state0)
    table = handle0.table(policy)
    live_table = _DeviceTable(handle0.device_table)
    signal_fn = signal_fn or _max_abs

    def step_fn(state, step, table):
        new_state = sweep(state)(live_table(table))
        sig = signal_fn(new_state)
        return new_state, sig, not np.isfinite(sig)

    # a SweepHandle has the ``.sites`` the ladder reads
    loop = GuardedLoop(step_fn, state0, table, site_index=handle0,
                       checkpointer=checkpointer, cfg=cfg,
                       fault_plan=fault_plan, artifact=artifact)
    return loop, sweep


__all__ = ["NumericalFaultError", "GuardrailConfig", "EscalationLadder",
           "GuardResult", "GuardedLoop", "GuardedTrainer",
           "make_guarded_app_loop"]
