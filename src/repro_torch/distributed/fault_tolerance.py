"""Checkpoint-restart supervision, straggler detection and elastic
re-meshing (``repro.distributed.fault_tolerance``).

  * **Failure handling** -- ``run_supervised`` wraps the step loop, catches
    the configured exception classes, restores the latest durable
    checkpoint and re-enters the loop.
  * **Straggler mitigation** -- across steps: the supervisor keeps a
    rolling median step time and flags a step slower than
    ``straggle_factor`` x that median (``StragglerMonitor``), so a
    scheduler can act at the next restart boundary.

  * **Elastic scaling** -- ``remesh`` builds a new (data, model) mesh over
    the ranks of the current process group (possibly fewer than before);
    ``Checkpointer.restore(shardings=...)`` re-shards a checkpoint onto it
    and the data pipeline's step cursor keeps batches aligned.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np


def best_mesh_shape(n_devices: int, model_parallel: int) -> Tuple[int, int]:
    """Largest (data, model) grid for ``n_devices``."""
    model = model_parallel
    while model > 1 and n_devices % model:
        model //= 2
    return n_devices // model, model


def remesh(model_parallel: int = 16, axis_names=("data", "model"),
           device=None):
    """A (data, model) DeviceMesh over every rank of the process group."""
    from repro_torch.launch.mesh import device_mesh, ensure_process_group
    data, model = best_mesh_shape(ensure_process_group(device),
                                  model_parallel)
    return device_mesh((data, model), axis_names, device, "remesh")


@dataclasses.dataclass
class StragglerMonitor:
    straggle_factor: float = 2.0
    window: int = 50
    _times: List[float] = dataclasses.field(default_factory=list)

    def record(self, seconds: float) -> bool:
        """True when this step straggled against the rolling median."""
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 5:
            return False
        return seconds > self.straggle_factor * float(np.median(self._times))


@dataclasses.dataclass
class SupervisorConfig:
    max_restarts: int = 10
    save_every: int = 100
    retry_exceptions: Tuple = (RuntimeError,)   # a lost device, a timeout


def run_supervised(step_fn: Callable[[int], float],
                   save_fn: Callable[[int], None],
                   restore_fn: Callable[[], int],
                   total_steps: int,
                   cfg: SupervisorConfig = SupervisorConfig(),
                   monitor: Optional[StragglerMonitor] = None):
    """Checkpoint-restart supervisor. ``step_fn(step) -> loss`` runs one
    step; ``restore_fn() -> step`` reloads the latest durable state.
    Returns ``(final_step, n_restarts, straggle_count)``."""
    restarts = 0
    straggles = 0
    step = restore_fn()
    while step < total_steps:
        try:
            t0 = time.perf_counter()
            step_fn(step)
            dt = time.perf_counter() - t0
            if monitor is not None and monitor.record(dt):
                straggles += 1
            step += 1
            if step % cfg.save_every == 0 or step == total_steps:
                save_fn(step)
        except cfg.retry_exceptions:
            restarts += 1
            if restarts > cfg.max_restarts:
                raise
            step = restore_fn()
    return step, restarts, straggles
