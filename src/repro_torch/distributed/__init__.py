"""Fault tolerance for one process (``repro.distributed`` in the reference):
the checkpoint-restart supervisor and the straggler monitor. The
reference's mesh tools (``sharding``, ``fault_tolerance.remesh`` /
``best_mesh_shape``) come with the distribution port, ROADMAP Queue A item
5, and are not defined here."""
from repro_torch.distributed.fault_tolerance import (
    StragglerMonitor, SupervisorConfig, run_supervised,
)

__all__ = ["StragglerMonitor", "SupervisorConfig", "run_supervised"]
