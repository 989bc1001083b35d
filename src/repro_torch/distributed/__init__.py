"""Distribution (``repro.distributed`` in the reference): the logical-axis
sharding rules over a DeviceMesh (``sharding``), the checkpoint-restart
supervisor, the straggler monitor and elastic re-meshing
(``fault_tolerance``)."""
from repro_torch.distributed.fault_tolerance import (
    StragglerMonitor, SupervisorConfig, best_mesh_shape, remesh,
    run_supervised,
)

__all__ = ["StragglerMonitor", "SupervisorConfig", "best_mesh_shape",
           "remesh", "run_supervised"]
