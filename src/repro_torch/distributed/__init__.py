"""Fault handling and elastic re-meshing of the port: ``fault`` (the
supervisors and the straggler monitor), ``elastic`` (placement on a mesh
of slots, shrinking it after a loss, degradation records) and ``chaos``
(the fault-injection suite of the sharded server). The JAX package's
``sharding`` and ``compression`` (its LM substrate's layout and int8
all-reduce) are not ported."""
from .elastic import Degradation, remesh, remesh_report, shrink_mesh
from .fault import (
    DeviceLossError,
    FaultSupervisor,
    RetryPolicy,
    ServingFaultSupervisor,
    StragglerMonitor,
)

__all__ = ["Degradation", "DeviceLossError", "FaultSupervisor",
           "RetryPolicy", "ServingFaultSupervisor", "StragglerMonitor",
           "remesh", "remesh_report", "shrink_mesh"]
