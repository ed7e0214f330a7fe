"""Distribution of the port: ``sharding`` (the LM substrate's
PartitionSpecs, the JAX package's FSDP x TP rules), ``executor`` (the
executor that runs an LM step on a mesh of slots by those specs),
``compression`` (the int8 error-feedback all-reduce), ``fault`` (the
supervisors and the straggler monitor), ``elastic`` (placement on a mesh
of slots, shrinking it after a loss, degradation records) and ``chaos``
(the fault-injection suite of the sharded server)."""
from .compression import compressed_psum, make_error_feedback_state
from .elastic import Degradation, remesh, remesh_report, shrink_mesh
from .fault import (
    DeviceLossError,
    FaultSupervisor,
    RetryPolicy,
    ServingFaultSupervisor,
    StragglerMonitor,
)
from .sharding import (
    batch_spec,
    cache_specs,
    opt_state_specs,
    param_specs,
    shardings_for,
    with_batch_constraint,
)

__all__ = ["Degradation", "DeviceLossError", "FaultSupervisor",
           "RetryPolicy", "ServingFaultSupervisor", "StragglerMonitor",
           "batch_spec", "cache_specs", "compressed_psum",
           "make_error_feedback_state", "opt_state_specs", "param_specs",
           "remesh", "remesh_report", "shardings_for", "shrink_mesh",
           "with_batch_constraint"]
