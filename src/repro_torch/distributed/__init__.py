"""Fault handling of the port (``fault``); the mesh and halo modules of
the JAX package's ``distributed`` are not ported yet."""
from .fault import (
    DeviceLossError,
    FaultSupervisor,
    RetryPolicy,
    ServingFaultSupervisor,
    StragglerMonitor,
)

__all__ = ["DeviceLossError", "FaultSupervisor", "RetryPolicy",
           "ServingFaultSupervisor", "StragglerMonitor"]
