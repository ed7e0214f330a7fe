"""PyTorch/CUDA port of the ICR system (Iterative Charted Refinement).

A second package beside the JAX reference ``repro``: it imports torch and
numpy only. ``ICR`` applies the generative square root on the kernel
route (``use_pallas=True``) with hand-written Hopper kernels, or on the
plain torch path. Tensors default to the ``cuda`` device; pass
``device="cpu"`` to run the kernels' plain versions instead.
"""
from .core import (
    ICR,
    Chart,
    Kernel,
    exponential,
    galactic_dust_chart,
    log_chart,
    matern32,
    matern52,
    rbf,
    regular_chart,
)
from .kernels import (
    BF16,
    FP32,
    DtypePolicy,
    refine_charted,
    refine_nd_fused,
    refine_stationary,
)

__all__ = [
    "ICR", "Chart", "Kernel", "exponential", "galactic_dust_chart",
    "log_chart", "matern32", "matern52", "rbf", "regular_chart", "BF16",
    "FP32", "DtypePolicy", "refine_charted", "refine_nd_fused",
    "refine_stationary",
]
