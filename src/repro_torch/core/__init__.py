"""ICR core of the port: charts, kernels, refinement matrices and ``ICR``."""
from .charts import Chart, galactic_dust_chart, log_chart, regular_chart
from .icr import ICR
from .kernels import (
    KERNELS,
    Kernel,
    exponential,
    kernel_matrix,
    matern32,
    matern52,
    rbf,
)
from .refine import (
    LevelGeom,
    axis_refinement_matrices_level,
    level0_sqrt,
    refine_level,
    refinement_matrices_level,
)

__all__ = [
    "Chart", "galactic_dust_chart", "log_chart", "regular_chart", "ICR",
    "KERNELS", "Kernel", "exponential", "kernel_matrix", "matern32",
    "matern52", "rbf", "LevelGeom", "axis_refinement_matrices_level",
    "level0_sqrt", "refine_level", "refinement_matrices_level",
]
