"""ICR core of the port: charts, kernels, refinement matrices, ``ICR``,
priors and the fits."""
from .charts import (
    Chart,
    galactic_dust_chart,
    log_chart,
    log_polar_chart,
    regular_chart,
)
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
    refine_level_T,
    refinement_matrices_level,
)
from .standardize import (
    Prior,
    StandardizedModel,
    lognormal_prior,
    normal_prior,
    uniform_prior,
)
from .vi import (
    Posterior,
    advi_fit,
    advi_posterior,
    gaussian_log_likelihood,
    map_fit,
    map_posterior,
    neg_log_joint,
    poisson_log_likelihood,
)

__all__ = [
    "Chart", "galactic_dust_chart", "log_chart", "log_polar_chart",
    "regular_chart", "ICR", "KERNELS", "Kernel", "exponential",
    "kernel_matrix", "matern32", "matern52", "rbf", "LevelGeom",
    "axis_refinement_matrices_level", "level0_sqrt", "refine_level",
    "refine_level_T", "refinement_matrices_level", "Prior",
    "StandardizedModel", "lognormal_prior", "normal_prior", "uniform_prior",
    "Posterior", "advi_fit", "advi_posterior", "gaussian_log_likelihood",
    "map_fit", "map_posterior", "neg_log_joint", "poisson_log_likelihood",
]
