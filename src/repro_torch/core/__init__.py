"""ICR core of the port: charts, kernels, refinement matrices, ``ICR``,
the exact GP and KISS-GP references, priors, the fits and the
CG-conditioned posterior."""
from .charts import (
    Chart,
    galactic_dust_chart,
    log_chart,
    log_polar_chart,
    regular_chart,
)
from .icr import ICR
from .exact import cov_errors, exact_cov, exact_posterior, exact_sample, gauss_kl
from .kissgp import KissGP
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
    cg_posterior,
    gaussian_log_likelihood,
    map_fit,
    map_posterior,
    neg_log_joint,
    per_draw,
    poisson_log_likelihood,
)

__all__ = [
    "Chart", "galactic_dust_chart", "log_chart", "log_polar_chart",
    "regular_chart", "ICR", "cov_errors", "exact_cov", "exact_posterior",
    "exact_sample", "gauss_kl", "KissGP", "KERNELS", "Kernel", "exponential",
    "kernel_matrix", "matern32", "matern52", "rbf", "LevelGeom",
    "axis_refinement_matrices_level", "level0_sqrt", "refine_level",
    "refine_level_T", "refinement_matrices_level", "Prior",
    "StandardizedModel", "lognormal_prior", "normal_prior", "uniform_prior",
    "Posterior", "advi_fit", "advi_posterior", "cg_posterior",
    "gaussian_log_likelihood",
    "map_fit", "map_posterior", "neg_log_joint", "per_draw",
    "poisson_log_likelihood",
]
