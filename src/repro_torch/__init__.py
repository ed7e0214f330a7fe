"""PyTorch/CUDA port of the ICR system (Iterative Charted Refinement).

A second package beside the JAX reference ``repro``: it imports torch and
numpy only. ``ICR`` applies the generative square root and its transpose
on the kernel route (``use_pallas=True``) with hand-written Hopper
kernels, forward and backward, or on the plain torch path; ``map_fit``
and ``advi_fit`` train on it; ``GPFieldServer`` serves posterior fields
and moments from a fit, each slab one replay of a CUDA graph. Tensors
default to the ``cuda`` device; pass ``device="cpu"`` to run the
kernels' plain versions instead. ``cg_posterior`` conditions the prior on
data exactly by guarded batched CG (``solvers``), each matvec one ``Sᵀ``
and one ``S`` on the kernels; ``exact`` and ``KissGP`` are the paper's
§5.1 and §5.2 references. ``configs``, ``models`` and ``launch.serve``
hold the LM substrate's serving half: the ten architectures' forward
pass and one-token decode, and the batched server whose decode step is
one CUDA graph on the card.
"""
from .core import (
    ICR,
    Chart,
    Kernel,
    KissGP,
    Posterior,
    Prior,
    StandardizedModel,
    advi_fit,
    advi_posterior,
    cg_posterior,
    cov_errors,
    exact_cov,
    exact_posterior,
    exact_sample,
    exponential,
    galactic_dust_chart,
    gauss_kl,
    gaussian_log_likelihood,
    log_chart,
    log_polar_chart,
    lognormal_prior,
    map_fit,
    map_posterior,
    matern32,
    matern52,
    neg_log_joint,
    normal_prior,
    per_draw,
    poisson_log_likelihood,
    rbf,
    regular_chart,
    uniform_prior,
)
from .data import charted_gp_dataset
from .distributed import DeviceLossError, ServingFaultSupervisor
from .kernels import (
    BF16,
    FP32,
    DtypePolicy,
    refine_charted,
    refine_charted_adjoint,
    refine_nd_fused,
    refine_stationary,
    refine_stationary_adjoint,
)
from .optim import adamw, linear_warmup_cosine
from .roofline import refine_level_traffic

# the server's names load on first use: importing ``launch.serve_gp`` with
# the package would make ``python -m repro_torch.launch.serve_gp`` run a
# second copy of the module
_LAZY = {"GPFieldServer": "launch.serve_gp", "GPRequest": "launch.serve_gp",
         "RequestError": "launch.serve_gp"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ICR", "Chart", "Kernel", "KissGP", "Posterior", "Prior",
    "StandardizedModel", "advi_fit", "advi_posterior", "cg_posterior",
    "cov_errors", "exact_cov", "exact_posterior", "exact_sample",
    "exponential", "galactic_dust_chart", "gauss_kl",
    "gaussian_log_likelihood", "log_chart", "log_polar_chart",
    "lognormal_prior", "map_fit", "map_posterior", "matern32", "matern52",
    "neg_log_joint", "normal_prior", "per_draw", "poisson_log_likelihood",
    "rbf", "regular_chart",
    "uniform_prior", "charted_gp_dataset", "BF16", "FP32", "DtypePolicy",
    "refine_charted", "refine_charted_adjoint", "refine_nd_fused",
    "refine_stationary", "refine_stationary_adjoint", "adamw",
    "linear_warmup_cosine", "DeviceLossError", "ServingFaultSupervisor",
    "GPFieldServer", "GPRequest", "RequestError", "refine_level_traffic",
]
