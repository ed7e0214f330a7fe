"""Guarded batched solvers for data-conditioned GP inference.

``pcg`` is the batched preconditioned-CG engine (per-RHS masking,
quarantine isolation, fallback ladder, checkpoint/resume);
``gp_system`` builds the observation-space operator, the ICR-whitened
preconditioner and the dense rung; ``reports`` defines the structured
``SolveReport`` the server surfaces. The names are the JAX package's.
"""
from .pcg import (CGConfig, jacobi_precond, pcg_iterate, pcg_solve,
                  solve_guarded)
from .gp_system import (ConditionSystem, GridInterp, ObsSelect,
                        build_condition_system, condition_matvec,
                        icr_whitening_precond, obs_operator)
from .reports import (FallbackEvent, ResumeEvent, SolveReport,
                      STATUS_NAMES)

__all__ = [
    "CGConfig", "jacobi_precond", "pcg_iterate", "pcg_solve",
    "solve_guarded", "ConditionSystem", "GridInterp", "ObsSelect",
    "build_condition_system", "condition_matvec",
    "icr_whitening_precond", "obs_operator",
    "FallbackEvent", "ResumeEvent", "SolveReport", "STATUS_NAMES",
]
