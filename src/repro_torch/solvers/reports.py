"""Structured diagnostics of the batched PCG solver: a copy of the JAX
package's ``repro/solvers/reports.py``, which is plain Python, kept here
so that the port imports nothing of that package.

Every guarded solve returns a :class:`SolveReport`: per-RHS terminal
status, iteration counts and residuals, the fallback rungs taken
(:class:`FallbackEvent`), checkpoint/resume history
(:class:`ResumeEvent`) and the quarantined column indices. The report is
plain data (JSON-able via :meth:`SolveReport.summary`), so it rides in
``GPFieldServer.metrics()`` unchanged. The status codes and names are the
JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# per-RHS terminal status codes (int32 in the solver's carry)
ACTIVE = 0      # still iterating (never terminal after finalize)
CONVERGED = 1   # residual under max(rtol*||b||, atol)
NONFINITE = 2   # NaN/Inf in the RHS or the iterate — quarantined (zeroed)
DIVERGED = 3    # residual grew past divergence_factor*||b|| — quarantined
BREAKDOWN = 4   # non-positive curvature pᵀAp ≤ 0 or rᵀz ≤ 0 (frozen)
STALLED = 5     # no residual improvement for stall_window iterations
MAXITER = 6     # iteration budget exhausted while still active
DENSE = 7       # solved by the dense (exact) fallback rung

STATUS_NAMES = {
    ACTIVE: "active", CONVERGED: "converged", NONFINITE: "nonfinite",
    DIVERGED: "diverged", BREAKDOWN: "breakdown", STALLED: "stalled",
    MAXITER: "maxiter", DENSE: "dense",
}

# statuses that poison a column: its iterate is zeroed the moment the
# status is assigned so it can never re-enter the batched matvec
QUARANTINED = (NONFINITE, DIVERGED)
# statuses worth re-solving on the next fallback rung
RETRYABLE = (DIVERGED, BREAKDOWN, STALLED, MAXITER)
# statuses that count as a good solution
OK = (CONVERGED, DENSE)


@dataclasses.dataclass(frozen=True)
class FallbackEvent:
    """One transition down the fallback ladder.

    ``cols`` are the (original-batch) RHS indices handed to ``rung_to``;
    ``reasons`` histograms why (status name -> count) at the moment the
    rung ``rung_from`` gave up on them.
    """

    rung_from: str
    rung_to: str
    at_iter: int
    cols: Tuple[int, ...]
    reasons: Tuple[Tuple[str, int], ...]

    def summary(self) -> dict:
        return {
            "from": self.rung_from, "to": self.rung_to,
            "at_iter": self.at_iter, "cols": list(self.cols),
            "reasons": dict(self.reasons),
        }


@dataclasses.dataclass(frozen=True)
class ResumeEvent:
    """One checkpointed resume (preemption / device loss mid-solve)."""

    at_iter: int        # global iteration when the solve was interrupted
    restored_step: int  # checkpoint step the carry was restored from
    reason: str         # e.g. "device-loss [3]"

    def summary(self) -> dict:
        return {"at_iter": self.at_iter,
                "restored_step": self.restored_step,
                "reason": self.reason}


@dataclasses.dataclass(frozen=True)
class SolveReport:
    """Terminal diagnostics of one guarded batched solve.

    ``status``/``iterations``/``relres`` are per-RHS (original batch
    order); ``rungs`` lists every ladder rung attempted in order;
    ``quarantined`` are the column indices whose iterates were zeroed
    (NaN/divergence isolation); ``fallbacks``/``resumes`` are the event
    streams. ``ok`` is True iff every column ended converged or dense.
    ``rtol`` and ``floor_cap`` are the solve's ``CGConfig``'s and
    ``delta`` the largest column's float32 matvec rounding at its last CG
    iterate relative to its right-hand side: with ``floor_cap`` above 0 a
    converged column's true residual plus that rounding is within
    10·max(rtol, min(δ, floor_cap)) (``solvers/pcg.py``). The JAX
    package's report has none of the three.
    """

    tag: str
    n_rhs: int
    n_unknowns: int
    rungs: Tuple[str, ...]
    status: Tuple[str, ...]
    iterations: Tuple[int, ...]
    relres: Tuple[float, ...]
    quarantined: Tuple[int, ...]
    fallbacks: Tuple[FallbackEvent, ...] = ()
    resumes: Tuple[ResumeEvent, ...] = ()
    checkpoints: int = 0
    wall_s: float = 0.0
    rtol: Optional[float] = None
    floor_cap: float = 0.0
    delta: Optional[float] = None

    @property
    def ok(self) -> bool:
        return all(s in ("converged", "dense") for s in self.status)

    @property
    def max_iterations(self) -> int:
        return max(self.iterations) if self.iterations else 0

    def summary(self) -> dict:
        """JSON-able digest — what ``GPFieldServer.metrics()`` surfaces."""
        hist: dict = {}
        for s in self.status:
            hist[s] = hist.get(s, 0) + 1
        return {
            "tag": self.tag,
            "n_rhs": self.n_rhs,
            "n_unknowns": self.n_unknowns,
            "ok": self.ok,
            "rungs": list(self.rungs),
            "status": hist,
            "iterations": self.max_iterations,
            "final_relres": max(self.relres) if self.relres else 0.0,
            "quarantined": list(self.quarantined),
            "fallbacks": [f.summary() for f in self.fallbacks],
            "resumes": [r.summary() for r in self.resumes],
            "checkpoints": self.checkpoints,
            "wall_s": self.wall_s,
            "rtol": self.rtol,
            "floor_cap": self.floor_cap,
            "delta": self.delta,
        }
