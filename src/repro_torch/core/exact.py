"""Exact (dense) GP reference: the oracle ICR is validated against (§5.1).

The counterpart of the JAX package's ``core/exact.py``. Everything here
is O(N³)/O(N²) and only for small N, in tests and accuracy checks (paper
Fig. 3), never on the production path. ``exact_sample`` takes a
``torch.Generator``, or the standard normals themselves, where the JAX
package takes a PRNG key.
"""
from __future__ import annotations

from typing import Callable

import torch

from .charts import Chart
from .kernels import kernel_matrix


def exact_cov(chart: Chart, kernel_fn: Callable, level: int | None = None,
              *, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """Dense K_XX at the finest (or given) level's charted positions."""
    level = chart.n_levels if level is None else level
    pos = chart.grid_positions(level, device=device, dtype=dtype)
    return kernel_matrix(kernel_fn, pos)


def exact_sample(cov: torch.Tensor, gen: torch.Generator | None = None, *,
                 normals: torch.Tensor | None = None,
                 jitter: float = 1e-10) -> torch.Tensor:
    """One draw ``L z`` with ``L = chol(cov + jitter I)``: ``z`` is
    ``normals`` when given, else drawn from `gen` (on ``cov``'s
    device)."""
    n = cov.shape[0]
    chol = torch.linalg.cholesky(
        cov + jitter * torch.eye(n, dtype=cov.dtype, device=cov.device))
    if normals is None:
        normals = torch.randn(n, generator=gen, dtype=cov.dtype,
                              device=cov.device)
    return chol @ normals.to(cov.dtype)


def cov_errors(approx: torch.Tensor, exact: torch.Tensor) -> dict:
    """Error metrics used in paper §5.1/§5.2 (MAE, max err, diag err)."""
    diff = torch.abs(approx - exact)
    return {
        "mae": torch.mean(diff),
        "max_abs_err": torch.max(diff),
        "max_diag_err": torch.max(torch.abs(torch.diagonal(approx)
                                            - torch.diagonal(exact))),
        "rel_fro": (torch.linalg.matrix_norm(approx - exact)
                    / torch.linalg.matrix_norm(exact)),
    }


def gauss_kl(cov_p: torch.Tensor, cov_q: torch.Tensor,
             jitter: float = 1e-10) -> torch.Tensor:
    """KL( N(0, cov_q) || N(0, cov_p) ): the paper's §5.1 model-selection
    measure for picking (n_csz, n_fsz), the information lost when the
    approximation q (ICR) stands in for the truth p (exact kernel)."""
    n = cov_p.shape[0]
    eye = torch.eye(n, dtype=cov_p.dtype, device=cov_p.device)
    chol_p = torch.linalg.cholesky(cov_p + jitter * eye)
    chol_q = torch.linalg.cholesky(cov_q + jitter * eye)
    # tr(P^-1 Q) via triangular solves
    a = torch.linalg.solve_triangular(chol_p, chol_q, upper=False)
    tr = torch.sum(a * a)
    logdet_p = 2.0 * torch.sum(torch.log(torch.diagonal(chol_p)))
    logdet_q = 2.0 * torch.sum(torch.log(torch.diagonal(chol_q)))
    return 0.5 * (tr - n + logdet_p - logdet_q)


def exact_posterior(cov: torch.Tensor, obs_idx, y: torch.Tensor,
                    noise_var: float) -> tuple:
    """Exact GP regression posterior (mean, cov) on all points given noisy
    observations of a subset; the oracle of the solver tests."""
    obs_idx = torch.as_tensor(obs_idx, device=cov.device)
    y = torch.as_tensor(y, dtype=cov.dtype, device=cov.device)
    k_oo = cov[obs_idx][:, obs_idx]
    k_xo = cov[:, obs_idx]
    n = k_oo.shape[0]
    g = k_oo + noise_var * torch.eye(n, dtype=cov.dtype, device=cov.device)
    sol = torch.linalg.solve(g, y)
    mean = k_xo @ sol
    post_cov = cov - k_xo @ torch.linalg.solve(g, k_xo.T)
    return mean, post_cov
