"""The data-conditioning linear system for ICR GPs.

The counterpart of the JAX package's ``solvers/gp_system.py``. Exact GP
regression conditions the ICR prior on noisy observations
``y = W s + ε``, ``ε ~ N(0, σ²I)``: with ``K = S Sᵀ`` (``S`` the ICR
square root, applied matrix-free) the posterior mean is

    m = K Wᵀ α,   (W K Wᵀ + σ² I) α = y

so one matvec of the observation-space operator ``A = W K Wᵀ + σ²I``
is *two* applications of the square root (``Sᵀ`` then ``S``, the
paper's §1 cost unit) bracketed by the sparse interpolation ``W``. On the
kernel route ``Sᵀ`` is ``ICR.apply_sqrt_T_batch``, the adjoint kernels
level by level with no forward pass, and ``S`` is
``ICR.apply_sqrt_batch``. This module builds what the guarded batched CG
needs to solve with A:

  * observation operators: :class:`ObsSelect` for on-grid index
    observations and :class:`GridInterp` for off-grid 1-D points by the
    KISS-GP sparse linear interpolation;
  * the batched matvec (:func:`condition_matvec`);
  * the **ICR-whitened preconditioner**: the coarse-level prefix of ξ
    spans the top of the kernel spectrum, so ``M = σ²I + U Uᵀ`` with
    ``U = W S_c`` captures the dominant eigenspace; ``M⁻¹`` applies by a
    small Cholesky-factored Woodbury correction;
  * the dense rung (A formed by matvecs on identity rows,
    ``torch.linalg.solve``) for small systems, the ladder's last rung.

The scatter and gather of W, the preconditioner's small GEMMs and
Cholesky and the CG vector updates are plain torch, as the JAX package
computes them outside Pallas too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

# fields of a batch of matvec rows held at once by ``dense_solve`` and
# ``icr_whitening_precond`` (elements of one field batch: 2**26 is 256 MB
# at float32, whatever the chart)
_CHUNK_ELEMENTS = 2**26
# the default solve's cap on the rounding its tolerance may rise to,
# relative to ‖y‖ (``ConditionSystem.default_config``): about 3x the
# largest float32 rounding at the solution read on a sound full-width
# system (3.0e-3: the 1M-point regular chart at 314,572 observations,
# σ = 0.05, H100), so no answer with a residual above 10x it (0.1) is
# ever called converged
DEFAULT_FLOOR_CAP = 1e-2
# the largest U (n_obs × basis, float64) the ICR-whitened preconditioner
# holds when level 0 alone exceeds its ``max_basis``
PRECOND_MAX_BYTES = 2**33


def _cached(op, device, name: str, make):
    """A tensor of the frozen operator `op`, built once per device."""
    cache = op.__dict__.get("_tensors")
    if cache is None:
        cache = {}
        object.__setattr__(op, "_tensors", cache)
    key = (name, str(torch.device(device)))
    if key not in cache:
        cache[key] = make()
    return cache[key]


# -- observation operators -------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ObsSelect:
    """On-grid observations: W selects ``idx`` out of the flattened field."""

    idx: tuple            # flat finest-grid indices (hashable for caching)
    n_grid: int

    @property
    def n_obs(self) -> int:
        return len(self.idx)

    def _idx(self, device) -> torch.Tensor:
        return _cached(self, device, "idx", lambda: torch.tensor(
            self.idx, dtype=torch.int64, device=device))

    def apply(self, f: torch.Tensor) -> torch.Tensor:
        """(k, N) field rows -> (k, O) observed rows."""
        return f[:, self._idx(f.device)]

    def apply_t(self, v: torch.Tensor) -> torch.Tensor:
        """(k, O) -> (k, N) scatter-add (Wᵀ), an ``index_add_``."""
        out = torch.zeros((v.shape[0], self.n_grid), dtype=v.dtype,
                          device=v.device)
        return out.index_add_(1, self._idx(v.device), v)

    def fingerprint(self) -> tuple:
        return ("select", self.n_grid, self.idx)


@dataclasses.dataclass(frozen=True)
class GridInterp:
    """Off-grid 1-D observations: sparse linear interpolation rows of W
    (two nonzeros per observation, the KISS-GP stencil, applied in
    O(n_obs) like ``KissGP.apply_w``/``apply_wt``)."""

    idx: tuple            # left grid neighbor per observation
    w_lo: tuple
    w_hi: tuple
    n_grid: int

    @classmethod
    def from_points(cls, grid_x: np.ndarray, x_obs: np.ndarray):
        """Build W from sorted uniform grid coordinates and observation
        locations (clipped to the grid span, as ``KissGP.interp_weights``
        does)."""
        grid_x = np.asarray(grid_x, np.float64)
        x_obs = np.asarray(x_obs, np.float64)
        h = float(grid_x[1] - grid_x[0])
        p = (x_obs - float(grid_x[0])) / h
        idx = np.clip(np.floor(p).astype(np.int64), 0, len(grid_x) - 2)
        frac = np.clip(p - idx, 0.0, 1.0)
        return cls(idx=tuple(int(i) for i in idx),
                   w_lo=tuple(float(w) for w in 1.0 - frac),
                   w_hi=tuple(float(w) for w in frac),
                   n_grid=len(grid_x))

    @property
    def n_obs(self) -> int:
        return len(self.idx)

    def _stencil(self, device, dtype) -> tuple:
        idx = _cached(self, device, "idx", lambda: torch.tensor(
            self.idx, dtype=torch.int64, device=device))
        wl = _cached(self, device, f"w_lo{dtype}", lambda: torch.tensor(
            self.w_lo, dtype=dtype, device=device))
        wr = _cached(self, device, f"w_hi{dtype}", lambda: torch.tensor(
            self.w_hi, dtype=dtype, device=device))
        return idx, wl, wr

    def apply(self, f: torch.Tensor) -> torch.Tensor:
        idx, wl, wr = self._stencil(f.device, f.dtype)
        return wl[None, :] * f[:, idx] + wr[None, :] * f[:, idx + 1]

    def apply_t(self, v: torch.Tensor) -> torch.Tensor:
        idx, wl, wr = self._stencil(v.device, v.dtype)
        out = torch.zeros((v.shape[0], self.n_grid), dtype=v.dtype,
                          device=v.device)
        out.index_add_(1, idx, wl[None, :] * v)
        return out.index_add_(1, idx + 1, wr[None, :] * v)

    def fingerprint(self) -> tuple:
        return ("interp", self.n_grid, self.idx, self.w_lo, self.w_hi)


def obs_operator(icr, *, obs_idx=None, x_obs=None):
    """Build the observation operator for a chart: flat finest-grid
    indices (any dimension) or off-grid 1-D locations, exactly one."""
    n = int(np.prod(icr.chart.final_shape))
    if (obs_idx is None) == (x_obs is None):
        raise ValueError("pass exactly one of obs_idx (on-grid) or "
                         "x_obs (off-grid 1-D)")
    if obs_idx is not None:
        if isinstance(obs_idx, torch.Tensor):
            obs_idx = obs_idx.cpu().numpy()
        idx = np.asarray(obs_idx, np.int64).ravel()
        if idx.size == 0 or idx.min() < 0 or idx.max() >= n:
            raise ValueError(f"obs_idx out of range for a {n}-pixel chart")
        return ObsSelect(idx=tuple(int(i) for i in idx), n_grid=n)
    if icr.chart.ndim != 1:
        raise ValueError("off-grid x_obs interpolation is 1-D only; "
                         "use on-grid obs_idx for N-D charts")
    grid_x = icr.chart.axis_coords(icr.chart.n_levels, 0)
    return GridInterp.from_points(grid_x, x_obs)


# -- the observation-space operator A = W K Wᵀ + σ²I ----------------------------
def _chunks(n: int, n_grid: int):
    """Row ranges of at most ``_CHUNK_ELEMENTS // n_grid`` rows."""
    rows = max(1, _CHUNK_ELEMENTS // max(n_grid, 1))
    for i in range(0, n, rows):
        yield slice(i, min(i + rows, n))


@dataclasses.dataclass
class ConditionSystem:
    """Everything one data-conditioning solve needs, built once per
    (chart, θ, obs, σ²) and cached by the server."""

    icr: object
    obs: object
    noise_var: float
    mats: dict
    matvec: Callable[[torch.Tensor], torch.Tensor]   # (k, O) -> (k, O)
    precond: Optional[Callable]          # ICR-whitened M⁻¹, or None
    # the solver's captured CG segments on this system (``pcg``'s
    # ``segment_graphs``): the ladder's rungs and repeated requests re-use
    graphs: dict = dataclasses.field(default_factory=dict)

    @property
    def n_obs(self) -> int:
        return self.obs.n_obs

    def default_config(self):
        """The ``CGConfig`` of a solve whose caller passes none: the JAX
        package's rtol 1e-7 and ``max_iters = max(4·n_obs, 200)``, and on
        float32 or bfloat16 matrices ``floor_cap = DEFAULT_FLOOR_CAP``.
        1e-7 lies under float32's floor on large systems (every CG rung
        then ends stalled); with the cap a column's bar rises to the
        rounding of one float32 matvec at its own iterate, so a column
        the solver calls converged has a true residual plus rounding
        within 10·max(rtol, min(δ, cap)) of ‖y‖ (``pcg._settle``), the
        bar ``chip_smoke.py`` holds α's float64 residual to."""
        from .pcg import CGConfig

        cap = (0.0 if self.mats["sqrt0"].dtype == torch.float64
               else DEFAULT_FLOOR_CAP)
        return CGConfig(rtol=1e-7, max_iters=max(4 * self.n_obs, 200),
                        floor_cap=cap)

    def dense_solve(self, b: torch.Tensor) -> torch.Tensor:
        """Form A by batched matvecs on identity rows and solve directly:
        the ladder's dense rung (gated by ``CGConfig.dense_max``). A is
        symmetric, so identity *rows* through the matvec give A itself, as
        in the JAX package; the rows run in chunks so that a full-width
        chart's fields fit on the card, which changes nothing of A. Where
        the JAX package solves at float32, the port factors A at float64
        and refines the solution twice against the matvec itself (a
        float32 LU of a 4,096-observation system leaves a residual some
        ten times the matvec's own rounding; the refined one is within
        a few times that rounding)."""
        lu = torch.linalg.lu_factor(
            self.dense_matrix(b.dtype, b.device).double())
        x = torch.linalg.lu_solve(*lu, b.T.double()).T
        for _ in range(2):
            r = b - self.matvec(x.to(b.dtype))
            x = x + torch.linalg.lu_solve(*lu, r.T.double()).T
        return x.to(b.dtype)

    def dense_matrix(self, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
        """A itself, (n_obs, n_obs): the dense rung's matrix."""
        n = self.n_obs
        a = torch.empty((n, n), dtype=dtype, device=device)
        n_grid = int(np.prod(self.icr.chart.final_shape))
        for rows in _chunks(n, n_grid):
            eye = torch.zeros((rows.stop - rows.start, n), dtype=dtype,
                              device=device)
            eye[torch.arange(eye.shape[0], device=device),
                torch.arange(rows.start, rows.stop, device=device)] = 1.0
            a[rows] = condition_matvec(self.icr, self.mats, self.obs,
                                       self.noise_var, eye)
        return a

    def correct(self, alpha: torch.Tensor) -> torch.Tensor:
        """K Wᵀ α for a batch of solutions: (k, O) -> (k, *final_shape)
        posterior corrections (one Sᵀ and one S application)."""
        return self.icr.apply_sqrt_batch(self.mats, self.project_xi(alpha))

    def project_xi(self, alpha: torch.Tensor) -> list:
        """Sᵀ Wᵀ α: the whitened (ξ-space) form of the conditioning
        correction, which a delta ``Posterior.mean`` serves through the
        sampling path unchanged."""
        shape = tuple(self.icr.chart.final_shape)
        u = self.obs.apply_t(alpha)
        return _sqrt_t_batch(self.icr, self.mats,
                             u.reshape((u.shape[0],) + shape))


def _sqrt_t_batch(icr, mats, u: torch.Tensor) -> list:
    """Batched Sᵀ: ``icr.apply_sqrt_T_batch``, on the kernel route the
    adjoint kernels level by level with no forward pass (the JAX package
    takes the VJP of ``apply_sqrt_batch`` at zero ξ). Uncached: inside a
    captured CG segment the chain is recorded into the segment's graph,
    and every other call here is a one-off."""
    with torch.no_grad():
        return icr.apply_sqrt_T_batch(mats, u, cached=False)


def condition_matvec(icr, mats, obs, noise_var, v: torch.Tensor
                     ) -> torch.Tensor:
    """(W S Sᵀ Wᵀ + σ²I) v for a batch of observation-space vectors. Under
    a bfloat16 storage policy the square root runs at bfloat16 and the
    result is returned in ``v``'s dtype, as in the JAX package."""
    k = v.shape[0]
    shape = tuple(icr.chart.final_shape)
    u = obs.apply_t(v).reshape((k,) + shape)
    xi = _sqrt_t_batch(icr, mats, u)
    with torch.no_grad():
        f = icr.apply_sqrt_batch(mats, xi).reshape(k, -1)
    return obs.apply(f).to(v.dtype) + noise_var * v


def icr_whitening_precond(icr, mats, obs, noise_var: float, *,
                          max_basis: int = 512) -> Optional[Callable]:
    """The ICR-whitened (coarse-subspace Woodbury) preconditioner.

    Take the coarse prefix of ξ levels whose total size fits
    ``max_basis``: their span carries the top of the kernel spectrum, the
    slowly-converging CG directions. With ``U = W S_c`` (obs × m, the
    sqrt applied to the m basis excitations, in chunks of rows)
    precondition with

        M = σ² I + U Uᵀ,
        M⁻¹ r = (r − U C⁻¹ Uᵀ r) / σ²,   C = σ² I_m + Uᵀ U  (Cholesky).

    Exact on the coarse subspace, identity/σ² on its complement. Where
    level 0 alone exceeds ``max_basis`` the JAX package returns None and
    its ladder starts at the unpreconditioned rung; on full-width charts
    (2,048 basis columns on dust, 1,024 on regular) that rung does not
    come near float32's floor at 314,572 observations (``PERF.md``), so
    the port takes level 0 alone while U's bytes (n_obs · m · 8) stay
    within ``PRECOND_MAX_BYTES`` (8 GiB: 5.2 GB on dust at 314,572
    observations), and returns None above it. The factor is applied by two triangular
    solves, which never read the host, so a captured CG segment holds the
    application. U (the float32 fields, held at float64), C and the
    correction run at float64, where the JAX package works at float32: at
    full width σ²I + UᵀU loses its positive definiteness in float32 once
    ‖U‖²/σ² nears 1/ε₃₂, and ``r − U C⁻¹ Uᵀ r`` cancels to below its
    rounding before the division by σ² (the dust and regular charts at
    314,572 observations, σ = 0.05, on the H100). A failed factorisation
    raises. The returned function's ``nbytes`` is what U and the factor
    hold on the device.
    """
    shapes = [tuple(s) for s in icr.xi_shapes()]
    sizes = [int(np.prod(s)) for s in shapes]
    take = 0
    total = 0
    for s in sizes:
        if take > 0 and total + s > max_basis:
            break
        take += 1
        total += s
    if total > max_basis and obs.n_obs * total * 8 > PRECOND_MAX_BYTES:
        return None
    m = total
    device = mats["sqrt0"].device
    n_grid = int(np.prod(icr.chart.final_shape))
    u = torch.empty((obs.n_obs, m), dtype=torch.float64, device=device)
    storage = icr.policy.storage_dtype
    for rows in _chunks(m, n_grid):
        # row j of the basis is e_{rows.start + j} within the coarse prefix
        flat = torch.zeros((rows.stop - rows.start, sum(sizes)),
                           dtype=torch.float32, device=device)
        flat[torch.arange(flat.shape[0], device=device),
             torch.arange(rows.start, rows.stop, device=device)] = 1.0
        basis, off = [], 0
        for s, n in zip(shapes, sizes):
            basis.append(flat[:, off:off + n].reshape((-1,) + s)
                         .to(storage).contiguous())
            off += n
        with torch.no_grad():
            fields = icr.apply_sqrt_batch(mats, basis).reshape(
                basis[0].shape[0], -1)
        u[:, rows] = obs.apply(fields.float()).T
    c = noise_var * torch.eye(m, dtype=u.dtype, device=device) + u.T @ u
    chol = torch.linalg.cholesky(c)

    def precond(r: torch.Tensor) -> torch.Tensor:
        r64 = r.double()
        w = torch.linalg.solve_triangular(chol, (r64 @ u).T, upper=False)
        s = torch.linalg.solve_triangular(chol.T, w, upper=True).T  # (k, m)
        return ((r64 - s @ u.T) / noise_var).to(r.dtype)

    precond.nbytes = (u.numel() + chol.numel()) * 8
    return precond


def build_condition_system(icr, obs, noise_var: float, *, theta=None,
                           mats=None, mesh=None,
                           precond_max_basis: int = 512,
                           use_precond: bool = True) -> ConditionSystem:
    """Assemble the conditioning system on ``icr``'s device. A ``mesh``
    (the JAX package's RHS-sharded matvec) is not ported yet and
    raises."""
    if mesh is not None:
        raise NotImplementedError(
            "build_condition_system: the RHS-sharded matvec over a mesh "
            "waits for the port's distributed modules (ROADMAP queue 1, "
            "item 8)")
    if mats is None:
        mats = icr.matrices_cached(theta)
    noise_var = float(noise_var)

    def matvec(v: torch.Tensor) -> torch.Tensor:
        return condition_matvec(icr, mats, obs, noise_var, v)

    precond = (icr_whitening_precond(icr, mats, obs, noise_var,
                                     max_basis=precond_max_basis)
               if use_precond else None)
    return ConditionSystem(icr=icr, obs=obs, noise_var=noise_var,
                           mats=mats, matvec=matvec, precond=precond)
