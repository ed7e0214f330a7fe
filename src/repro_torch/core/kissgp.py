"""KISS-GP baseline (paper §2, §5.2; Wilson & Nickisch 2015).

The counterpart of the JAX package's ``core/kissgp.py``.
K_XX ≈ W K_UU Wᵀ with M regularly spaced inducing points, sparse linear
interpolation W and Toeplitz K_UU applied via circulant (FFT) embedding on
a padded circle, the paper's Eq. 15 representation
``K = W · F · P · Fᵀ · Wᵀ`` with padding factor 0.5.

The timed "forward pass" is the paper's §5.2 protocol: apply the inverse
kernel matrix with 40 CG iterations and estimate the log-determinant with
10 probes × 15 Lanczos iterations. Every operator takes a vector or a
batch of them along the last axis; tensors live on ``device``
(``"cuda"`` by default). ``logdet_slq`` draws its probes from a
``torch.Generator`` where the JAX package takes a PRNG key.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class KissGP:
    """KISS-GP on 1-D modeled points `x` (sorted, arbitrary spacing)."""

    x: np.ndarray                 # (N,) modeled point locations in D
    kernel_fn: Callable           # stationary kernel k(d)
    m: int | None = None          # inducing points (default M = N)
    padding: float = 0.5          # circle padding factor (paper §5.2)
    jitter: float = 1e-6
    device: str = "cuda"

    # -- geometry -------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.x)

    @property
    def m_ind(self) -> int:
        return self.m or self.n

    @property
    def mp(self) -> int:
        return int(round(self.m_ind * (1.0 + self.padding)))

    def _grid(self):
        x = np.asarray(self.x)
        lo, hi = float(x.min()), float(x.max())
        h = (hi - lo) / (self.m_ind - 1)
        return lo, h

    def _circle_kernel(self) -> torch.Tensor:
        """k at the padded circle's distances (float32, on ``device``)."""
        _, h = self._grid()
        j = np.arange(self.mp)
        d = h * np.minimum(j, self.mp - j)  # circle distance
        return self.kernel_fn(torch.tensor(d, dtype=torch.float32,
                                           device=self.device))

    def interp_weights(self):
        """Sparse linear interpolation W: (idx_lo, w_lo, w_hi) per point,
        built once per instance on ``device``."""
        cached = self.__dict__.get("_weights")
        if cached is None:
            lo, h = self._grid()
            p = (np.asarray(self.x) - lo) / h
            idx = np.clip(np.floor(p).astype(np.int64), 0, self.m_ind - 2)
            frac = p - idx

            def t(a, dtype=torch.float32):
                return torch.tensor(a, dtype=dtype, device=self.device)

            cached = (t(idx, torch.int64), t(1.0 - frac), t(frac))
            object.__setattr__(self, "_weights", cached)
        return cached

    def spectrum(self) -> torch.Tensor:
        """P: circulant eigenvalues of the padded-circle kernel (Eq. 15)."""
        p = torch.fft.rfft(self._circle_kernel()).real
        return torch.clamp_min(p, 0.0)  # clip tiny negative leakage

    # -- operator applications -------------------------------------------------
    def apply_w(self, u: torch.Tensor) -> torch.Tensor:
        idx, wl, wr = self.interp_weights()
        return wl * u[..., idx] + wr * u[..., idx + 1]

    def apply_wt(self, v: torch.Tensor) -> torch.Tensor:
        idx, wl, wr = self.interp_weights()
        out = torch.zeros(v.shape[:-1] + (self.m_ind,), dtype=v.dtype,
                          device=v.device)
        out.index_add_(v.ndim - 1, idx, wl * v)
        return out.index_add_(v.ndim - 1, idx + 1, wr * v)

    def apply_kuu(self, u: torch.Tensor,
                  p: torch.Tensor | None = None) -> torch.Tensor:
        p = self.spectrum() if p is None else p
        up = torch.zeros(u.shape[:-1] + (self.mp,), dtype=u.dtype,
                         device=u.device)
        up[..., :self.m_ind] = u
        return torch.fft.irfft(torch.fft.rfft(up) * p,
                               n=self.mp)[..., :self.m_ind]

    def matvec(self, v: torch.Tensor,
               p: torch.Tensor | None = None) -> torch.Tensor:
        """K v = W K_UU Wᵀ v (+ jitter v to keep CG well-posed, §5.2)."""
        p = self.spectrum() if p is None else p
        return (self.apply_w(self.apply_kuu(self.apply_wt(v), p))
                + self.jitter * v)

    def apply_sqrt(self, xi: torch.Tensor,
                   p: torch.Tensor | None = None) -> torch.Tensor:
        """Generative sqrt: s = W F⁻¹ sqrt(P) ξ (harmonic-domain sqrt)."""
        p = self.spectrum() if p is None else p
        half = self.mp // 2 + 1
        spec = (torch.sqrt(p) * xi[..., :half]).to(torch.complex64)
        u = torch.fft.irfft(spec, n=self.mp) * np.sqrt(self.mp)
        return self.apply_w(u[..., :self.m_ind])

    @property
    def xi_size(self) -> int:
        return self.mp // 2 + 1

    # -- dense (validation only, paper Fig. 3 bottom) ---------------------------
    def dense_cov(self) -> torch.Tensor:
        c = self._circle_kernel().cpu().numpy()
        kuu = c[np.abs(np.subtract.outer(np.arange(self.m_ind),
                                         np.arange(self.m_ind))) % self.mp]
        idx, wl, wr = (a.cpu().numpy() for a in self.interp_weights())
        w = np.zeros((self.n, self.m_ind))
        w[np.arange(self.n), idx] = wl
        w[np.arange(self.n), idx + 1] = wr
        return torch.tensor(w @ kuu @ w.T, dtype=torch.float32,
                            device=self.device)

    # -- paper §5.2 forward pass -------------------------------------------------
    def solve(self, y: torch.Tensor, *, rtol: float = 1e-6,
              max_iters: int = 40, p: torch.Tensor | None = None) -> tuple:
        """K⁻¹ y through the guarded batched CG core (``solvers.pcg``):
        a tolerance early-exit under the paper's 40-iteration cap, with
        the breakdown, divergence/NaN and stagnation monitors. Returns
        ``(x, stats)`` with the solve's ``status``/``iters``/``relres``
        scalars."""
        from repro_torch.solvers import CGConfig, pcg_iterate

        p = self.spectrum() if p is None else p
        cfg = CGConfig(rtol=rtol, max_iters=max_iters)
        x, stats, _ = pcg_iterate(lambda v: self.matvec(v, p), y[None, :],
                                  cfg=cfg)
        return x[0], {k: v[0] if v.ndim else v for k, v in stats.items()}

    def solve_cg(self, y: torch.Tensor, iters: int = 40,
                 p: torch.Tensor | None = None) -> torch.Tensor:
        """Deprecated shim with the pre-guard signature of :meth:`solve`:
        the guarded core with ``iters`` as the cap, returning x only."""
        warnings.warn("KissGP.solve_cg is deprecated; use KissGP.solve "
                      "(guarded CG with tolerance early-exit and "
                      "breakdown reporting)", DeprecationWarning,
                      stacklevel=2)
        return self.solve(y, max_iters=iters, p=p)[0]

    def logdet_slq(self, gen: torch.Generator | None = None,
                   probes: int = 10, lanczos_iters: int = 15,
                   p: torch.Tensor | None = None) -> torch.Tensor:
        """Stochastic Lanczos quadrature log-det (paper: 10 × 15), the
        probes as one batch of Rademacher vectors drawn from `gen`."""
        p = self.spectrum() if p is None else p
        z = (torch.randint(0, 2, (probes, self.n), generator=gen,
                           device=self.device) * 2 - 1).to(p.dtype)
        nz = torch.linalg.vector_norm(z, dim=1)
        m_it = lanczos_iters
        q_prev, q = torch.zeros_like(z), z / nz[:, None]
        alpha = torch.zeros((probes, m_it), dtype=p.dtype,
                            device=self.device)
        beta = torch.zeros((probes, m_it + 1), dtype=p.dtype,
                           device=self.device)
        live = torch.ones(probes, dtype=torch.bool, device=self.device)
        for i in range(m_it):
            w = self.matvec(q, p) - beta[:, i, None] * q_prev
            a = torch.sum(w * q, dim=1)
            w = w - a[:, None] * q
            # full reorthogonalization is skipped (the cheap setting the
            # paper grants KISS-GP)
            b = torch.linalg.vector_norm(w, dim=1)
            # Lanczos breakdown: ||w|| ≈ 0 means the Krylov space is
            # exhausted. Truncate: zero the coupling β so T becomes block
            # diagonal, park the dead block's diagonal at 1 (log 1 = 0)
            # and stop iterating this probe
            ok = live & (b > 1e-6 * (torch.abs(a) + beta[:, i] + 1e-30))
            alpha[:, i] = torch.where(live, a, 1.0)
            beta[:, i + 1] = torch.where(ok, b, 0.0)
            q_next = torch.where(
                ok[:, None], w / torch.where(b == 0, 1.0, b)[:, None], 0.0)
            q_prev, q, live = q, q_next, ok
        t = (torch.diag_embed(alpha) + torch.diag_embed(beta[:, 1:m_it], 1)
             + torch.diag_embed(beta[:, 1:m_it], -1))
        evals, evecs = torch.linalg.eigh(t)
        evals = torch.clamp_min(evals, self.jitter)
        per_probe = nz**2 * torch.sum(evecs[:, 0, :] ** 2 * torch.log(evals),
                                      dim=1)
        return per_probe.mean()

    def forward_pass(self, y: torch.Tensor,
                     gen: torch.Generator | None = None) -> tuple:
        """The §5.2 timed unit: K⁻¹y (40 CG) + logdet (10×15 SLQ)."""
        p = self.spectrum()
        return (self.solve(y, max_iters=40, p=p)[0],
                self.logdet_slq(gen, 10, 15, p))
