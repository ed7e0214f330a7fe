"""Refinement matrices and one refinement step (paper §4.1–4.4).

A refinement family conditions ``n_fsz^d`` fine pixels on their ``n_csz^d``
nearest coarse pixels:

    R      = K_fc K_cc^{-1}                      (paper Eq. 7)
    D      = K_ff − K_fc K_cc^{-1} K_cf          (paper Eq. 8)
    s_f    = R s_c + sqrt(D) ξ_f                 (paper Eq. 9)

On chart-invariant axes every family shares one set of matrices (paper
§4.3). The matrices are built with batched ``torch.linalg`` solves and
eigendecompositions over the families. ``refine_level`` is the plain
apply path; the kernel route lives in ``repro_torch.kernels``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .charts import Chart
from .kernels import kernel_matrix


def _family_positions(chart: Chart, level: int):
    """Per-axis chart coords of family windows, collapsed on invariant axes.

    Returns (coarse_axes, fine_axes, full_T, kept_T):
      coarse_axes[a]: (T'_a, n_csz) chart coords (T'_a == 1 if invariant)
      fine_axes[a]:   (T'_a, n_fsz)
      full_T: true family counts per axis; kept_T: materialized counts.
    """
    coarse_axes, fine_axes, full_T, kept_T = [], [], [], []
    for a in range(chart.ndim):
        cw = chart.axis_coarse_windows(level, a)
        fw = chart.axis_fine_windows(level, a)
        full_T.append(cw.shape[0])
        if chart.invariant[a]:
            # representative family: an interior one, away from the boundary
            rep = min(cw.shape[0] - 1, chart.b)
            cw, fw = cw[rep : rep + 1], fw[rep : rep + 1]
        coarse_axes.append(cw)
        fine_axes.append(fw)
        kept_T.append(cw.shape[0])
    return coarse_axes, fine_axes, tuple(full_T), tuple(kept_T)


def _mean_diag(m: torch.Tensor) -> torch.Tensor:
    return m.diagonal(dim1=-2, dim2=-1).mean(-1)[..., None, None]


# cuSOLVER's batched eigh (torch 2.11, CUDA 12.8) rejects a batch of 65536
# 4x4 matrices with CUSOLVER_STATUS_INVALID_VALUE on an H100, and takes
# 1000; the charted 1-D levels have ~65K families, so batches are split
_EIGH_CHUNK = 1024


def _eigh(mat: torch.Tensor):
    """``torch.linalg.eigh`` over a batch of matrices, in chunks of at most
    ``_EIGH_CHUNK`` matrices."""
    if mat.ndim == 2:
        return torch.linalg.eigh(mat)
    flat = mat.reshape((-1,) + mat.shape[-2:])
    parts = [torch.linalg.eigh(c) for c in flat.split(_EIGH_CHUNK)]
    return (torch.cat([p[0] for p in parts]).reshape(mat.shape[:-1]),
            torch.cat([p[1] for p in parts]).reshape(mat.shape))


class _PsdSqrt(torch.autograd.Function):
    """``S = V f(Λ) Vᵀ`` with ``f(λ) = sqrt(max(λ, eps))``: the symmetric
    square root of a symmetric (nearly) PSD matrix ``A = V Λ Vᵀ``, with
    its eigenvalues clipped at ``eps``.

    Its derivative is the Daleckii–Krein form
    ``dS = V (Φ ∘ Vᵀ dA V) Vᵀ`` with the divided differences
    ``Φ_ij = (f(λ_i) − f(λ_j)) / (λ_i − λ_j)``, written here as
    ``c[λ_i, λ_j] / (f(λ_i) + f(λ_j))`` with ``c(λ) = max(λ, eps)``:
    ``c[·,·]`` is 1 where both eigenvalues are kept, 0 where both are
    clipped and in (0, 1] between the two, so ``Φ`` is exact at ties
    (``f'(λ)``) and loses no digits at near-ties. It does not depend on
    the eigenvectors that eigh picks within a (nearly) repeated
    eigenspace, which the backward of eigh itself does (``1/(λ_j − λ_i)``
    terms): through eigh, θ-gradients came out NaN at exact ties and
    changed from one float32 evaluation to the next at near-ties."""

    @staticmethod
    def forward(ctx, mat, eps):
        evals, evecs = _eigh(mat)
        root = torch.sqrt(torch.maximum(evals, eps[..., 0]))
        ctx.save_for_backward(evals, evecs, root, eps)
        return (evecs * root[..., None, :]) @ evecs.transpose(-1, -2)

    @staticmethod
    def backward(ctx, g):
        evals, evecs, root, eps = ctx.saved_tensors
        inner = evecs.transpose(-1, -2) @ g @ evecs
        kept = evals > eps[..., 0]
        both = kept[..., :, None] & kept[..., None, :]
        mixed = kept[..., :, None] ^ kept[..., None, :]
        c = torch.maximum(evals, eps[..., 0])
        gap = torch.where(mixed, evals[..., :, None] - evals[..., None, :],
                          1.0)
        slope = torch.where(mixed, (c[..., :, None] - c[..., None, :]) / gap,
                            both.to(c.dtype))
        phi = slope / (root[..., :, None] + root[..., None, :])
        g_mat = evecs @ (phi * inner) @ evecs.transpose(-1, -2)
        g_eps = None
        if ctx.needs_input_grad[1]:
            # dS/d eps = V diag(1[clipped] / (2 sqrt(eps))) Vᵀ
            diag = inner.diagonal(dim1=-2, dim2=-1)
            g_eps = torch.where(kept, 0.0, diag / (2 * root)).sum(
                -1, keepdim=True)[..., None].sum_to_size(eps.shape)
        return g_mat, g_eps


def _psd_sqrt(mat: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """A square root of a (nearly) PSD matrix, with eigenvalues clipped at
    ``eps`` (shape ``(..., 1, 1)``). Any ``S`` with ``S Sᵀ = D`` will do
    (paper §3.2); eigh stays finite where Cholesky fails on the
    numerically semi-definite ``D`` of strongly correlated fine points.
    The JAX package returns ``V sqrt(Λ)``; this is the symmetric root
    ``V sqrt(Λ) Vᵀ``, which differs from it by an orthogonal factor on
    the right, invisible to the standard normal ξ it multiplies, and
    whose θ-derivative does not depend on the eigenvectors eigh picks
    (``_PsdSqrt``)."""
    return _PsdSqrt.apply(mat, eps)


def _family_points(windows, device, dtype=torch.float32) -> torch.Tensor:
    """Tensor product of per-axis family windows.

    windows[a]: (K_a, W) chart coords -> (*K, W^d, ndim): for every family
    index tuple, the window points in row-major (k_0, ..., k_{d-1}) order.
    """
    nd = len(windows)
    kk = [w.shape[0] for w in windows]
    width = windows[0].shape[1]
    cols = []
    for a in range(nd):
        t = torch.as_tensor(windows[a], dtype=dtype, device=device)
        shape = [1] * (2 * nd)
        shape[a], shape[nd + a] = kk[a], width
        cols.append(t.reshape(shape).expand(*kk, *([width] * nd)))
    return torch.stack(cols, dim=-1).reshape(*kk, width**nd, nd)


def _conditional(k_cc, k_fc, k_ff, jitter, *, scale=None):
    """(R, sqrt(D)) of Eq. 7/8 for batched kernel blocks; ``scale``
    divides D (and its jitter reference) by the kernel variance."""
    eps = jitter * _mean_diag(k_cc)
    eye = torch.eye(k_cc.shape[-1], dtype=k_cc.dtype, device=k_cc.device)
    k_cc = k_cc + eps * eye
    r = torch.linalg.solve(k_cc, k_fc.transpose(-1, -2)).transpose(-1, -2)
    d = k_ff - r @ k_fc.transpose(-1, -2)
    d = 0.5 * (d + d.transpose(-1, -2))
    if scale is not None:
        d, k_ff = d / scale, k_ff / scale
    return r, _psd_sqrt(d, jitter * _mean_diag(k_ff))


def refinement_matrices_level(chart: Chart, kernel_fn: Callable, level: int,
                              *, jitter: float = 1e-6, device="cuda",
                              dtype=torch.float32):
    """Joint refinement matrices (R, sqrt(D)) for all families refining
    `level`, batched over the families.

    Returns R: (*kept_T, n_fsz^d, n_csz^d), sqrtD: (*kept_T, n_fsz^d,
    n_fsz^d), `dtype` on `device` (the card by default, as ``ICR``).
    """
    coarse_axes, fine_axes, _, _ = _family_positions(chart, level)
    cpos = chart.map_to_D(_family_points(coarse_axes, device, dtype))
    fpos = chart.map_to_D(_family_points(fine_axes, device, dtype))
    return _conditional(kernel_matrix(kernel_fn, cpos),
                        kernel_matrix(kernel_fn, fpos, cpos),
                        kernel_matrix(kernel_fn, fpos), jitter)


def axis_refinement_matrices_level(chart: Chart, kernel_fn: Callable,
                                   level: int, *, jitter: float = 1e-6,
                                   device="cuda", dtype=torch.float32):
    """Per-axis 1-D refinement factors for the separable N-D route.

    Axis ``a``'s factors come from its 1-D coarse/fine windows with every
    other coordinate pinned at the grid midpoint; applied axis by axis they
    are the Kronecker-factored refinement

        R_joint = R_0 ⊗ ... ⊗ R_{d-1},   sqrtD_joint = sqrtD_0 ⊗ ...

    The noise factors of axes ``a > 0`` are divided by ``k(0)``, so the
    product carries the kernel variance once.

    Returns ``(rs, ds)``: ``rs[a]`` is ``(n_fsz, n_csz)`` on invariant
    axes, else ``(T_a, n_fsz, n_csz)``; ``ds[a]`` likewise with
    ``n_csz -> n_fsz``.
    """
    nd = chart.ndim
    k0 = kernel_matrix(kernel_fn,
                       torch.zeros((1, max(1, nd)), device=device,
                                   dtype=dtype))[0, 0]
    rep_coord = [chart.axis_coords(level, o)[chart.shape(level)[o] // 2]
                 for o in range(nd)]

    def pts(wins, axis):
        wins = torch.as_tensor(wins, dtype=dtype, device=device)
        cols = [wins if o == axis else torch.full_like(wins, rep_coord[o])
                for o in range(nd)]
        return chart.map_to_D(torch.stack(cols, dim=-1))

    rs, ds = [], []
    for a in range(nd):
        cw = chart.axis_coarse_windows(level, a)
        fw = chart.axis_fine_windows(level, a)
        if chart.invariant[a]:
            rep = min(cw.shape[0] - 1, chart.b)
            cw, fw = cw[rep : rep + 1], fw[rep : rep + 1]
        cpos, fpos = pts(cw, a), pts(fw, a)
        r, sqrt_d = _conditional(kernel_matrix(kernel_fn, cpos),
                                 kernel_matrix(kernel_fn, fpos, cpos),
                                 kernel_matrix(kernel_fn, fpos), jitter,
                                 scale=k0 if a > 0 else None)
        if chart.invariant[a]:
            r, sqrt_d = r[0], sqrt_d[0]
        rs.append(r)
        ds.append(sqrt_d)
    return rs, ds


def level0_sqrt(chart: Chart, kernel_fn: Callable, *, jitter: float = 1e-6,
                device="cuda", dtype=torch.float32) -> torch.Tensor:
    """Exact square root of the level-0 kernel matrix (small by design)."""
    k = kernel_matrix(kernel_fn, chart.grid_positions(0, device=device,
                                                      dtype=dtype))
    return _psd_sqrt(0.5 * (k + k.T), jitter * _mean_diag(k))


@dataclasses.dataclass(frozen=True)
class LevelGeom:
    """Static geometry of one refinement application."""

    coarse_shape: tuple
    fine_shape: tuple
    T: tuple          # families per axis
    kept_T: tuple     # materialized matrix counts per axis (1 on invariant)
    n_csz: int
    n_fsz: int
    stride: int
    b: int
    boundary: str

    @classmethod
    @functools.lru_cache(maxsize=256)
    def for_level(cls, chart: Chart, level: int) -> "LevelGeom":
        # counts only, and cached per (chart, level): every apply asks for
        # every level's geometry, and building the windows
        # (``_family_positions``) costs milliseconds of host time per
        # level on a 1M-point chart
        full_T = tuple(chart.family_count(level, a)
                       for a in range(chart.ndim))
        kept_T = tuple(1 if inv else t
                       for inv, t in zip(chart.invariant, full_T))
        return cls(coarse_shape=chart.shape(level),
                   fine_shape=chart.shape(level + 1), T=full_T, kept_T=kept_T,
                   n_csz=chart.n_csz, n_fsz=chart.n_fsz, stride=chart.stride,
                   b=chart.b, boundary=chart.boundary)


def _pad(x: torch.Tensor, b: int, ndim: int) -> torch.Tensor:
    lead = x.shape[:-ndim]
    y = F.pad(x.reshape((1, -1) + x.shape[-ndim:]), (b, b) * ndim,
              mode="reflect")
    return y.reshape(lead + y.shape[2:])


class _ReflectPad(torch.autograd.Function):
    """``F.pad(mode="reflect")`` with ``reflect_pad_T`` as its backward.
    On CUDA, F.pad's own backward adds the reflected cotangents with
    atomics; on two or more axes up to 2^ndim of them meet at a corner, in
    an order that changes from run to run. Folding them back axis by axis
    is the same sum in a fixed order, so a step's gradient, and a captured
    step's, is the same in every run."""

    @staticmethod
    def forward(ctx, x, b, ndim):
        ctx.b, ctx.ndim = b, ndim
        return _pad(x, b, ndim)

    @staticmethod
    def backward(ctx, g):
        return reflect_pad_T(g, ctx.b, ctx.ndim), None, None


def reflect_pad(x: torch.Tensor, b: int, ndim: int) -> torch.Tensor:
    """Reflect-pad the last `ndim` axes of `x` by `b` on each side
    (numpy's ``"reflect"``: the edge is not repeated); differentiable.
    Where F.pad's backward would add three or more cotangents into one
    entry (two or more axes, or an axis of at most 2b + 1 entries), the
    backward is the fixed-order ``reflect_pad_T`` (``_ReflectPad``); one
    axis adds at most two, and a sum of two is the same in either
    order, so that case, and every call that records no gradient, takes
    F.pad alone."""
    if (torch.is_grad_enabled() and x.requires_grad
            and (ndim > 1 or x.shape[-1] <= 2 * b + 1)):
        return _ReflectPad.apply(x, b, ndim)
    return _pad(x, b, ndim)


def reflect_pad_T(y: torch.Tensor, b: int, ndim: int) -> torch.Tensor:
    """Transpose of ``reflect_pad``: fold the `b` reflected entries of each
    side of the last `ndim` axes back onto the entries they copy."""
    for ax in range(y.ndim - ndim, y.ndim):
        n = y.shape[ax] - 2 * b
        core = y.narrow(ax, b, n).clone()
        core.narrow(ax, 1, b).add_(y.narrow(ax, 0, b).flip(ax))
        core.narrow(ax, n - 1 - b, b).add_(y.narrow(ax, n + b, b).flip(ax))
        y = core
    return y


def refine_level(coarse: torch.Tensor, xi: torch.Tensor, r: torch.Tensor,
                 sqrt_d: torch.Tensor, geom: LevelGeom) -> torch.Tensor:
    """One refinement application (paper Eq. 9 / Alg. 1 inner loop), the
    plain path with the joint matrices.

    coarse: (*coarse_shape); xi: (prod(T), n_fsz^d);
    r: (*kept_T, fsz^d, csz^d); sqrt_d: (*kept_T, fsz^d, fsz^d)
    -> fine field (*fine_shape).
    """
    nd = len(geom.coarse_shape)
    w = coarse
    if geom.boundary == "reflect":
        w = reflect_pad(w, geom.b, nd)
    for a in range(nd):  # window dims append at the end, in axis order
        w = w.unfold(a, geom.n_csz, geom.stride)
    csz, fsz = geom.n_csz**nd, geom.n_fsz**nd
    w = w.reshape(geom.T + (csz,))

    # batched GEMM over the non-invariant family axes only: shared matrices
    # are never broadcast to one copy per family
    kept_axes = [a for a in range(nd) if geom.kept_T[a] > 1]
    inv_axes = [a for a in range(nd) if geom.kept_T[a] == 1]
    perm = kept_axes + inv_axes
    k_tot = int(np.prod([geom.T[a] for a in kept_axes]))
    i_tot = int(np.prod([geom.T[a] for a in inv_axes]))
    w_p = w.permute(perm + [nd]).reshape(k_tot, i_tot, csz)
    xi_p = (xi.reshape(geom.T + (fsz,)).permute(perm + [nd])
            .reshape(k_tot, i_tot, fsz))
    fine = torch.einsum("kic,kfc->kif", w_p, r.reshape(k_tot, fsz, csz))
    fine = fine + torch.einsum("kif,kgf->kig", xi_p,
                               sqrt_d.reshape(k_tot, fsz, fsz))

    # back to (*T, fsz^d), then interleave family and child dims
    t_perm = [geom.T[a] for a in perm]
    inv_perm = [perm.index(a) for a in range(nd)]
    fine = fine.reshape(t_perm + [fsz]).permute(inv_perm + [nd])
    fine = fine.reshape(geom.T + (geom.n_fsz,) * nd)
    interleave = []
    for a in range(nd):
        interleave += [a, nd + a]
    return fine.permute(interleave).reshape(geom.fine_shape)



def refine_level_T(fine_cot: torch.Tensor, r: torch.Tensor,
                   sqrt_d: torch.Tensor, geom: LevelGeom) -> tuple:
    """Adjoint of ``refine_level`` in (coarse, xi) at fixed matrices: the
    level is linear in (coarse, xi), so its VJP at the origin is the
    transpose. The plain path's building block of ``ICR.apply_sqrt_T``;
    differentiable in the cotangent and the matrices where grad is on.

    fine_cot: (*fine_shape) -> (dcoarse: (*coarse_shape),
    dxi: (prod(T), n_fsz^d)).
    """
    nd = len(geom.coarse_shape)
    kw = dict(dtype=fine_cot.dtype, device=fine_cot.device,
              requires_grad=True)
    zc = torch.zeros(geom.coarse_shape, **kw)
    zx = torch.zeros((int(np.prod(geom.T)), geom.n_fsz**nd), **kw)
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        out = refine_level(zc, zx, r, sqrt_d, geom)
        dc, dx = torch.autograd.grad(out, (zc, zx), fine_cot,
                                     create_graph=create)
    return dc, dx
