"""Refinement matrices and one refinement step (paper §4.1–4.4).

A refinement family conditions ``n_fsz^d`` fine pixels on their ``n_csz^d``
nearest coarse pixels:

    R      = K_fc K_cc^{-1}                      (paper Eq. 7)
    D      = K_ff − K_fc K_cc^{-1} K_cf          (paper Eq. 8)
    s_f    = R s_c + sqrt(D) ξ_f                 (paper Eq. 9)

On chart-invariant axes every family shares one set of matrices (paper
§4.3). The matrices are built over the families in batches, with no host
sync on the card, so that a learned-θ step can be captured as one CUDA
graph (``core/vi._fit``):

* the window coordinates live on the device, made once per (chart, level,
  axis, device, dtype) (``_axis_windows``, ``Chart.grid_positions``);
* every float32 family of at most 32 points is decomposed by the batched
  Jacobi eigensolver ``kernels/sym_eig.sym_eig`` (its plain version on the
  CPU): the symmetric root of D and the SPD solve of ``K_cc`` alike
  (``_SpdSolve``); larger families, and float64 references, by
  ``torch.linalg.eigh``, which syncs and cannot be captured;
* the level-0 root is the Cholesky factor of ``K + eps·I`` in float64
  (``level0_sqrt``; ``cholesky_ex`` leaves its info on the device);
* each factorisation's status (the Jacobi's off-diagonal norm, the
  Cholesky info) stays on the device, collected by ``build_checks()``: a
  fit reads them once, after its last step; a build outside one, as it
  ends.

``refine_level`` is the plain apply path; the kernel route lives in
``repro_torch.kernels``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .charts import Chart
from .kernels import kernel_matrix


def _device(device) -> torch.device:
    """`device` with its index: the cache keys of the device geometry."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=1024)
def _axis_windows_on(chart: Chart, level: int, axis: int,
                     device: torch.device, dtype) -> tuple:
    cw = chart.axis_coarse_windows(level, axis)
    fw = chart.axis_fine_windows(level, axis)
    if chart.invariant[axis]:
        # representative family: an interior one, away from the boundary
        rep = min(cw.shape[0] - 1, chart.b)
        cw, fw = cw[rep : rep + 1], fw[rep : rep + 1]
    return (torch.as_tensor(cw, dtype=dtype, device=device),
            torch.as_tensor(fw, dtype=dtype, device=device))


def _axis_windows(chart: Chart, level: int, axis: int, device,
                  dtype) -> tuple:
    """(coarse (T'_a, n_csz), fine (T'_a, n_fsz)) chart coordinates of the
    family windows along `axis`, collapsed to one representative family on
    an invariant axis (T'_a = 1): today's numpy float64 windows cast to
    `dtype`, made on `device` once and kept, so a build copies nothing from
    the host."""
    return _axis_windows_on(chart, level, axis, _device(device), dtype)


def _family_positions(chart: Chart, level: int, device, dtype):
    """Per-axis chart coords of family windows, collapsed on invariant axes.

    Returns (coarse_axes, fine_axes): coarse_axes[a] is (T'_a, n_csz)
    (T'_a == 1 if invariant), fine_axes[a] (T'_a, n_fsz), tensors on
    `device`.
    """
    pairs = [_axis_windows(chart, level, a, device, dtype)
             for a in range(chart.ndim)]
    return [c for c, _ in pairs], [f for _, f in pairs]


def _mean_diag(m: torch.Tensor) -> torch.Tensor:
    return m.diagonal(dim1=-2, dim2=-1).mean(-1)[..., None, None]


# cuSOLVER's batched eigh (torch 2.11, CUDA 12.8) rejects a batch of 65536
# 4x4 matrices with CUSOLVER_STATUS_INVALID_VALUE on an H100, and takes
# 1000: where torch.linalg still runs on the card (families above 32
# points, float64 references) batches are split
_EIGH_CHUNK = 1024


class BuildError(RuntimeError):
    """A factorisation of a matrix build failed: a Jacobi sweep count that
    did not converge, a Cholesky info, a non-finite root."""


class BuildStatus:
    """The statuses of the decompositions of the builds inside one
    ``build_checks()`` block, on the device: per (label, what), the worst
    value seen (a running maximum, NaN sticks) and its bound. Noting writes
    in place, so a captured build updates the same tensors at every replay;
    ``check`` reads them all at once."""

    def __init__(self):
        self.entries: dict = {}

    def note(self, label: str, what: str, value: torch.Tensor,
             bound: float) -> None:
        value = value.detach().float().reshape(())
        entry = self.entries.get((label, what))
        if entry is None:
            self.entries[(label, what)] = (value.clone(), bound)
        else:
            entry[0].copy_(torch.maximum(entry[0], value))

    def failures(self) -> list:
        """``(label, what, value, bound)`` of every entry above its bound
        (NaN included); reads the device once."""
        if not self.entries:
            return []
        if _capturing():
            raise RuntimeError("a build's statuses cannot be read inside a "
                               "capture: open build_checks() around it")
        vals = list(self.entries.values())
        host = torch.stack([v.to(vals[0][0].device) for v, _ in vals]).cpu()
        return [(label, what, float(x), bound)
                for ((label, what), (_, bound)), x
                in zip(self.entries.items(), host.tolist())
                if not x <= bound]

    def check(self) -> None:
        """Raise ``BuildError`` naming every label whose status failed."""
        bad = self.failures()
        if bad:
            raise BuildError("the matrix build failed: " + "; ".join(
                f"{label}: {what} {x:.3g} (bound {bound:g})"
                for label, what, x, bound in bad))


# the active ``build_checks()`` blocks' statuses, per thread (a server may
# build matrices on a thread of its own)
_LOCAL = threading.local()


def _logs() -> list:
    if not hasattr(_LOCAL, "logs"):
        _LOCAL.logs = []
    return _LOCAL.logs


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


@contextlib.contextmanager
def build_checks():
    """Collect the statuses of every build inside the block. The outermost
    block checks them when it ends (``BuildStatus.check``; one read of the
    device), an inner one adds to it. ``core/vi._fit`` wraps a whole fit,
    so a captured learned-θ step never reads the host; ``ICR.matrices``
    wraps one build."""
    logs = _logs()
    if logs:
        yield logs[-1]
        return
    log = BuildStatus()
    logs.append(log)
    try:
        yield log
    finally:
        logs.pop()
    log.check()


def _note(label, what, value, bound) -> None:
    logs = _logs()
    if logs:
        logs[-1].note(label, what, value, bound)
        return
    if _capturing():
        raise RuntimeError(f"{label}: a matrix build inside a capture needs "
                           "build_checks() around the capture")
    log = BuildStatus()
    log.note(label, what, value, bound)
    log.check()


def _jacobi(mat: torch.Tensor) -> bool:
    """Whether the batched Jacobi (``sym_eig``) decomposes `mat`: float32,
    at most 32 points."""
    from repro_torch.kernels import sym_eig

    return mat.dtype == torch.float32 and mat.shape[-1] <= sym_eig.MAX_N


def _linalg(fn, mat, rhs, label):
    """``fn(mat[, rhs])`` of torch.linalg, which syncs with the host:
    inside a capture it raises, naming the matrices' size."""
    n = mat.shape[-1]
    name = fn.__name__.removeprefix("linalg_")
    what = (f"{label}: torch.linalg.{name} of {n}×{n} {mat.dtype} "
            "matrices (above sym_eig's 32 points, or not float32) syncs "
            "with the host")
    if _capturing():
        raise RuntimeError(f"{what} and cannot be captured")
    try:
        return fn(mat) if rhs is None else fn(mat, rhs)
    except RuntimeError as exc:
        raise RuntimeError(f"{what}: {exc}") from exc


def _eigh(mat: torch.Tensor, label: str | None = None):
    """Eigenpairs (ascending) of a batch of symmetric matrices, with no
    host sync where the card allows it: float32 matrices of at most 32
    points by the batched Jacobi (``sym_eig``), which writes its status
    for ``build_checks`` (``label`` names the matrix). Larger families and
    other dtypes take ``torch.linalg.eigh``, in chunks of ``_EIGH_CHUNK``
    matrices, which syncs: inside a capture such a family raises, naming
    its size."""
    from repro_torch.kernels import sym_eig

    n = mat.shape[-1]
    label = label or f"a {n}×{n} matrix"
    if _jacobi(mat):
        evals, evecs, status = sym_eig.sym_eig(mat)
        _note(label, "Jacobi off-diagonal norm", status.amax(),
              sym_eig.BOUND)
        return evals, evecs
    if mat.ndim == 2:
        return _linalg(torch.linalg.eigh, mat, None, label)
    flat = mat.reshape((-1,) + mat.shape[-2:])
    parts = [_linalg(torch.linalg.eigh, c, None, label)
             for c in flat.split(_EIGH_CHUNK)]
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
    def forward(ctx, mat, eps, label):
        evals, evecs = _eigh(mat, label)
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
        return g_mat, g_eps, None


def _psd_sqrt(mat: torch.Tensor, eps: torch.Tensor,
              label: str | None = None) -> torch.Tensor:
    """A square root of a (nearly) PSD matrix, with eigenvalues clipped at
    ``eps`` (shape ``(..., 1, 1)``). Any ``S`` with ``S Sᵀ = D`` will do
    (paper §3.2); eigh stays finite where Cholesky fails on the
    numerically semi-definite ``D`` of strongly correlated fine points.
    The JAX package returns ``V sqrt(Λ)``; this is the symmetric root
    ``V sqrt(Λ) Vᵀ``, which differs from it by an orthogonal factor on
    the right, invisible to the standard normal ξ it multiplies, and
    whose θ-derivative does not depend on the eigenvectors eigh picks
    (``_PsdSqrt``). ``label`` names the matrix (``_eigh``)."""
    return _PsdSqrt.apply(mat, eps, label)


class _SpdSolve(torch.autograd.Function):
    """``R = K_fc K_cc⁻¹`` for a symmetric positive definite (jittered)
    ``K_cc``, by its eigenpairs from the same decomposition as the roots
    (``_eigh``), so the solve syncs with nothing (torch.linalg.solve reads
    its LU status on the host). The right-hand sides go through the
    eigenbasis, ``R = ((K_fc V) Λ⁻¹) Vᵀ`` (forming ``V Λ⁻¹ Vᵀ`` first
    rounds its large entries), and one step of refinement with the
    residual ``K_fc − R K_cc`` in float64 follows: D = K_ff − R K_fcᵀ is a
    small difference, and this keeps its float32 error at or under an LU
    solve's (half of it on the (8, 8, 8) dust chart of the CPU tests, 3.7e-5
    of D against a float64 build). Backward, by matmuls: ``dK_fc = g
    K_cc⁻¹``, ``dK_cc = −K_cc⁻¹ K_fcᵀ g K_cc⁻¹ = −Rᵀ dK_fc``."""

    @staticmethod
    def forward(ctx, k_cc, k_fc, label):
        evals, evecs = _eigh(k_cc, label)
        r = _solve_right(k_fc, evals, evecs)
        wide = torch.float64
        res = k_fc.to(wide) - r.to(wide) @ k_cc.to(wide)
        r = (r.to(wide) + _solve_right(res, evals.to(wide), evecs.to(wide))
             ).to(r.dtype)
        ctx.save_for_backward(evals, evecs, r)
        return r

    @staticmethod
    def backward(ctx, g):
        evals, evecs, r = ctx.saved_tensors
        g_fc = _solve_right(g, evals, evecs)
        return -(r.transpose(-1, -2) @ g_fc), g_fc, None


def _solve_right(b, evals, evecs):
    """``b A⁻¹`` for ``A = V Λ Vᵀ``: ``((b V) Λ⁻¹) Vᵀ``."""
    return ((b @ evecs) / evals[..., None, :]) @ evecs.transpose(-1, -2)


def _family_points(windows) -> torch.Tensor:
    """Tensor product of per-axis family windows.

    windows[a]: (K_a, W) chart coords -> (*K, W^d, ndim): for every family
    index tuple, the window points in row-major (k_0, ..., k_{d-1}) order.
    """
    nd = len(windows)
    kk = [w.shape[0] for w in windows]
    width = windows[0].shape[1]
    cols = []
    for a in range(nd):
        shape = [1] * (2 * nd)
        shape[a], shape[nd + a] = kk[a], width
        cols.append(windows[a].reshape(shape).expand(*kk, *([width] * nd)))
    return torch.stack(cols, dim=-1).reshape(*kk, width**nd, nd)


def _conditional(k_cc, k_fc, k_ff, jitter, *, scale=None, label="a family"):
    """(R, sqrt(D)) of Eq. 7/8 for batched kernel blocks; ``scale``
    divides D (and its jitter reference) by the kernel variance. ``label``
    names the level for the build's statuses."""
    eps = jitter * _mean_diag(k_cc)
    eye = torch.eye(k_cc.shape[-1], dtype=k_cc.dtype, device=k_cc.device)
    k_cc = k_cc + eps * eye
    if _jacobi(k_cc):
        r = _SpdSolve.apply(k_cc, k_fc, f"{label} K_cc")
    else:  # torch.linalg: float64 references, families above 32 points
        r = _linalg(torch.linalg.solve, k_cc, k_fc.transpose(-1, -2),
                    f"{label} K_cc").transpose(-1, -2)
    # the difference of two near-equal matrices, taken in float64
    wide = torch.float64
    d = (k_ff.to(wide) - r.to(wide) @ k_fc.to(wide).transpose(-1, -2)
         ).to(k_ff.dtype)
    d = 0.5 * (d + d.transpose(-1, -2))
    if scale is not None:
        d, k_ff = d / scale, k_ff / scale
    return r, _psd_sqrt(d, jitter * _mean_diag(k_ff), f"{label} D")


def refinement_matrices_level(chart: Chart, kernel_fn: Callable, level: int,
                              *, jitter: float = 1e-6, device="cuda",
                              dtype=torch.float32):
    """Joint refinement matrices (R, sqrt(D)) for all families refining
    `level`, batched over the families.

    Returns R: (*kept_T, n_fsz^d, n_csz^d), sqrtD: (*kept_T, n_fsz^d,
    n_fsz^d), `dtype` on `device` (the card by default, as ``ICR``).
    """
    coarse_axes, fine_axes = _family_positions(chart, level, device, dtype)
    cpos = chart.map_to_D(_family_points(coarse_axes))
    fpos = chart.map_to_D(_family_points(fine_axes))
    return _conditional(kernel_matrix(kernel_fn, cpos),
                        kernel_matrix(kernel_fn, fpos, cpos),
                        kernel_matrix(kernel_fn, fpos), jitter,
                        label=f"refinement level {level}")


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
        cols = [wins if o == axis else torch.full_like(wins, rep_coord[o])
                for o in range(nd)]
        return chart.map_to_D(torch.stack(cols, dim=-1))

    rs, ds = [], []
    for a in range(nd):
        cw, fw = _axis_windows(chart, level, a, device, dtype)
        cpos, fpos = pts(cw, a), pts(fw, a)
        r, sqrt_d = _conditional(kernel_matrix(kernel_fn, cpos),
                                 kernel_matrix(kernel_fn, fpos, cpos),
                                 kernel_matrix(kernel_fn, fpos), jitter,
                                 scale=k0 if a > 0 else None,
                                 label=f"refinement level {level} axis {a}")
        if chart.invariant[a]:
            r, sqrt_d = r[0], sqrt_d[0]
        rs.append(r)
        ds.append(sqrt_d)
    return rs, ds


def level0_sqrt(chart: Chart, kernel_fn: Callable, *, jitter: float = 1e-6,
                device="cuda", dtype=torch.float32) -> torch.Tensor:
    """A square root of the level-0 kernel matrix (small by design): a
    lower Cholesky factor, built and factored in float64 and cast to
    `dtype`. With ``eps = jitter · mean diag``, it factors K itself where
    every eigenvalue of K exceeds eps (``K − eps·I`` factors), so that
    ``S Sᵀ = K`` as the JAX package's ``V sqrt(max(Λ, eps))`` gives; else
    ``K + eps·I``, which bounds the factor's inverse as the clip does.

    The JAX package takes its root from ``eigh``. On the card neither
    torch.linalg.eigh nor cuSOLVER's syevd can be captured in a CUDA graph
    (PERF.md, the level-0 probe), and a learned-θ step rebuilds this
    root; ``cholesky_ex(check_errors=False)`` syncs with nothing, the
    choice between the two is made on the device, and the info stays there
    (read by ``build_checks``). Any ``S`` with ``S Sᵀ = K`` serves the
    standard normal ξ it multiplies (paper §3.2). K is built in float64:
    the float32 K of strongly correlated level-0 points (the 1,024-point
    regular chart at ρ = 0.06 of its extent) has eigenvalues below
    ``-eps``, where no jitter of that size makes it positive definite. One
    root form on every path, fixed θ included."""
    pos = chart.grid_positions(0, device=device, dtype=torch.float64)
    k = kernel_matrix(kernel_fn, pos)
    k = 0.5 * (k + k.T)
    eps = jitter * _mean_diag(k)
    eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
    with torch.no_grad():
        _, clipped = torch.linalg.cholesky_ex(k - eps * eye,
                                              check_errors=False)
    shift = torch.where(clipped == 0, 0.0, eps.detach()[0, 0])
    root, info = torch.linalg.cholesky_ex(k + shift * eye,
                                          check_errors=False)
    _note("the level-0 root", "Cholesky info + non-finite pivots",
          info.abs() + (~torch.isfinite(root.diagonal())).sum(), 0.0)
    return root.to(dtype)


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
