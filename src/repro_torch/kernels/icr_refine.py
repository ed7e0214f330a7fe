"""The 1-D refinement kernels (paper Eq. 11–12, §4.3), forward and adjoint.

One 1-D level reads the coarse field once, builds overlapping
``n_csz``-windows, contracts them with the stencil(s) and adds the
correlated correction ``sqrt(D) ξ``:

    fine[b, t*n_fsz + f] = Σ_k R[f, k] coarse[b, t*s + k]
                         + Σ_j sqrtD[f, j] ξ[b, t, j],     s = n_fsz // 2

* ``refine_stationary`` — one stencil shared by every family (regular
  axes); replaces the JAX package's ``_stationary_kernel``.
* ``refine_charted`` — per-family matrices ``R[t]``, ``sqrtD[t]``
  (charted axes); replaces ``_charted_kernel``.
* ``refine_stationary_nn`` / ``refine_charted_nn`` — the same without ξ
  or sqrtD, for the non-final passes of the nd-axes route (``nd.py``);
  replace ``_stationary_nn_kernel`` and ``_charted_nn_kernel``.
* ``refine_stationary_adjoint`` / ``refine_charted_adjoint`` — the
  transpose in (coarse, ξ): the overlap-add ``dcoarse`` of ``g·R`` and
  ``dξ = g·sqrtD``, or ``dcoarse`` alone when no ``sqrtD`` is given;
  replace the four ``_*_adjoint[_nn]_kernel``s.

The forward launches ``csrc/refine_1d.cu`` and the adjoint
``csrc/refine_1d_adjoint.cu`` on CUDA tensors; on CPU tensors each runs
its plain version, the oracles of ``ref.py``. A CUDA tensor never reaches
the plain version: the kernel launches or the wrapper raises. Every kernel
streams, one run of families per thread (``stream_shape_1d`` for the
stationary ones; ``charted_shape_1d`` for the charted ones, whose threads
also take several rows).

The forward wrappers are differentiable: where an operand requires grad
they run inside a ``torch.autograd.Function`` whose backward is the
adjoint kernel, plus the matrix cotangents (torch einsums) only for the
matrices that require grad.
"""
from __future__ import annotations

import torch

from . import build
from .ref import matrix_cotangents_1d
from .ref import refine_charted_nn_ref as refine_charted_nn_plain
from .ref import refine_charted_ref as refine_charted_plain
from .ref import refine_charted_vjp_ref, refine_stationary_vjp_ref
from .ref import refine_stationary_nn_ref as refine_stationary_nn_plain
from .ref import refine_stationary_ref as refine_stationary_plain

__all__ = ["refine_stationary", "refine_charted", "refine_stationary_plain",
           "refine_charted_plain", "refine_stationary_nn", "refine_charted_nn",
           "refine_stationary_nn_plain", "refine_charted_nn_plain",
           "refine_stationary_adjoint",
           "refine_charted_adjoint", "refine_stationary_adjoint_plain",
           "refine_charted_adjoint_plain", "stream_shape_1d",
           "charted_shape_1d"]

# threads per block of the streaming kernels (kThreads in csrc/common.cuh)
THREADS = 256
# families per thread of the streaming stationary kernels, forward and
# adjoint, by (n_fsz, n_csz, storage itemsize): their compile-time
# instances. Any other stencil runs the runtime-size instance, one family
# per thread.
STREAM_FAMILIES = {
    "forward": {(2, 3, 4): 4, (2, 3, 2): 8, (4, 5, 4): 2, (4, 5, 2): 2},
    "adjoint": {(2, 3, 4): 2, (2, 3, 2): 4, (4, 5, 4): 2, (4, 5, 2): 2},
}
# runs of one streaming launch: the kernels index them in 32 bits
_MAX_RUNS = 2**31 - THREADS


def stream_shape_1d(batch: int, t: int, n_fsz: int, n_csz: int,
                    itemsize: int, *, adjoint: bool = False) -> tuple:
    """(families per run, runs per row, blocks) of the streaming stationary
    kernels: a thread owns one run of consecutive families of one row (the
    adjoint's last run of a row also the tail of dcoarse), and the runs of
    all rows are numbered one after another over blocks of ``THREADS``."""
    table = STREAM_FAMILIES["adjoint" if adjoint else "forward"]
    nf = table.get((n_fsz, n_csz, itemsize), 1)
    runs = -(-t // nf)
    if batch * runs > _MAX_RUNS:
        raise ValueError(f"{batch} rows of {runs} runs exceed one launch")
    return nf, runs, -(-batch * runs // THREADS)


# families per thread of the streaming charted kernels, forward and
# adjoint, by (n_fsz, n_csz, storage itemsize): their compile-time
# instances (charted_families in csrc/common.cuh); any other stencil runs
# the runtime-size instance, one family of one row per thread
CHARTED_FAMILIES = {(2, 3, 4): 2, (2, 3, 2): 2, (4, 5, 4): 1,
                    (4, 5, 2): 1}
# threads the charted kernels aim for (4 blocks of 256 on each of the
# H100's 132 SMs), and the rows one thread takes at most
CHARTED_THREADS = 132 * 4 * THREADS
CHARTED_MAX_ROWS = 8


def charted_shape_1d(batch: int, t: int, n_fsz: int, n_csz: int,
                     itemsize: int) -> tuple:
    """(families per run, rows per thread, runs per row, blocks) of the
    streaming charted kernels, forward and adjoint, and of the pyramid's
    charted levels: thread i owns run ``i % runs`` (of the adjoint, the
    last run of a row also dcoarse's tail) of the rows ``[(i // runs)·SB,
    +SB)``, holding its families' stencils for all of them. A thread takes
    as many rows (up to ``CHARTED_MAX_ROWS``) as leave ``CHARTED_THREADS``
    threads, so long rows read each stencil once or twice and short rows
    pack several to a block."""
    key = (n_fsz, n_csz, itemsize)
    nf = CHARTED_FAMILIES.get(key, 1)
    runs = -(-t // nf)
    rows = 1
    if key in CHARTED_FAMILIES:
        rows = max(1, min(batch, CHARTED_MAX_ROWS,
                          batch * runs // CHARTED_THREADS))
        rows = -(-batch // -(-batch // rows))   # even out the chunks
    threads = -(-batch // rows) * runs
    if threads > _MAX_RUNS:
        raise ValueError(f"{batch} rows of {runs} runs exceed one launch")
    return nf, rows, runs, -(-threads // THREADS)


def refine_stationary_adjoint_plain(g, r, d=None, *, coarse_len: int):
    """Plain version of ``refine_stationary_adjoint``, on any device."""
    dc, dxi, _, _ = refine_stationary_vjp_ref(None, None, r, d, g,
                                              coarse_len=coarse_len)
    return (dc, dxi) if d is not None else dc


def refine_charted_adjoint_plain(g, r, d=None, *, coarse_len: int):
    """Plain version of ``refine_charted_adjoint``, on any device."""
    dc, dxi, _, _ = refine_charted_vjp_ref(None, None, r, d, g,
                                           coarse_len=coarse_len)
    return (dc, dxi) if d is not None else dc


def _check_1d(name, batch, t, n_fsz, n_csz, length, *, mat_lead, r, d):
    if (r.shape != mat_lead + (n_fsz, n_csz)
            or (d is not None and d.shape != mat_lead + (n_fsz, n_fsz))):
        raise ValueError(
            f"{name}: r {tuple(r.shape)} / d "
            f"{None if d is None else tuple(d.shape)} do not fit {t} "
            f"families of ({n_fsz}, {n_csz})")
    if length < (t - 1) * (n_fsz // 2) + n_csz:
        raise ValueError(f"{name}: coarse length {length} too short for "
                         f"{t} families of ({n_fsz}, {n_csz})")
    if max(t * n_fsz, length, r.numel()) >= 2**31:
        raise ValueError(f"{name}: level too large for 32-bit indices")


def _refine_1d(coarse, xi, r, d, *, charted: bool, t: int | None = None):
    """The forward kernel; ``xi=None`` (with ``d=None`` and the family count
    ``t``) is the noise-free variant."""
    noise = xi is not None
    if coarse.device.type == "cpu":
        if noise:
            plain = refine_charted_plain if charted else refine_stationary_plain
            return plain(coarse, xi, r, d)
        return (refine_charted_nn_plain(coarse, r) if charted
                else refine_stationary_nn_plain(coarse, r, t))
    build.check_operands(coarse=coarse, xi=xi, r=r, d=d)
    batch, length = coarse.shape
    n_fsz, n_csz = r.shape[-2:]
    if noise:
        t = xi.shape[1]
        if tuple(xi.shape) != (batch, t, n_fsz):
            raise ValueError(f"xi {tuple(xi.shape)} does not match coarse "
                             f"{tuple(coarse.shape)}")
    elif charted:
        t = r.shape[0]
    _check_1d("refine_1d", batch, t, n_fsz, n_csz, length,
              mat_lead=(t,) if charted else (), r=r, d=d)
    if charted:
        fn = "refine_1d_charted_fwd"
        shape = charted_shape_1d(batch, t, n_fsz, n_csz,
                                 coarse.element_size())[:3]
    else:
        fn = "refine_1d_stationary_fwd"
        shape = stream_shape_1d(batch, t, n_fsz, n_csz,
                                coarse.element_size())[:2]
    out = torch.empty((batch, t * n_fsz), dtype=coarse.dtype,
                      device=coarse.device)
    build.launch("refine_1d", fn, coarse.device,
                 build.dtype_code(coarse.dtype), int(noise),
                 coarse.data_ptr(), xi.data_ptr() if noise else None,
                 r.data_ptr(), d.data_ptr() if noise else None,
                 out.data_ptr(), batch, length, t, n_csz, n_fsz, *shape)
    build.LAUNCHES[("refine_charted" if charted else "refine_stationary")
                   + ("" if noise else "_nn")] += 1
    return out


def _adjoint_1d(g, r, d, coarse_len: int, *, charted: bool):
    noise = d is not None
    if g.device.type == "cpu":
        plain = (refine_charted_adjoint_plain if charted
                 else refine_stationary_adjoint_plain)
        return plain(g, r, d, coarse_len=coarse_len)
    build.check_operands(g=g, r=r, d=d)
    n_fsz, n_csz = r.shape[-2:]
    batch, width = g.shape
    t = width // n_fsz
    if t * n_fsz != width:
        raise ValueError(f"g width {width} is not a multiple of n_fsz "
                         f"{n_fsz}")
    _check_1d("refine_1d_adjoint", batch, t, n_fsz, n_csz, coarse_len,
              mat_lead=(t,) if charted else (), r=r, d=d)
    if charted:
        fn = "refine_1d_charted_adj"
        shape = charted_shape_1d(batch, t, n_fsz, n_csz,
                                 g.element_size())[:3]
    else:
        fn = "refine_1d_stationary_adj"
        shape = stream_shape_1d(batch, t, n_fsz, n_csz, g.element_size(),
                                adjoint=True)[:2]
    dc = torch.empty((batch, coarse_len), dtype=g.dtype, device=g.device)
    dxi = (torch.empty((batch, t, n_fsz), dtype=g.dtype, device=g.device)
           if noise else None)
    build.launch("refine_1d_adjoint", fn, g.device,
                 build.dtype_code(g.dtype), int(noise), g.data_ptr(),
                 r.data_ptr(), d.data_ptr() if noise else None,
                 dc.data_ptr(), dxi.data_ptr() if noise else None, batch,
                 coarse_len, t, n_csz, n_fsz, *shape)
    name = ("refine_charted_adjoint" if charted
            else "refine_stationary_adjoint") + ("" if noise else "_nn")
    build.LAUNCHES[name] += 1
    return (dc, dxi) if noise else dc


class _Refine1D(torch.autograd.Function):
    """A 1-D forward level whose backward is the adjoint kernel; without ξ
    (``xi=d=None``) the noise-free level, whose backward is the ``_nn``
    adjoint kernel."""

    @staticmethod
    def forward(ctx, coarse, xi, r, d, charted, t):
        ctx.charted, ctx.coarse_len = charted, coarse.shape[-1]
        mats = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        ctx.save_for_backward(r, d, *((coarse, xi) if mats else ()))
        return _refine_1d(coarse, xi, r, d, charted=charted, t=t)

    @staticmethod
    def backward(ctx, g):
        r, d, *saved = ctx.saved_tensors
        need_c, need_x, need_r, need_d = ctx.needs_input_grad[:4]
        g = g.contiguous()
        dc = dxi = dr = dd = None
        if need_c or need_x:
            out = _adjoint_1d(g, r, d if need_x else None, ctx.coarse_len,
                              charted=ctx.charted)
            dc, dxi = out if need_x else (out, None)
        if need_r or need_d:
            coarse, xi = saved
            dr, dd = matrix_cotangents_1d(coarse, xi, r, g,
                                          charted=ctx.charted, need_r=need_r,
                                          need_d=need_d)
        return dc if need_c else None, dxi, dr, dd, None, None


def _refine_1d_autograd(coarse, xi, r, d, *, charted: bool, t=None):
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in (coarse, xi, r, d)):
        return _Refine1D.apply(coarse, xi, r, d, charted, t)
    return _refine_1d(coarse, xi, r, d, charted=charted, t=t)


def refine_stationary(coarse, xi, r, d) -> torch.Tensor:
    """Stationary 1-D refinement, one shared stencil.

    coarse: (B, L) halo-padded, L >= (T-1)*s + n_csz; xi: (B, T, n_fsz);
    r: (n_fsz, n_csz); d: (n_fsz, n_fsz) -> fine (B, T*n_fsz), in the
    storage dtype of the operands with f32 accumulation. Differentiable in
    every operand.
    """
    return _refine_1d_autograd(coarse, xi, r, d, charted=False)


def refine_charted(coarse, xi, r, d) -> torch.Tensor:
    """Charted 1-D refinement with per-family matrices.

    coarse: (B, L); xi: (B, T, n_fsz); r: (T, n_fsz, n_csz);
    d: (T, n_fsz, n_fsz) -> fine (B, T*n_fsz). Differentiable in every
    operand.
    """
    return _refine_1d_autograd(coarse, xi, r, d, charted=True)


def refine_stationary_nn(coarse, r, t: int) -> torch.Tensor:
    """Noise-free stationary 1-D refinement over ``t`` families: no ξ or
    sqrtD operand, for the non-final passes of the nd-axes route.

    coarse: (B, L), L >= (t-1)*s + n_csz; r: (n_fsz, n_csz) -> fine
    (B, t*n_fsz). Differentiable in coarse and r.
    """
    return _refine_1d_autograd(coarse, None, r, None, charted=False, t=t)


def refine_charted_nn(coarse, r) -> torch.Tensor:
    """Noise-free charted 1-D refinement, r: (T, n_fsz, n_csz) per family;
    otherwise as ``refine_stationary_nn``."""
    return _refine_1d_autograd(coarse, None, r, None, charted=True)


def refine_stationary_adjoint(g, r, d=None, *, coarse_len: int):
    """Transpose of ``refine_stationary`` in (coarse, ξ) at fixed matrices.

    g: (B, T*n_fsz) cotangent of fine; r: (n_fsz, n_csz); d: (n_fsz,
    n_fsz) or None -> (dcoarse (B, coarse_len), dxi (B, T, n_fsz)), or
    dcoarse alone when d is None. dcoarse is zero where no window reaches.
    """
    return _adjoint_1d(g, r, d, coarse_len, charted=False)


def refine_charted_adjoint(g, r, d=None, *, coarse_len: int):
    """Transpose of ``refine_charted``: r (T, n_fsz, n_csz), d (T, n_fsz,
    n_fsz) or None; otherwise as ``refine_stationary_adjoint``."""
    return _adjoint_1d(g, r, d, coarse_len, charted=True)
