"""Plain PyTorch oracles of the refinement kernels.

The ground truth every kernel is held against, on the CPU in the tests and
on the card in ``chip_smoke.py``. They follow the kernels' calling
conventions:

* 1-D refinement over the last axis, with any leading batch dims (samples,
  or chart-invariant axes folded into the batch, paper §4.3).
* The coarse input is already halo-padded: family ``t`` reads
  ``coarse[..., t*s : t*s + n_csz]`` with ``s = n_fsz//2``.

Accumulation follows the kernels: storage narrower than float32 is
upcast, the math runs in float32 (float64 stays float64), and the result
is rounded to the storage dtype once.
"""
from __future__ import annotations

import torch


def accum_dtype_for(*arrs) -> torch.dtype:
    """float32 for sub-f32 storage (bf16/f16), else the storage dtype."""
    dt = arrs[0].dtype
    for a in arrs[1:]:
        if a is not None:
            dt = torch.promote_types(dt, a.dtype)
    return torch.float32 if dt.itemsize < 4 else dt


def coarse_len(t: int, n_csz: int, n_fsz: int) -> int:
    """Halo-padded coarse length the JAX kernels' layout uses for T
    families (the port's kernels need only ``(t-1)*s + n_csz``)."""
    s = n_fsz // 2
    return t * s + (n_csz - s)


def windows_1d(coarse: torch.Tensor, t: int, n_csz: int,
               s: int) -> torch.Tensor:
    """(..., T, n_csz) family windows of a (..., L) coarse array:
    window t is ``coarse[..., t*s : t*s + n_csz]``."""
    return coarse[..., : (t - 1) * s + n_csz].unfold(-1, n_csz, s)


def refine_stationary_ref(coarse, xi, r, sqrt_d=None):
    """Stationary refinement (paper Eq. 11–12), one shared stencil.

    coarse: (..., L) halo-padded; xi: (..., T, n_fsz) or None (noise-free,
    T then recovered from L); r: (n_fsz, n_csz); sqrt_d: (n_fsz, n_fsz)
    -> fine (..., T * n_fsz)
    """
    n_fsz, n_csz = r.shape
    s = n_fsz // 2
    t = xi.shape[-2] if xi is not None else (coarse.shape[-1] - n_csz) // s + 1
    acc = accum_dtype_for(coarse, xi, r)
    w = windows_1d(coarse.to(acc), t, n_csz, s)
    fine = torch.einsum("...tc,fc->...tf", w, r.to(acc))
    if xi is not None:
        fine = fine + torch.einsum("...tj,fj->...tf", xi.to(acc),
                                   sqrt_d.to(acc))
    return fine.reshape(*fine.shape[:-2], t * n_fsz).to(coarse.dtype)


def refine_charted_ref(coarse, xi, r, sqrt_d=None):
    """Charted (non-stationary) refinement, per-family matrices (§4.3).

    coarse: (..., L) halo-padded; xi: (..., T, n_fsz) or None;
    r: (T, n_fsz, n_csz); sqrt_d: (T, n_fsz, n_fsz) -> fine (..., T*n_fsz)
    """
    t, n_fsz, n_csz = r.shape
    s = n_fsz // 2
    acc = accum_dtype_for(coarse, xi, r)
    w = windows_1d(coarse.to(acc), t, n_csz, s)
    fine = torch.einsum("...tc,tfc->...tf", w, r.to(acc))
    if xi is not None:
        fine = fine + torch.einsum("...tj,tfj->...tf", xi.to(acc),
                                   sqrt_d.to(acc))
    return fine.reshape(*fine.shape[:-2], t * n_fsz).to(coarse.dtype)


def _refine_nn_ref(coarse, r, t: int, eq: str):
    n_fsz, n_csz = r.shape[-2:]
    acc = accum_dtype_for(coarse, r)
    w = windows_1d(coarse.to(acc), t, n_csz, n_fsz // 2)
    fine = torch.einsum(eq, w, r.to(acc))
    return fine.reshape(*fine.shape[:-2], t * n_fsz).to(coarse.dtype)


def refine_stationary_nn_ref(coarse, r, t: int):
    """Noise-free stationary refinement over ``t`` families: the window
    contraction of ``refine_stationary_ref`` without ξ or sqrtD.

    coarse: (..., L), L >= (t-1)*s + n_csz; r: (n_fsz, n_csz)
    -> fine (..., t * n_fsz)
    """
    return _refine_nn_ref(coarse, r, t, "...tc,fc->...tf")


def refine_charted_nn_ref(coarse, r):
    """Noise-free charted refinement, per-family stencils r: (T, n_fsz,
    n_csz); coarse: (..., L) -> fine (..., T * n_fsz)."""
    return _refine_nn_ref(coarse, r, r.shape[0], "...tc,tfc->...tf")


# -- adjoints (the plain versions of the adjoint kernels) -----------------------
def overlap_add_1d(dw: torch.Tensor, coarse_len: int, s: int) -> torch.Tensor:
    """Adjoint of ``windows_1d``: add the overlapping window cotangents back
    onto the coarse grid, ``dcoarse[..., t*s + k] += dw[..., t, k]``.
    dw: (..., T, n_csz) -> (..., coarse_len); entries no window covers are
    zero."""
    t, n_csz = dw.shape[-2], dw.shape[-1]
    dc = torch.zeros(dw.shape[:-2] + (coarse_len,), dtype=dw.dtype,
                     device=dw.device)
    for k in range(n_csz):
        dc[..., k : k + s * (t - 1) + 1 : s] += dw[..., k]
    return dc


def matrix_cotangents_1d(coarse, xi, r, g, *, charted: bool,
                        need_r: bool = True, need_d: bool = True):
    """Cotangents of a 1-D level's matrices: ``dr = Σ g ⊗ windows`` and
    ``dd = Σ g ⊗ ξ`` over samples (and, for a shared stencil, families),
    in float32 for narrower storage, rounded to r's dtype once. Either is
    None when not asked for; at fixed matrices the window tensor is never
    built."""
    n_fsz, n_csz = r.shape[-2:]
    t = g.shape[-1] // n_fsz
    acc = accum_dtype_for(g, r)
    g3 = g.to(acc).reshape(g.shape[:-1] + (t, n_fsz))
    mat = "tf" if charted else "f"
    dr = dd = None
    if need_r:
        w = windows_1d(coarse.to(acc), t, n_csz, n_fsz // 2)
        dr = torch.einsum(f"...tf,...tc->{mat}c", g3, w).to(r.dtype)
    if need_d:
        dd = torch.einsum(f"...tf,...tj->{mat}j", g3, xi.to(acc)).to(r.dtype)
    return dr, dd


def _vjp_1d(coarse, xi, r, sqrt_d, g, coarse_len, *, charted: bool):
    n_fsz = r.shape[-2]
    t = g.shape[-1] // n_fsz
    coarse_len = coarse.shape[-1] if coarse_len is None else coarse_len
    acc = accum_dtype_for(g, r)
    g3 = g.to(acc).reshape(g.shape[:-1] + (t, n_fsz))
    mat = "tf" if charted else "f"
    dw = torch.einsum(f"...tf,{mat}c->...tc", g3, r.to(acc))
    dcoarse = overlap_add_1d(dw, coarse_len, n_fsz // 2).to(g.dtype)
    dxi = None
    if sqrt_d is not None:
        dxi = torch.einsum(f"...tf,{mat}j->...tj", g3,
                           sqrt_d.to(acc)).to(g.dtype)
    dr, dd = matrix_cotangents_1d(
        coarse, xi, r, g, charted=charted, need_r=coarse is not None,
        need_d=xi is not None and sqrt_d is not None)
    return dcoarse, dxi, dr, dd


def refine_stationary_vjp_ref(coarse, xi, r, sqrt_d, g, *,
                              coarse_len: int | None = None):
    """VJP of ``refine_stationary_ref``: the plain version of the
    stationary adjoint kernels.

    g: (..., T*n_fsz) cotangent of fine -> (dcoarse (..., coarse_len),
    dxi (..., T, n_fsz), dr (n_fsz, n_csz), dd (n_fsz, n_fsz)). ``coarse``
    and ``xi`` are needed only for dr and dd: pass None (and
    ``coarse_len``) for the kernel's outputs alone, and dr/dd come back
    None. ``sqrt_d=None`` is the noise-free variant: dxi and dd are None.
    The sums run in float32 for narrower storage and are rounded once.
    """
    return _vjp_1d(coarse, xi, r, sqrt_d, g, coarse_len, charted=False)


def refine_charted_vjp_ref(coarse, xi, r, sqrt_d, g, *,
                           coarse_len: int | None = None):
    """VJP of ``refine_charted_ref`` (per-family matrices r: (T, n_fsz,
    n_csz), sqrt_d: (T, n_fsz, n_fsz)); conventions as
    ``refine_stationary_vjp_ref``."""
    return _vjp_1d(coarse, xi, r, sqrt_d, g, coarse_len, charted=True)


def refine_axes_ref(field, xi, rs, ds, *, T, n_fsz: int,
                    boundary: str = "shrink", b: int = 1):
    """Separable N-D refinement oracle: per-axis 1-D passes.

    Applies ``fine = (R_0 ⊗ … ⊗ R_{d-1}) windows(coarse)
    + (D_0 ⊗ … ⊗ D_{d-1}) xi`` as 1-D passes over axes d-1..0, the other
    axes folded into the batch. Only the axis-0 pass injects ξ; the noise
    factors of the other axes are contracted into it first. Each pass
    rounds to the storage dtype.

    field: (*coarse_shape); xi: (prod(T), n_fsz^d); rs[a]: (n_fsz, n_csz)
    shared or (T_a, n_fsz, n_csz) per family; ds[a] likewise.
    -> fine (T_0*n_fsz, ..., T_{d-1}*n_fsz)
    """
    nd = field.ndim
    T = tuple(T)
    fsz = n_fsz
    acc = accum_dtype_for(field, xi)
    xi_nd = xi.reshape(T + (fsz,) * nd).to(acc)
    for a in range(1, nd):
        x2 = torch.movedim(xi_nd, (a, nd + a), (-2, -1))
        eq = "...tj,fj->...tf" if ds[a].ndim == 2 else "...tj,tfj->...tf"
        x2 = torch.einsum(eq, x2, ds[a].to(acc))
        xi_nd = torch.movedim(x2, (-2, -1), (a, nd + a))
    perm = []
    for a in range(1, nd):
        perm += [a, nd + a]
    perm += [0, nd]
    xi0 = xi_nd.permute(perm).reshape(-1, T[0], fsz).to(field.dtype)

    out = field
    for a in range(nd - 1, -1, -1):
        arr = torch.movedim(out, a, -1)
        bshape = arr.shape[:-1]
        coarse = arr.reshape(-1, arr.shape[-1])
        if boundary == "reflect":
            coarse = torch.nn.functional.pad(coarse[None], (b, b),
                                             mode="reflect")[0]
        xi_a = (xi0 if a == 0 else
                torch.zeros((coarse.shape[0], T[a], fsz), dtype=coarse.dtype,
                            device=coarse.device))
        fn = refine_stationary_ref if rs[a].ndim == 2 else refine_charted_ref
        res = fn(coarse, xi_a, rs[a], ds[a])
        out = torch.movedim(res.reshape(bshape + (T[a] * fsz,)), -1, a)
    return out
