"""The per-axis N-D route (``nd-axes``): one 1-D kernel pass per axis.

The counterpart of the JAX package's ``src/repro/kernels/nd.py:
refine_axes``. It applies the Kronecker-factored level

    fine = (R_0 ⊗ … ⊗ R_{d-1}) windows(coarse) + (sqrtD_0 ⊗ … ⊗ sqrtD_{d-1}) ξ

as 1-D passes over axes ``d-1..0``, the other axes (and the leading sample
dim) folded into the 1-D kernels' batch. The non-final passes run the
noise-free kernels (``refine_stationary_nn`` / ``refine_charted_nn``, no
ξ operand); the axis-0 pass runs ``refine_stationary`` / ``refine_charted``
with ξ0, the excitation with the noise factors of axes ``1..d-1``
contracted in beforehand (torch glue, as in the JAX package). Each pass
rounds to the storage dtype. A reflect boundary pads each pass's rows.

Why the port has it: the JAX package takes this route when the fused
level's tile does not fit VMEM. On this card ``nd_fused.cu`` tiles every
axis, so every level fits; what the fused level lacks is a backward in
its factors. Every pass here is a differentiable 1-D ``Function``
(``icr_refine``), so autograd through ``refine_axes`` runs the adjoint
kernels in reverse axis order and yields the cotangents of the field, ξ
and every factor ``R_a``, ``sqrtD_a``: ``dispatch.refine`` routes an N-D
level here when a factor requires grad (learned θ).
"""
from __future__ import annotations

import torch

from repro_torch.core.refine import LevelGeom, reflect_pad

from .icr_refine import (
    refine_charted,
    refine_charted_nn,
    refine_stationary,
    refine_stationary_nn,
)
from .nd_fused import precontract_noise
from .ref import accum_dtype_for

__all__ = ["refine_axes", "axis_passes", "xi0_for_axes"]


def xi0_for_axes(xi, ds, T: tuple, fsz: int, *, off: int, storage):
    """ξ ``(*lead, prod T, fsz^d)`` -> the axis-0 pass's ξ0 ``(B, T_0,
    fsz)``, the trailing noise factors contracted in and the batch in the
    order of that pass's rows: ``(*lead, T_1, f_1, …, T_{d-1}, f_{d-1})``."""
    nd = len(T)
    lead = xi.shape[:off]
    xi_nd = precontract_noise(xi.reshape(lead + tuple(T) + (fsz,) * nd), ds,
                              off=off, accum=accum_dtype_for(xi, *ds))
    perm = list(range(off))
    for a in range(1, nd):
        perm += [off + a, off + nd + a]
    perm += [off, off + nd]
    return xi_nd.permute(perm).reshape(-1, T[0], fsz).to(storage)


def axis_passes(field, xi0, rs, d0, geom: LevelGeom, *, off: int):
    """The passes on a prepared ξ0 (``xi0_for_axes``): field ``(*lead,
    *coarse_shape)`` -> ``(*lead, *fine_shape)``."""
    nd = len(geom.coarse_shape)
    T, fsz = tuple(geom.T), geom.n_fsz
    out = field
    for a in range(nd - 1, -1, -1):
        arr = torch.movedim(out, off + a, -1)
        bshape = arr.shape[:-1]
        coarse = arr.reshape(-1, arr.shape[-1])
        if geom.boundary == "reflect":
            coarse = reflect_pad(coarse, geom.b, 1)
        coarse = coarse.contiguous()
        charted = rs[a].ndim == 3
        if a == 0:
            kern = refine_charted if charted else refine_stationary
            res = kern(coarse, xi0.contiguous(), rs[0].contiguous(),
                       d0.contiguous())
        elif charted:
            res = refine_charted_nn(coarse, rs[a].contiguous())
        else:
            res = refine_stationary_nn(coarse, rs[a].contiguous(), T[a])
        out = torch.movedim(res.reshape(bshape + (T[a] * fsz,)), -1, off + a)
    return out


def refine_axes(field, xi, rs, ds, geom: LevelGeom, *,
                sample_axis: bool = False) -> torch.Tensor:
    """One N-D level as per-axis 1-D kernel passes.

    field: (*coarse_shape) or (S, *coarse_shape); xi: (prod(T), n_fsz^d)
    or (S, prod(T), n_fsz^d); rs[a]: (n_fsz, n_csz) shared or (T_a, n_fsz,
    n_csz) per family, ds[a] likewise with n_fsz columns. Returns the fine
    field, (*fine_shape) or (S, *fine_shape), in the field's dtype.
    Differentiable in the field, ξ and every factor.
    """
    nd = len(geom.coarse_shape)
    if nd < 2:
        raise ValueError("refine_axes needs an N-D level (ndim >= 2)")
    off = 1 if sample_axis else 0
    xi0 = xi0_for_axes(xi, ds, tuple(geom.T), geom.n_fsz, off=off,
                       storage=field.dtype)
    return axis_passes(field, xi0, rs, ds[0], geom, off=off)
