"""Route each refinement level to its kernel.

The route of a level follows from its geometry alone:

  1-D, all ``kept_T == 1``        -> ``stationary-1d`` (one shared stencil)
  1-D, per-family matrices        -> ``charted-1d``
  N-D with the per-axis factors   -> ``nd-fused`` (one launch per level)

The Hopper N-D kernel tiles the families on every axis, so every 2-D and
3-D level that carries per-axis factors fits it; the JAX package's
``nd-axes`` fallback and its VMEM autotuners are not needed on this card.
An N-D level without per-axis factors has no kernel route: it runs on the
plain path (``ICR(use_pallas=False)``).

CUDA tensors launch the kernels; CPU tensors take each kernel's plain
version. There is no override.

Every route is differentiable in the field and ξ: the backward of a 1-D
level is its adjoint kernel (with the noise transpose), that of an N-D
level the 1-D adjoints in reverse axis order (axis 0 with noise, the
trailing axes without). ``refine_T`` runs the same adjoints directly: the
transpose of ``refine`` without a forward pass.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.refine import LevelGeom, reflect_pad, reflect_pad_T

from . import nd_fused
from .icr_refine import (
    refine_charted,
    refine_charted_adjoint,
    refine_charted_plain,
    refine_stationary,
    refine_stationary_adjoint,
    refine_stationary_plain,
)
from .policy import resolve as resolve_policy

ROUTE_STATIONARY_1D = "stationary-1d"
ROUTE_CHARTED_1D = "charted-1d"
ROUTE_ND_FUSED = "nd-fused"

# the wrapper (and launch counter) behind each route
KERNEL_OF_ROUTE = {
    ROUTE_STATIONARY_1D: "refine_stationary",
    ROUTE_CHARTED_1D: "refine_charted",
    ROUTE_ND_FUSED: "refine_nd_fused",
}


def route_for(geom: LevelGeom, *, have_axis_mats: bool = False) -> str:
    """The kernel route of a level (see the module docstring)."""
    nd = len(geom.coarse_shape)
    if nd == 1:
        if all(k == 1 for k in geom.kept_T):
            return ROUTE_STATIONARY_1D
        return ROUTE_CHARTED_1D
    if not have_axis_mats:
        raise ValueError("an N-D level needs the per-axis factors for the "
                         "kernel route (ICR.matrices(axes=True))")
    if nd > 3:
        raise ValueError(f"no kernel route for {nd}-D levels")
    return ROUTE_ND_FUSED


def _adjoint_name(charted: bool, noise: bool) -> str:
    return (("refine_charted_adjoint" if charted
             else "refine_stationary_adjoint") + ("" if noise else "_nn"))


def plan(chart) -> list:
    """Per-level route, kernel and launch count of a forward apply on the
    kernel route, where N-D charts carry their per-axis factors, and under
    ``"vjp"`` the adjoint kernels its backward launches (introspection; no
    tensors are touched)."""
    out = []
    for lvl in range(chart.n_levels):
        geom = LevelGeom.for_level(chart, lvl)
        route = route_for(geom, have_axis_mats=chart.ndim > 1)
        if route == ROUTE_ND_FUSED:
            vjp = [_adjoint_name(not chart.invariant[a], a == 0)
                   for a in range(chart.ndim)]
        else:
            vjp = [_adjoint_name(route == ROUTE_CHARTED_1D, True)]
        out.append({"level": lvl, "route": route,
                    "kernel": KERNEL_OF_ROUTE[route], "launches": 1,
                    "vjp": [{"kernel": k, "launches": 1} for k in vjp]})
    return out


def level_operands(field, xi, r, d, geom: LevelGeom, *, axis_mats=None,
                   sample_axis: bool = False) -> tuple:
    """The route of one level and its kernel's operands after the torch
    glue (reflect padding, ξ layout): ``(route, args)``, with
    ``KERNELS[route](*args)`` the kernel and ``PLAIN[route](*args)`` its
    plain version."""
    route = route_for(geom, have_axis_mats=axis_mats is not None)
    if route == ROUTE_ND_FUSED:
        return route, nd_fused.nd_operands(field, xi, axis_mats[0],
                                           axis_mats[1], geom,
                                           sample_axis=sample_axis)
    n_fsz, t = geom.n_fsz, geom.T[0]
    n_s = field.shape[0] if sample_axis else 1
    coarse = field.reshape(n_s, -1)
    if geom.boundary == "reflect":
        coarse = reflect_pad(coarse, geom.b, 1)
    lead = (t,) if route == ROUTE_CHARTED_1D else ()
    return route, (coarse.contiguous(),
                   xi.reshape(n_s, t, n_fsz).contiguous(),
                   r.reshape(lead + (n_fsz, geom.n_csz)).contiguous(),
                   d.reshape(lead + (n_fsz, n_fsz)).contiguous())


KERNELS = {
    ROUTE_STATIONARY_1D: refine_stationary,
    ROUTE_CHARTED_1D: refine_charted,
    ROUTE_ND_FUSED: nd_fused.refine_nd_fused_core,
}
PLAIN = {
    ROUTE_STATIONARY_1D: refine_stationary_plain,
    ROUTE_CHARTED_1D: refine_charted_plain,
    ROUTE_ND_FUSED: nd_fused.refine_nd_fused_plain,
}


def refine(field, xi, r, d, geom: LevelGeom, *, axis_mats=None,
           sample_axis: bool = False, policy=None) -> torch.Tensor:
    """One refinement level on its kernel route.

    Arguments follow ``core.refine.refine_level``. ``axis_mats = (rs, ds)``
    carries the per-axis factors of an N-D level (the joint ``r``/``d``
    are then unused). ``sample_axis=True`` marks a leading sample dim of
    ``field`` and ``xi``. ``policy``, when given, casts every operand to
    its storage dtype first; the kernels accumulate in float32.
    """
    if policy is not None:
        field, xi, r, d, axis_mats = resolve_policy(policy).cast_storage(
            (field, xi, r, d, axis_mats))
    route, args = level_operands(field, xi, r, d, geom, axis_mats=axis_mats,
                                 sample_axis=sample_axis)
    out = KERNELS[route](*args)
    return out.reshape(((field.shape[0],) if sample_axis else ())
                       + tuple(geom.fine_shape))


def _padded_len(n: int, geom: LevelGeom) -> int:
    return n + 2 * geom.b if geom.boundary == "reflect" else n


def refine_T(g, r, d, geom: LevelGeom, *, axis_mats=None,
             policy=None) -> tuple:
    """Transpose of ``refine`` (with ``sample_axis=True``) in (field, ξ) at
    fixed matrices, by the adjoint kernels alone.

    g: (S, *fine_shape) -> (dfield (S, *coarse_shape), dxi (S, prod T,
    n_fsz^d)). ``policy`` casts every operand to its storage dtype first.
    """
    if policy is not None:
        g, r, d, axis_mats = resolve_policy(policy).cast_storage(
            (g, r, d, axis_mats))
    route = route_for(geom, have_axis_mats=axis_mats is not None)
    n_s, n_fsz, t = g.shape[0], geom.n_fsz, geom.T
    padded = tuple(_padded_len(n, geom) for n in geom.coarse_shape)
    if route == ROUTE_ND_FUSED:
        rs, ds = axis_mats
        prod_f = math.prod(ta * n_fsz for ta in t[1:])
        dfield, dxi0 = nd_fused.refine_nd_fused_adjoint(
            g.reshape(n_s, t[0] * n_fsz, prod_f).contiguous(),
            rs[0].contiguous(), ds[0].contiguous(),
            tuple(m.contiguous() for m in rs[1:]), t, (n_s,) + padded)
        return nd_fused.nd_operands_T(dfield, dxi0, ds, geom)
    lead = (t[0],) if route == ROUTE_CHARTED_1D else ()
    adjoint = (refine_charted_adjoint if route == ROUTE_CHARTED_1D
               else refine_stationary_adjoint)
    dc, dxi = adjoint(g.reshape(n_s, -1).contiguous(),
                      r.reshape(lead + (n_fsz, geom.n_csz)).contiguous(),
                      d.reshape(lead + (n_fsz, n_fsz)).contiguous(),
                      coarse_len=padded[0])
    if geom.boundary == "reflect":
        dc = reflect_pad_T(dc, geom.b, 1)
    return dc, dxi
