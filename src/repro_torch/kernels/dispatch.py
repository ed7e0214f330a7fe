"""Route each refinement level to its kernel.

The route of a level follows from its geometry, and on N-D levels from
whether a per-axis factor requires grad:

  1-D, all ``kept_T == 1``        -> ``stationary-1d`` (one shared stencil)
  1-D, per-family matrices        -> ``charted-1d``
  N-D with the per-axis factors   -> ``nd-fused`` (one launch per level)
  ... of which a factor requires
      grad (learned θ)            -> ``nd-axes`` (one 1-D pass per axis)

The JAX package takes ``nd-axes`` when the fused level's tile does not
fit VMEM. The Hopper N-D kernel tiles the families on every axis, so every
2-D and 3-D level fits it and that question does not arise here. What the
fused level has no kernel for is the backward in its factors: the passes
of ``nd-axes`` (``nd.refine_axes``) are 1-D ``Function``s whose backward
gives the factors' cotangents, so a level whose factors require grad (with
grad enabled) takes that route. An N-D level without per-axis factors has
no kernel route: it runs on the plain path (``ICR(use_pallas=False)``).

On top of the per-level routes, ``ICR(use_pyramid=True)`` (the default, as
in the JAX package) runs the chart's first levels as one launch
(``pyramid.refine_pyramid``): ``pyramid_cover`` says how many (on the
H100, 1-D stationary levels only), ``pyramid_prefix`` how many the kernel
could take, and ``plan(pyramid=True)`` shows the cover as the ``pyramid``
route. ``plan()`` also gives each level's modeled device-memory bytes
(``roofline.level_traffic``); ``plan_cached`` memoizes it for serving.

CUDA tensors launch the kernels; CPU tensors take each kernel's plain
version. There is no override.

Every route is differentiable in the field and ξ: the backward of a 1-D
level is its adjoint kernel (with the noise transpose), that of an N-D
level the 1-D adjoints in reverse axis order (axis 0 with noise, the
trailing axes without); on ``nd-axes`` the passes' adjoints also give
the factors' cotangents. ``refine_T`` runs the adjoints directly: the
transpose of ``refine`` without a forward pass.
"""
from __future__ import annotations

import math
import types

import torch

from repro_torch.core.refine import LevelGeom, reflect_pad, reflect_pad_T
from repro_torch.roofline.level_traffic import (
    refine_level_traffic,
    storage_width,
)

from . import nd, nd_fused
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
ROUTE_AXES_ND = "nd-axes"
ROUTE_PYRAMID = "pyramid"

# the wrapper (and launch counter) behind each single-kernel route
KERNEL_OF_ROUTE = {
    ROUTE_STATIONARY_1D: "refine_stationary",
    ROUTE_CHARTED_1D: "refine_charted",
    ROUTE_ND_FUSED: "refine_nd_fused",
    ROUTE_PYRAMID: "refine_pyramid",
}

# What the pyramid's intermediate fields may take: half of the H100's
# 50 MB L2 (cudaDevAttrL2CacheSize reports 50 MiB), the other half left to
# the ξ, matrices and output streaming through it.
L2_BUDGET_BYTES = 25 * 2**20


def route_for(geom: LevelGeom, *, have_axis_mats: bool = False,
              learn: bool = False) -> str:
    """The kernel route of a level (see the module docstring); ``learn``
    marks N-D factors that require grad with grad enabled
    (``learns(axis_mats)``)."""
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
    return ROUTE_AXES_ND if learn else ROUTE_ND_FUSED


def learns(axis_mats) -> bool:
    """Whether a level's per-axis factors `axis_mats` (or None) are learned
    here: grad is enabled and one of them requires it."""
    return (axis_mats is not None and torch.is_grad_enabled() and any(
        m.requires_grad for m in (*axis_mats[0], *axis_mats[1])))


def _structured(geom: LevelGeom, have_axis_mats: bool) -> bool:
    nd = len(geom.coarse_shape)
    return nd == 1 or (have_axis_mats and nd <= 3)


def _stationary_1d(geom: LevelGeom) -> bool:
    return (len(geom.coarse_shape) == 1
            and route_for(geom) == ROUTE_STATIONARY_1D)


def _prefix(chart, takes, samples, itemsize, budget):
    from .pyramid import MAX_LEVELS

    k, handed = 0, 0
    for lvl in range(min(chart.n_levels, MAX_LEVELS)):
        geom = LevelGeom.for_level(chart, lvl)
        if not takes(geom):
            break
        if k:
            handed += samples * itemsize * math.prod(geom.coarse_shape)
            if handed > budget:
                break
        k += 1
    return k if k >= 2 else None


def pyramid_prefix(chart, *, samples: int = 1, itemsize: int = 4,
                   have_axis_mats: bool | None = None,
                   budget: int = L2_BUDGET_BYTES):
    """How many of `chart`'s first levels the pyramid kernel can take in
    one launch: the number ``k``, or None when fewer than two (a one-level
    pyramid is the per-level route).

    The residency rule, re-derived for the H100 (the JAX package sizes
    whole levels against a TPU core's 64 MiB VMEM; a Hopper block has 227
    KB): the longest prefix of consecutive structured levels (1-D, or N-D
    with the per-axis factors; ``have_axis_mats`` defaults to
    ``chart.ndim > 1``), at most ``pyramid.MAX_LEVELS``, in which the
    fields that one covered level hands to the next, summed at ``samples``
    samples and the storage ``itemsize``, fit ``budget`` (half of the L2). The coarse input
    and the last level's output go through device memory in any case and
    do not count. A pure function of the chart, S and the itemsize.
    """
    if have_axis_mats is None:
        have_axis_mats = chart.ndim > 1
    return _prefix(chart, lambda g: _structured(g, have_axis_mats), samples,
                   itemsize, budget)


def pyramid_cover(chart, *, samples: int = 1, itemsize: int = 4,
                  budget: int = L2_BUDGET_BYTES):
    """How many of `chart`'s first levels ``ICR(use_pyramid=True)`` runs as
    one pyramid launch: the number ``k``, or None.

    The rule: the residency rule of ``pyramid_prefix`` over 1-D stationary
    levels only. On the H100 the pyramid must beat the per-level kernels
    it replaces, summed, at the covers it takes; it does on 1-D stationary
    charts and loses or ties on N-D and charted 1-D ones, whose levels run
    slower inside the pyramid's persistent grid than as launches of their
    own (PERF.md, the pyramid's covers; ROADMAP.md records this divergence
    from the JAX package, whose pyramid covers every structured level). A
    pure function of the chart, S and the itemsize.
    """
    return _prefix(chart, _stationary_1d, samples, itemsize, budget)


def _adjoint_name(charted: bool, noise: bool) -> str:
    return (("refine_charted_adjoint" if charted
             else "refine_stationary_adjoint") + ("" if noise else "_nn"))


def plan(chart, *, pyramid: bool = False, samples: int = 1,
         dtype=None) -> list:
    """Per-level route, kernel and launch count of a forward apply on the
    kernel route, where N-D charts carry their per-axis factors, and under
    ``"vjp"`` the adjoint kernels its backward launches at fixed matrices
    (introspection; no tensors are touched).

    ``pyramid=True`` overlays the prefix that ``ICR(use_pyramid=True)``
    runs at ``samples`` samples of the storage ``dtype`` (float32 by
    default): its levels report the ``pyramid`` route
    and the ``refine_pyramid`` kernel, with the one launch of the group on
    its first level. The default shows the per-level routes underneath.

    Each entry carries the ``"dtype"`` column and ``"hbm_bytes"``: the
    ``roofline.level_traffic`` total of the selected route beside every
    route the level could take on the card (1-D: its one route; N-D:
    ``nd-fused`` and ``nd-axes``; a covered level also ``pyramid``), and
    under ``"selected"`` the one it takes."""
    itemsize, dtype_name = storage_width(dtype)
    cover = (pyramid_cover(chart, samples=samples, itemsize=itemsize)
             if pyramid else None) or 0
    out = []
    for lvl in range(chart.n_levels):
        geom = LevelGeom.for_level(chart, lvl)
        route = route_for(geom, have_axis_mats=chart.ndim > 1)
        if route == ROUTE_ND_FUSED:
            vjp = [_adjoint_name(not chart.invariant[a], a == 0)
                   for a in range(chart.ndim)]
            candidates = (ROUTE_ND_FUSED, ROUTE_AXES_ND)
        else:
            vjp = [_adjoint_name(route == ROUTE_CHARTED_1D, True)]
            candidates = (route,)
        hbm = {rt: refine_level_traffic(geom, rt, samples=samples,
                                        dtype=dtype)["total"]
               for rt in candidates}
        launches = 1
        if lvl < cover:
            route, launches = ROUTE_PYRAMID, int(lvl == 0)
            hbm[route] = refine_level_traffic(
                geom, route, samples=samples, dtype=dtype,
                first=lvl == 0, last=lvl == cover - 1)["total"]
        hbm["selected"] = hbm[route]
        out.append({"level": lvl, "route": route,
                    "kernel": KERNEL_OF_ROUTE[route], "launches": launches,
                    "dtype": dtype_name, "hbm_bytes": hbm,
                    "vjp": [{"kernel": k, "launches": 1} for k in vjp]})
    return out


# plan() walks every level's geometry and traffic model: repeat traffic
# against the same (chart, sample count, dtype, pyramid, device type,
# mesh) asks for the same answer, so the server's warm path reads it from
# here. The JAX package keys the backend; the port's backend is the
# device type.
_PLAN_CACHE: dict = {}
plan_cache_stats = {"hits": 0, "misses": 0}


def _frozen(x):
    if isinstance(x, dict):
        return types.MappingProxyType({k: _frozen(v) for k, v in x.items()})
    if isinstance(x, list):
        return tuple(_frozen(v) for v in x)
    return x


def plan_cached(chart, *, samples: int = 1, dtype=None, pyramid: bool = True,
                device="cuda", mesh_key=None) -> tuple:
    """Memoized ``plan()`` (LRU, 32 entries) behind a key of the chart,
    ``samples``, the storage dtype, ``pyramid``, the device type and the
    serving mesh's fingerprint ``mesh_key`` (a re-mesh re-plans, as in
    the JAX package: the per-slot plan is the same, never a stale entry).
    The result is shared by every caller, so it is read-only: a tuple of
    read-only mappings, equal entry for entry to ``plan()``'s."""
    key = (chart, int(samples), storage_width(dtype)[1], bool(pyramid),
           torch.device(device).type, mesh_key)
    hit = _PLAN_CACHE.pop(key, None)
    if hit is not None:
        plan_cache_stats["hits"] += 1
        _PLAN_CACHE[key] = hit  # re-insert: LRU order
        return hit
    plan_cache_stats["misses"] += 1
    out = _PLAN_CACHE[key] = _frozen(plan(chart, pyramid=pyramid,
                                          samples=samples, dtype=dtype))
    while len(_PLAN_CACHE) > 32:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    return out


def plan_cache_clear() -> None:
    _PLAN_CACHE.clear()
    plan_cache_stats.update(hits=0, misses=0)


def level_operands(field, xi, r, d, geom: LevelGeom, *, axis_mats=None,
                   sample_axis: bool = False) -> tuple:
    """The single-kernel route of one level and its kernel's operands after
    the torch glue (reflect padding, ξ layout): ``(route, args)``, with
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
    its storage dtype first; the kernels accumulate in float32. An N-D
    level whose factors require grad takes the ``nd-axes`` route.
    """
    if policy is not None:
        field, xi, r, d, axis_mats = resolve_policy(policy).cast_storage(
            (field, xi, r, d, axis_mats))
    if route_for(geom, have_axis_mats=axis_mats is not None,
                 learn=learns(axis_mats)) == ROUTE_AXES_ND:
        return nd.refine_axes(field, xi, axis_mats[0], axis_mats[1], geom,
                              sample_axis=sample_axis)
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


# -- launch plans (kernels/launch.py) -------------------------------------------
# The wrappers build a LaunchPlan per launch and launch through it; these
# exports rebuild the same records from geometry alone, for the forward and
# the fixed-matrix VJP of every level, so analysis/kernel_verify.py proves
# its properties about exactly the launches that run.
VJP_ROUTE = {ROUTE_STATIONARY_1D: "stationary-1d-adjoint",
             ROUTE_CHARTED_1D: "charted-1d-adjoint",
             ROUTE_ND_FUSED: "nd-fused-adjoint",
             ROUTE_AXES_ND: "nd-axes-adjoint",
             ROUTE_PYRAMID: "pyramid-adjoint"}


def _charted_axes(chart, geom: LevelGeom) -> tuple:
    """Which axes of a level carry per-family factors: an N-D level's
    non-invariant axes; a 1-D level on the charted route."""
    if len(geom.coarse_shape) == 1:
        return (route_for(geom) == ROUTE_CHARTED_1D,)
    return tuple(not inv for inv in chart.invariant)


def _padded_extents(geom: LevelGeom) -> tuple:
    return tuple(_padded_len(n, geom) for n in geom.coarse_shape)


def _nd_vjp_plans(geom: LevelGeom, charted: tuple, samples: int,
                  dtype) -> list:
    """The fixed-matrix backward of an N-D level
    (``nd_fused.refine_nd_fused_adjoint``): axis 0's adjoint with noise
    over the padded field, then each trailing axis's without."""
    from .icr_refine import adjoint_1d_plan

    T, fsz, csz = tuple(geom.T), geom.n_fsz, geom.n_csz
    padded = _padded_extents(geom)
    f_trail = [t * fsz for t in T[1:]]
    plans = [adjoint_1d_plan(batch=samples * math.prod(f_trail), t=T[0],
                             coarse_len=padded[0], n_fsz=fsz, n_csz=csz,
                             dtype=dtype, charted=charted[0])]
    for a in range(1, len(T)):
        batch = (samples * math.prod(padded[:a])
                 * math.prod(f_trail[a:]))
        plans.append(adjoint_1d_plan(batch=batch, t=T[a],
                                     coarse_len=padded[a], n_fsz=fsz,
                                     n_csz=csz, dtype=dtype,
                                     charted=charted[a], noise=False))
    return plans


def level_launch_plans(chart, lvl: int, route: str | None = None, *,
                       samples: int = 1, dtype=None) -> dict:
    """Every launch one level of `chart` makes on `route` (default: its
    kernel route): ``{"forward": [plans], "vjp": [plans]}``, the VJP at
    fixed matrices. The ``nd-axes`` route's forward is its per-axis passes
    (the last axis first, axis 0 with noise), its VJP their adjoints in
    reverse."""
    from .icr_refine import adjoint_1d_plan, refine_1d_plan

    dtype = storage_width(dtype)[1]
    geom = LevelGeom.for_level(chart, lvl)
    route = route or route_for(geom, have_axis_mats=chart.ndim > 1)
    charted = _charted_axes(chart, geom)
    T, fsz, csz = tuple(geom.T), geom.n_fsz, geom.n_csz
    padded = _padded_extents(geom)
    if route in (ROUTE_STATIONARY_1D, ROUTE_CHARTED_1D):
        kw = dict(batch=samples, t=T[0], coarse_len=padded[0], n_fsz=fsz,
                  n_csz=csz, dtype=dtype, charted=charted[0])
        return {"forward": [refine_1d_plan(**kw)],
                "vjp": [adjoint_1d_plan(**kw)]}
    if route == ROUTE_ND_FUSED:
        return {"forward": [nd_fused.nd_fused_plan(
                    samples=samples, field_shape=padded, T=T, n_fsz=fsz,
                    n_csz=csz, charted=charted, dtype=dtype)],
                "vjp": _nd_vjp_plans(geom, charted, samples, dtype)}
    if route == ROUTE_AXES_ND:
        extents = list(geom.coarse_shape)
        fwd, vjp = [], []
        for a in range(len(T) - 1, -1, -1):
            batch = samples * math.prod(extents) // extents[a]
            kw = dict(batch=batch, t=T[a], coarse_len=padded[a], n_fsz=fsz,
                      n_csz=csz, dtype=dtype, charted=charted[a],
                      noise=a == 0)
            fwd.append(refine_1d_plan(**kw))
            vjp.append(adjoint_1d_plan(**kw))
            extents[a] = T[a] * fsz
        return {"forward": fwd, "vjp": vjp[::-1]}
    raise ValueError(f"no launch plans for route {route!r}")


def chart_launch_plans(chart, *, samples: int = 1, dtype=None,
                       pyramid: bool = True, device=None) -> list:
    """Launch-plan export for a whole chart, as ``plan()`` routes it: one
    group per launch unit, ``{"level", "route", "vjp_route", "geoms",
    "forward", "vjp"}``. The pyramid's cover (``pyramid=True``) is one
    group (``level = (0, k-1)``) with its one launch, and its VJP the
    per-level adjoints in reverse. ``device`` (a CUDA device) makes the
    pyramid's grid the card's own occupancy instead of the H100 model."""
    from .icr_refine import adjoint_1d_plan
    from .pyramid import pyramid_plan

    itemsize, dtype = storage_width(dtype)
    cover = (pyramid_cover(chart, samples=samples, itemsize=itemsize)
             if pyramid else None) or 0
    groups = []
    if cover:
        geoms = [LevelGeom.for_level(chart, lvl) for lvl in range(cover)]
        charted = [_charted_axes(chart, g) for g in geoms]
        vjp = []
        for geom, ch in zip(reversed(geoms), reversed(charted)):
            if len(geom.coarse_shape) == 1:
                vjp.append(adjoint_1d_plan(
                    batch=samples, t=geom.T[0],
                    coarse_len=_padded_extents(geom)[0], n_fsz=geom.n_fsz,
                    n_csz=geom.n_csz, dtype=dtype, charted=ch[0]))
            else:
                vjp += _nd_vjp_plans(geom, ch, samples, dtype)
        groups.append({"level": (0, cover - 1), "route": ROUTE_PYRAMID,
                       "vjp_route": VJP_ROUTE[ROUTE_PYRAMID],
                       "geoms": geoms,
                       "forward": [pyramid_plan(samples=samples, geoms=geoms,
                                                charted=charted, dtype=dtype,
                                                device=device)],
                       "vjp": vjp})
    for lvl in range(cover, chart.n_levels):
        geom = LevelGeom.for_level(chart, lvl)
        route = route_for(geom, have_axis_mats=chart.ndim > 1)
        groups.append({"level": lvl, "route": route,
                       "vjp_route": VJP_ROUTE[route], "geoms": [geom],
                       **level_launch_plans(chart, lvl, route,
                                            samples=samples, dtype=dtype)})
    return groups


def plan_signature(chart, *, samples: int = 1, dtype=None,
                   pyramid: bool = True) -> list:
    """Canonical JSON-safe export of ``plan()`` with each level's launches:
    one dict per level (route, VJP route, kernel, dtype, the modeled bytes
    as ints) and per launch unit its plans' (kernel, instance, grid,
    block, shared memory), forward and VJP. ``json.dumps(...,
    sort_keys=True)`` of two signatures of one geometry is byte-identical,
    so a routing, tiling or byte-model change shows as a diff against a
    golden."""
    entries = plan(chart, pyramid=pyramid, samples=samples, dtype=dtype)
    groups = chart_launch_plans(chart, samples=samples, dtype=dtype,
                                pyramid=pyramid)
    launches = {}
    for grp in groups:
        first = grp["level"][0] if isinstance(grp["level"], tuple) \
            else grp["level"]
        launches[first] = {k: [launch_signature(p) for p in grp[k]]
                           for k in ("forward", "vjp")}
    by_level = {}
    for g in groups:
        lo, hi = (g["level"] if isinstance(g["level"], tuple)
                  else (g["level"], g["level"]))
        by_level.update({lvl: g["vjp_route"] for lvl in range(lo, hi + 1)})
    out = []
    for e in entries:
        out.append({
            "level": e["level"], "route": e["route"],
            "vjp_route": by_level[e["level"]], "kernel": e["kernel"],
            "launches": e["launches"], "dtype": e["dtype"],
            "hbm_bytes": {str(k): int(v) for k, v in e["hbm_bytes"].items()},
            "plans": launches.get(e["level"])})
    return out


def launch_signature(p) -> dict:
    """One plan's structural signature: kernel, instance, grid, block and
    shared memory (JSON-safe)."""
    inst = {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in p.instance.items()}
    return {"kernel": p.kernel, "instance": inst, "grid": list(p.grid),
            "block": list(p.block), "smem": int(p.smem)}
