"""The pyramid: the first levels of a chart in one cooperative launch.

``refine_pyramid`` runs consecutive levels of a chart (at most
``dispatch.pyramid_prefix`` of them; ``ICR`` takes ``dispatch.pyramid_cover``,
the 1-D stationary ones) as ONE launch of ``csrc/pyramid.cu``: the
blocks walk each level's tiles with a grid stride and meet at a grid-wide
barrier before the next level, so the fields that one covered level hands
to the next stay in the card's L2 instead of being written by one launch
and read back by the next. It replaces the JAX package's
``_pyramid_kernel`` (``src/repro/kernels/pyramid.py:150``); each level
computes what its per-level kernel computes (the tile bodies are shared),
and rounds to the storage dtype between levels as the reference does.

The torch glue before the launch is the per-level ξ layout with the
trailing noise contracted in (``nd_fused.prepare_xi0``); the reflect
padding happens in the kernel's read index. On CPU tensors the plain
version ``refine_pyramid_plain`` runs instead (the per-level plain
versions with the same storage rounding); a CUDA tensor launches the
kernel or raises. It never falls back to the per-level route.

Backward (``_Pyramid``), with no plain version on the card:

* at fixed matrices the map is linear in (field, ξ0): the per-level
  adjoint kernels over the covered levels in reverse, with the transposed
  reflect padding, and no saved intermediates;
* when a covered factor requires grad (learned θ), the covered levels are
  replayed through the per-level kernel routes under autograd (the 1-D
  routes on 1-D charts, ``nd-axes`` on N-D charts) and differentiated:
  the counterpart of the reference's replay (``pyramid.py:268-274``),
  through kernels instead of a reference chain.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.core.refine import LevelGeom, reflect_pad, reflect_pad_T

from . import build, nd
from .icr_refine import (
    charted_shape_1d,
    refine_charted,
    refine_charted_adjoint,
    refine_charted_plain,
    refine_stationary,
    refine_stationary_adjoint,
    refine_stationary_plain,
    stream_shape_1d,
)
from .nd_fused import nd_tile, prepare_xi0, refine_nd_fused_adjoint
from .nd_fused import refine_nd_fused_plain
from .policy import resolve as resolve_policy
from .ref import accum_dtype_for

__all__ = ["refine_pyramid", "refine_pyramid_core", "refine_pyramid_plain",
           "pyramid_operands", "MAX_LEVELS"]

MAX_LEVELS = 16      # levels one launch takes (kMaxLevels in pyramid.cu)
_LEVEL_FIELDS = 22   # int64 per level in the launch table (kLevelFields)

# grid size (blocks) of the last launch, for reports
last_grid = 0


def pyramid_operands(field, xis, mats, geoms, *,
                     sample_axis: bool = False) -> tuple:
    """The torch glue before the launch: each covered level's ξ in the
    kernel layout ``(S, T_0·fsz, prod_f)`` with its trailing noise factors
    contracted, rounded to the storage dtype.

    field: (*coarse_shape of geoms[0]) or (S, ...); xis[l]: (prod T_l,
    fsz^d) or (S, ...); mats[l] = (rs, ds), the per-axis factors (1-D: one
    entry each, shared (fsz, csz) or per family (T, fsz, csz)). Returns
    ``(field, levels)``, the arguments of ``refine_pyramid_core`` after
    ``geoms``: levels[l] = (xi0, rs, d0).
    """
    for lo, hi in zip(geoms[:-1], geoms[1:]):
        if tuple(hi.coarse_shape) != tuple(lo.fine_shape):
            raise ValueError("pyramid levels must be consecutive")
    if not sample_axis:
        field, xis = field[None], [x[None] for x in xis]
    levels = []
    for geom, xi, (rs, ds) in zip(geoms, xis, mats):
        xi0 = prepare_xi0(xi, ds, tuple(geom.T), geom.n_fsz,
                          accum=accum_dtype_for(field, xi),
                          storage=field.dtype)
        levels.append((xi0, tuple(r.contiguous() for r in rs),
                       ds[0].contiguous()))
    return field.contiguous(), tuple(levels)


def _padded(geom: LevelGeom) -> tuple:
    b = geom.b if geom.boundary == "reflect" else 0
    return tuple(n + 2 * b for n in geom.coarse_shape)


def _level_plain(x, geom: LevelGeom, xi0, rs, d0):
    """One covered level's plain version: pad, then the per-level plain
    version, rounded to the storage dtype once."""
    n_s, nd = x.shape[0], len(geom.coarse_shape)
    if geom.boundary == "reflect":
        x = reflect_pad(x, geom.b, nd)
    if nd == 1:
        plain = (refine_charted_plain if rs[0].ndim == 3
                 else refine_stationary_plain)
        out = plain(x, xi0.reshape(n_s, geom.T[0], geom.n_fsz), rs[0], d0)
    else:
        out = refine_nd_fused_plain(x, xi0, rs[0], d0, rs[1:],
                                    tuple(geom.T))
    return out.reshape((n_s,) + tuple(geom.fine_shape))


def refine_pyramid_plain(field, geoms, levels) -> torch.Tensor:
    """Plain version of the launch on the same operands: the per-level
    plain versions in turn, each rounded to the storage dtype."""
    x = field
    for geom, (xi0, rs, d0) in zip(geoms, levels):
        x = _level_plain(x, geom, xi0, rs, d0)
    return x


def _table(field, geoms, levels) -> np.ndarray:
    """The launch table of ``refine_pyramid_fwd``: one row of
    ``_LEVEL_FIELDS`` int64 per level (its order is in pyramid.cu)."""
    n_s = field.shape[0]
    rows = []
    for geom, (xi0, rs, d0) in zip(geoms, levels):
        nd = len(geom.coarse_shape)
        if nd > 3:
            raise ValueError(f"the pyramid takes 1-D to 3-D levels, not {nd}-D")
        fsz, csz, s = geom.n_fsz, geom.n_csz, geom.n_fsz // 2
        T = tuple(geom.T)

        def axes3(v, fill):
            v = tuple(v)
            return (v if nd == 3 else (v[0], fill, v[1]) if nd == 2
                    else (v[0], fill, fill))

        b = geom.b if geom.boundary == "reflect" else 0
        for a, (n, p) in enumerate(zip(geom.coarse_shape, _padded(geom))):
            if p < (T[a] - 1) * s + csz or (b and n <= b):
                raise ValueError(f"level axis {a} of {n} entries is too "
                                 f"short for {T[a]} families")
        charted = tuple(r.ndim == 3 for r in rs)
        prod_f = math.prod(t * fsz for t in T[1:])
        if tuple(xi0.shape) != (n_s, T[0] * fsz, prod_f):
            raise ValueError(f"xi0 {tuple(xi0.shape)} does not match T={T}")
        bb = 1
        if nd == 1 and charted[0]:   # (families, rows per thread), runs
            nf, sb, bb = charted_shape_1d(n_s, T[0], fsz, csz,
                                          field.element_size())[:3]
            tile = (nf, sb, 1)
        elif nd == 1:   # a stationary level streams: families, runs
            nf, bb = stream_shape_1d(n_s, T[0], fsz, csz,
                                     field.element_size())[:2]
            tile = (nf, 1, 1)
        else:
            tile = axes3(nd_tile(T, csz, fsz, charted, n_s), 1)
        # the kernel's 3-axis form: a 2-D level's trailing axis is axis 2
        r1 = rs[1].data_ptr() if nd == 3 else 0
        r2 = rs[-1].data_ptr() if nd > 1 else 0

        rows.append([nd, xi0.data_ptr(), rs[0].data_ptr(), d0.data_ptr(),
                     r1, r2, *axes3(geom.coarse_shape, 1),
                     *axes3((b,) * nd, 0), *axes3(T, 1),
                     *axes3(map(int, charted), 0), *tile, bb])
    return np.asarray(rows, dtype=np.int64).reshape(-1, _LEVEL_FIELDS)


def _launch(field, geoms, levels, *, max_blocks: int = 0) -> torch.Tensor:
    global last_grid
    if len(geoms) > MAX_LEVELS:
        raise ValueError(f"{len(geoms)} levels exceed the pyramid's "
                         f"{MAX_LEVELS}")
    named = {"field": field}
    for lvl, (xi0, rs, d0) in enumerate(levels):
        named[f"xi0_{lvl}"], named[f"d0_{lvl}"] = xi0, d0
        named.update({f"r{a}_{lvl}": r for a, r in enumerate(rs)})
    build.check_operands(**named)
    n_s = field.shape[0]
    if tuple(field.shape[1:]) != tuple(geoms[0].coarse_shape):
        raise ValueError(f"field {tuple(field.shape)} does not match level "
                         f"0's coarse shape {geoms[0].coarse_shape}")
    table = _table(field, geoms, levels)
    scratch = max([math.prod(g.fine_shape) for g in geoms[:-1]], default=1)
    bufs = [torch.empty(n_s * scratch, dtype=field.dtype,
                        device=field.device) for _ in range(2)]
    out = torch.empty((n_s,) + tuple(geoms[-1].fine_shape),
                      dtype=field.dtype, device=field.device)
    grid = ctypes.c_int(0)
    build.launch("pyramid", "refine_pyramid_fwd", field.device,
                 build.dtype_code(field.dtype), table.ctypes.data,
                 len(geoms), n_s, geoms[0].n_csz, geoms[0].n_fsz,
                 field.data_ptr(), out.data_ptr(), bufs[0].data_ptr(),
                 bufs[1].data_ptr(), max_blocks, ctypes.addressof(grid))
    build.LAUNCHES["refine_pyramid"] += 1
    last_grid = grid.value
    return out


def _pyramid(field, geoms, levels, max_blocks=0) -> torch.Tensor:
    if field.device.type == "cpu":
        return refine_pyramid_plain(field, geoms, levels)
    return _launch(field, geoms, levels, max_blocks=max_blocks)


def _transpose(g, geoms, levels) -> tuple:
    """The launch's transpose in (field, ξ0) at fixed matrices: the
    per-level adjoint kernels in reverse. g: (S, *fine_shape of the last
    level) -> (dfield, [dxi0 per level])."""
    n_s = g.shape[0]
    dxi0s = [None] * len(geoms)
    for lvl in reversed(range(len(geoms))):
        geom, (xi0, rs, d0) = geoms[lvl], levels[lvl]
        nd, padded = len(geom.coarse_shape), _padded(geom)
        if nd == 1:
            adjoint = (refine_charted_adjoint if rs[0].ndim == 3
                       else refine_stationary_adjoint)
            dc, dxi = adjoint(g.reshape(n_s, -1).contiguous(), rs[0], d0,
                              coarse_len=padded[0])
            dxi0s[lvl] = dxi.reshape(xi0.shape)
        else:
            dc, dxi0s[lvl] = refine_nd_fused_adjoint(
                g.reshape(xi0.shape).contiguous(), rs[0], d0, rs[1:],
                tuple(geom.T), (n_s,) + padded)
        if geom.boundary == "reflect":
            dc = reflect_pad_T(dc, geom.b, nd)
        g = dc
    return g, dxi0s


def _replay(field, geoms, levels) -> torch.Tensor:
    """The covered levels through the per-level kernel routes, under
    autograd: the 1-D routes on a 1-D chart, nd-axes on an N-D chart."""
    x = field
    n_s = field.shape[0]
    for geom, (xi0, rs, d0) in zip(geoms, levels):
        nd_, T, fsz = len(geom.coarse_shape), tuple(geom.T), geom.n_fsz
        if nd_ == 1:
            coarse = (reflect_pad(x, geom.b, 1) if geom.boundary == "reflect"
                      else x)
            kern = refine_charted if rs[0].ndim == 3 else refine_stationary
            x = kern(coarse.contiguous(), xi0.reshape(n_s, T[0], fsz), rs[0],
                     d0)
        else:
            # ξ0 from the kernel layout to the axis-0 pass's row order
            xa = (xi0.reshape(n_s, T[0], fsz, -1).permute(0, 3, 1, 2)
                  .reshape(-1, T[0], fsz))
            x = nd.axis_passes(x, xa, rs, d0, geom, off=1)
        x = x.reshape((n_s,) + tuple(geom.fine_shape))
    return x


def _unflatten(flat, counts) -> tuple:
    levels, i = [], 0
    for n in counts:
        levels.append((flat[i], tuple(flat[i + 1:i + 1 + n]), flat[i + 1 + n]))
        i += n + 2
    return tuple(levels)


class _Pyramid(torch.autograd.Function):
    """The launch; backward by the adjoint kernels at fixed matrices, by a
    replay through the per-level kernel routes when θ is learned."""

    @staticmethod
    def forward(ctx, geoms, counts, field, *flat):
        ctx.geoms, ctx.counts = geoms, counts
        ctx.save_for_backward(field, *flat)
        return _pyramid(field, geoms, _unflatten(flat, counts))

    @staticmethod
    def backward(ctx, g):
        field, *flat = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        levels = _unflatten(flat, ctx.counts)
        mat_pos = []
        i = 1
        for n in ctx.counts:
            mat_pos += list(range(i + 1, i + 2 + n))
            i += n + 2
        g = g.contiguous()
        if not any(need[p] for p in mat_pos):
            dfield, dxi0s = _transpose(g, ctx.geoms, levels)
            out = [dfield]
            for (dx, lv) in zip(dxi0s, levels):
                out += [dx] + [None] * (len(lv[1]) + 1)
        else:
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip([field, *flat], need)]
            with torch.enable_grad():
                y = _replay(inputs[0], ctx.geoms,
                            _unflatten(inputs[1:], ctx.counts))
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
            out = [next(grads) if n else None for n in need]
        return (None, None) + tuple(
            o if n else None for o, n in zip(out, need))


def refine_pyramid_core(field, geoms, levels, *,
                        max_blocks: int = 0) -> torch.Tensor:
    """The launch on prepared operands (``pyramid_operands``): launches
    ``pyramid.cu`` on CUDA tensors, runs ``refine_pyramid_plain`` on CPU
    tensors -> (S, *fine_shape of the last level). Differentiable in the
    field, every ξ0 and every factor. ``max_blocks > 0`` caps the grid
    below the co-resident maximum (the tests' striding check)."""
    geoms = tuple(geoms)
    flat = [t for xi0, rs, d0 in levels for t in (xi0, *rs, d0)]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (field, *flat)):
        if max_blocks:
            raise ValueError("max_blocks is a forward-only test knob")
        return _Pyramid.apply(geoms, tuple(len(lv[1]) for lv in levels),
                              field, *flat)
    return _pyramid(field, geoms, levels, max_blocks=max_blocks)


def refine_pyramid(field, xis, mats, geoms, *, sample_axis: bool = False,
                   policy=None) -> torch.Tensor:
    """Run consecutive levels ``geoms`` as one launch.

    field: (*geoms[0].coarse_shape) (or (S, ...) with ``sample_axis``);
    xis[l]: (prod T_l, n_fsz^d) per covered level (sample dim leading with
    ``sample_axis``); mats[l] = (rs_l, ds_l), the per-axis factors (1-D
    charts: single-entry lists of the shared or per-family matrices).
    ``policy``, when given, casts every operand to its storage dtype
    first. Returns the last level's fine field.
    """
    if policy is not None:
        field, xis, mats = resolve_policy(policy).cast_storage(
            (field, list(xis), [list(map(list, m)) for m in mats]))
    field, levels = pyramid_operands(field, xis, mats, geoms,
                                     sample_axis=sample_axis)
    out = refine_pyramid_core(field, geoms, levels)
    return out if sample_axis else out[0]
