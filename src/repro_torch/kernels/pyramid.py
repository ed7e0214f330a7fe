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
import functools
import math

import numpy as np
import torch

from repro_torch.core.refine import LevelGeom, reflect_pad, reflect_pad_T

from . import build, icr_refine, launch, nd
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
from .icr_refine import stream_maps as icr_refine_stream_maps
from .nd_fused import _smem_floats, nd_smem_bytes, nd_tile, prepare_xi0
from .nd_fused import refine_nd_fused_adjoint, refine_nd_fused_plain
from .nd_fused import tile_maps as nd_fused_tile_maps
from .policy import resolve as resolve_policy
from .ref import accum_dtype_for

__all__ = ["refine_pyramid", "refine_pyramid_core", "refine_pyramid_plain",
           "pyramid_operands", "pyramid_plan", "resident_blocks",
           "MAX_LEVELS"]

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


def _level_geometry(n_s: int, geoms, charted, itemsize: int) -> list:
    """Each covered level's launch geometry on the kernel's 3-axis form (a
    2-D level's trailing axis is axis 2; a 1-D level's trailing axes have
    extent 1): ``nd``, stored coarse extents ``L``, reflect ``pad``,
    families ``T``, charted axes ``ch``, the ``tile`` (N-D: ``nd_tile``'s
    families per tile; 1-D: families per run and rows per thread), ``bb``
    (runs per row of a 1-D level) and ``tiles`` (the level's tiles, or its
    blocks of runs), with ``smem`` (the C entry's formula) and ``budget``
    (``nd_tile``'s) bytes of an N-D level's tile."""
    out = []
    for geom, ch in zip(geoms, charted):
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
        ch = tuple(ch)
        bb, smem, budget = 1, 0, 0
        if nd == 1 and ch[0]:   # (families, rows per thread), runs
            nf, sb, bb = charted_shape_1d(n_s, T[0], fsz, csz, itemsize)[:3]
            tile = (nf, sb, 1)
            tiles = -(-(-(-n_s // sb) * bb) // 256)
        elif nd == 1:   # a stationary level streams: families, runs
            nf, bb = stream_shape_1d(n_s, T[0], fsz, csz, itemsize)[:2]
            tile = (nf, 1, 1)
            tiles = -(-n_s * bb // 256)
        else:
            nt = nd_tile(T, csz, fsz, ch, n_s)
            tile = axes3(nt, 1)
            smem = nd_smem_bytes(tile, axes3(T, 1), csz, fsz,
                                 axes3(ch, False), nd == 3)
            budget = 4 * _smem_floats(nt, T, nd, csz, fsz, ch)
            tiles = n_s * math.prod(-(-t // b_) for t, b_ in
                                    zip(axes3(T, 1), tile))
        out.append({"nd": nd, "L": axes3(geom.coarse_shape, 1),
                    "pad": axes3((b,) * nd, 0), "T": axes3(T, 1),
                    "ch": axes3(map(int, ch), 0), "tile": tile, "bb": bb,
                    "tiles": tiles, "smem": smem, "budget": budget})
    return out


def _charted(levels) -> tuple:
    return tuple(tuple(r.ndim == 3 for r in rs) for _, rs, _ in levels)


def _static_table(lv) -> np.ndarray:
    """The launch table's fields that follow from the geometry, its
    operand pointers (columns 1-5) left 0."""
    return np.asarray([[g["nd"], 0, 0, 0, 0, 0, *g["L"], *g["pad"],
                        *g["T"], *g["ch"], *g["tile"], g["bb"]]
                       for g in lv], dtype=np.int64).reshape(
                           -1, _LEVEL_FIELDS)


def _fill_table(static: np.ndarray, lv, levels) -> np.ndarray:
    """``static`` with each level's operand pointers filled in: ξ0, the
    factor of axis 0, d0, and (N-D) those of axes 1 and 2."""
    table = static.copy()
    table[:, 1:6] = [[xi0.data_ptr(), rs[0].data_ptr(), d0.data_ptr(),
                      rs[1].data_ptr() if g["nd"] == 3 else 0,
                      rs[-1].data_ptr() if g["nd"] > 1 else 0]
                     for g, (xi0, rs, d0) in zip(lv, levels)]
    return table


def _table(field, geoms, levels) -> np.ndarray:
    """The launch table of ``refine_pyramid_fwd``: one row of
    ``_LEVEL_FIELDS`` int64 per level (its order is in pyramid.cu)."""
    n_s = field.shape[0]
    lv = _level_geometry(n_s, geoms, _charted(levels), field.element_size())
    for geom, (xi0, _, _) in zip(geoms, levels):
        T = tuple(geom.T)
        prod_f = math.prod(t * geom.n_fsz for t in T[1:])
        if tuple(xi0.shape) != (n_s, T[0] * geom.n_fsz, prod_f):
            raise ValueError(f"xi0 {tuple(xi0.shape)} does not match T={T}")
    return _fill_table(_static_table(lv), lv, levels)


# blocks of 256 an H100 SM holds of the pyramid's instances
# (__launch_bounds__ in pyramid.cu: 4 with N-D levels, 3 with 1-D ones) and
# the card's SMs: the co-resident grid of a plan made without a card
BLOCKS_PER_SM = {True: 4, False: 3}
H100_SMS = 132
_RESIDENT: dict = {}


def resident_blocks(dtype, nd: bool, fsz: int, csz: int, smem: int,
                    device=None) -> int:
    """Co-resident blocks of the pyramid instance: on a CUDA ``device``
    the occupancy the C side computes (``refine_pyramid_resident``), else
    the H100 model ``BLOCKS_PER_SM × H100_SMS``."""
    if device is None or torch.device(device).type != "cuda":
        return BLOCKS_PER_SM[bool(nd)] * H100_SMS
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    key = (str(dtype), bool(nd), fsz, csz, int(smem), index)
    if key not in _RESIDENT:
        blocks = ctypes.c_int(0)
        lib = build.library("pyramid")
        code = {"float32": 0, "bfloat16": 1}[launch.dtype_name(dtype)]
        err = lib.refine_pyramid_resident(
            code, 2 if nd else 1, csz, fsz, int(smem), index,
            ctypes.addressof(blocks))
        if err != 0:
            raise RuntimeError("refine_pyramid_resident failed: "
                               + lib.repro_cuda_error_string(err).decode())
        _RESIDENT[key] = blocks.value
    return _RESIDENT[key]


def pyramid_plan(*, samples: int, geoms, charted, dtype="float32",
                 device=None) -> launch.LaunchPlan:
    """The launch plan of one ``pyramid.cu`` launch (#10); see
    ``_pyramid_record``."""
    storage = launch.dtype_name(dtype)
    charted = tuple(tuple(c) for c in charted)
    lv = _level_geometry(samples, geoms, charted,
                         {"float32": 4, "bfloat16": 2}[storage])
    return _plan_of(samples, tuple(geoms), charted, storage, lv, 0, device)


def _plan_of(samples, geoms, charted, storage, lv, max_blocks, device):
    """The plan of levels whose ``_level_geometry`` is ``lv``: its grid
    (every co-resident block, at most the largest level's tiles and
    ``max_blocks`` > 0), then the cached record."""
    nd = lv[0]["nd"] > 1
    smem = max(g["smem"] for g in lv)
    grid = min(resident_blocks(storage, nd, geoms[0].n_fsz,
                               geoms[0].n_csz, smem, device),
               max(1, max(g["tiles"] for g in lv)))
    if max_blocks > 0:
        grid = min(grid, max_blocks)
    # ``_level_geometry`` builds every level's dict in one key order
    frozen = tuple(tuple(g.items()) for g in lv)
    on_card = device is not None and torch.device(device).type == "cuda"
    return _pyramid_record(samples, geoms, charted, storage, frozen, grid,
                           on_card)


# a plan is immutable: built once per geometry (the levels' geometry and
# the grid in the key, so a changed tuning table makes a new plan)
@functools.lru_cache(maxsize=64)
def _pyramid_record(samples: int, geoms: tuple, charted: tuple, storage,
                    frozen: tuple, grid: int,
                    on_card: bool) -> launch.LaunchPlan:
    """The launch plan of one ``pyramid.cu`` launch (#10) over the levels
    ``geoms`` (``charted[l]``: the per-family axes of level l), at
    ``samples`` samples of the storage ``dtype``. Its grid is every
    co-resident block (``resident_blocks``: the card's own occupancy on a
    CUDA ``device``, else the H100 model), at most the largest level's
    tiles and ``max_blocks`` (> 0); its shared memory the largest N-D
    level's tile. The ownership maps: per level, each tile (N-D, as
    ``nd_fused.tile_maps``) or run of rows (1-D, as
    ``icr_refine.stream_maps``) of the grid-stride loop, on that level's
    input in padded coordinates (the kernel reflects in the index)."""
    lv = [dict(g) for g in frozen]
    nd = lv[0]["nd"] > 1
    fsz, csz = geoms[0].n_fsz, geoms[0].n_csz
    smem = max(g["smem"] for g in lv)
    scratch = max([math.prod(g.fine_shape) for g in geoms[:-1]], default=1)
    ops = [launch.Operand("field", (samples,) + tuple(geoms[0].coarse_shape),
                          storage)]
    for lvl, (geom, ch) in enumerate(zip(geoms, charted)):
        T = tuple(geom.T)
        prod_f = math.prod(t * fsz for t in T[1:])
        ops.append(launch.Operand(f"xi0_{lvl}", (samples, T[0] * fsz, prod_f),
                                  storage))
        for a in range(len(T)):
            ops.append(launch.Operand(
                f"r{a}_{lvl}", ((T[a],) if ch[a] else ()) + (fsz, csz),
                storage))
        ops.append(launch.Operand(
            f"d0_{lvl}", ((T[0],) if ch[0] else ()) + (fsz, fsz), storage))
    ops += [launch.Operand("scratch0", (samples * scratch,), storage,
                           out=True),
            launch.Operand("scratch1", (samples * scratch,), storage,
                           out=True),
            launch.Operand("out", (samples,) + tuple(geoms[-1].fine_shape),
                           storage, out=True)]
    last = len(geoms) - 1
    shape = {op.name: op.shape for op in ops}

    def maps():
        groups = []
        for lvl, (geom, g) in enumerate(zip(geoms, lv)):
            src = "field" if lvl == 0 else f"scratch{(lvl - 1) & 1}"
            dst = "out" if lvl == last else f"scratch{lvl & 1}"
            padded = tuple(n + 2 * p for n, p in zip(g["L"], g["pad"]))
            T = tuple(geom.T)
            names = {"out": f"fine_{lvl}", "xi0": f"xi0_{lvl}",
                     "d0": f"d0_{lvl}"}
            spaces = {f"d0_{lvl}": shape[f"d0_{lvl}"]}
            if g["nd"] == 1:
                n_runs = (-(-samples // g["tile"][1]) * g["bb"])
                w, r, n = icr_refine_stream_maps(
                    np.arange(n_runs, dtype=np.int64), batch=samples,
                    t=T[0], coarse_len=padded[0], n_fsz=fsz, n_csz=csz,
                    families=g["tile"][0], rows=g["tile"][1], runs=g["bb"],
                    charted=bool(g["ch"][0]), noise=True, adjoint=False)
                names.update(coarse=f"in_{lvl}", xi=f"xi0_{lvl}",
                             r=f"r0_{lvl}", d=f"d0_{lvl}")
                spaces.update({f"in_{lvl}": (samples, padded[0]),
                               f"fine_{lvl}": (samples, T[0] * fsz),
                               f"xi0_{lvl}": (samples, T[0], fsz),
                               f"r0_{lvl}": shape[f"r0_{lvl}"]})
            else:
                w, r, n = nd_fused_tile_maps(
                    samples=samples, T3=g["T"], tile3=g["tile"], csz=csz,
                    fsz=fsz, charted3=tuple(map(bool, g["ch"])),
                    contract1=g["nd"] == 3)
                view = (samples, g["T"][0] * fsz,
                        g["T"][1] * fsz if g["nd"] == 3 else 1,
                        g["T"][2] * fsz)
                names.update(field=f"in_{lvl}", r0=f"r0_{lvl}",
                             r1=f"r1_{lvl}",
                             r2=f"r{g['nd'] - 1}_{lvl}")
                spaces.update({f"in_{lvl}": (samples,) + padded,
                               f"fine_{lvl}": view, f"xi0_{lvl}": view})
                for a in range(g["nd"]):
                    spaces[f"r{a}_{lvl}"] = shape[f"r{a}_{lvl}"]
            w, r, n = ({names.get(k, k): v for k, v in m.items()}
                       for m in (w, r, n))
            groups.append(launch.Group(
                f"level {lvl}", spaces, w, r, n,
                buffers={f"in_{lvl}": src, f"fine_{lvl}": dst},
                reflect={f"in_{lvl}": (g["L"], g["pad"])}))
        return tuple(groups)

    return launch.LaunchPlan(
        kernel="refine_pyramid", library="pyramid",
        entry="refine_pyramid_fwd",
        instance={"dtype": storage, "noise": True, "nd": bool(nd),
                  "stencil": (fsz, csz) if (fsz, csz) in ((4, 5), (2, 3))
                  else "runtime", "levels": len(geoms),
                  "resident": "card" if on_card else "model",
                  "tiles": [g["tiles"] for g in lv]},
        grid=(grid, 1, 1), block=(launch.THREADS, 1, 1), smem=smem,
        operands=tuple(ops), smem_budget=max(g["budget"] for g in lv),
        ownership=maps)


# the launch's geometry, static table and plan, by its operands' geometry
# and the charted levels' tuning (``icr_refine.CHARTED_THREADS`` and
# ``CHARTED_MAX_ROWS``, which ``charted_shape_1d`` reads): looked up once
# a launch, built once a geometry
_LAUNCH_GEOMETRY: dict = {}


def _launch_geometry(n_s, geoms: tuple, charted, field, max_blocks):
    key = (n_s, geoms, charted, field.dtype, max_blocks, field.device,
           icr_refine.CHARTED_THREADS, icr_refine.CHARTED_MAX_ROWS)
    hit = _LAUNCH_GEOMETRY.get(key)
    if hit is None:
        lv = _level_geometry(n_s, geoms, charted, field.element_size())
        hit = (lv, _static_table(lv),
               _plan_of(n_s, geoms, charted, launch.dtype_name(field.dtype),
                        lv, max_blocks, field.device))
        if len(_LAUNCH_GEOMETRY) >= 64:
            _LAUNCH_GEOMETRY.clear()
        _LAUNCH_GEOMETRY[key] = hit
    return hit


def _launch(field, geoms, levels, *, max_blocks: int = 0,
            out=None) -> torch.Tensor:
    global last_grid
    if len(geoms) > MAX_LEVELS:
        raise ValueError(f"{len(geoms)} levels exceed the pyramid's "
                         f"{MAX_LEVELS}")
    build.dtype_code(field.dtype)
    n_s = field.shape[0]
    if tuple(field.shape[1:]) != tuple(geoms[0].coarse_shape):
        raise ValueError(f"field {tuple(field.shape)} does not match level "
                         f"0's coarse shape {geoms[0].coarse_shape}")
    lv, static, plan = _launch_geometry(n_s, tuple(geoms), _charted(levels),
                                        field, max_blocks)
    # the operands' shapes are the plan's (run_plan checks them before the
    # table reaches the card)
    table = _fill_table(static, lv, levels)
    named = {"field": field}
    for lvl, (xi0, rs, d0) in enumerate(levels):
        named[f"xi0_{lvl}"], named[f"d0_{lvl}"] = xi0, d0
        named.update({f"r{a}_{lvl}": r for a, r in enumerate(rs)})
    bufs = [torch.empty(plan.expect[f"scratch{i}"][0], dtype=field.dtype,
                        device=field.device) for i in range(2)]
    if out is None:
        out = torch.empty((n_s,) + tuple(geoms[-1].fine_shape),
                          dtype=field.dtype, device=field.device)
    named.update(scratch0=bufs[0], scratch1=bufs[1], out=out)
    grid = ctypes.c_int(0)
    launch.run_plan(plan, named, build.dtype_code(field.dtype),
                    table.ctypes.data, len(geoms), n_s, geoms[0].n_csz,
                    geoms[0].n_fsz, field.data_ptr(), out.data_ptr(),
                    bufs[0].data_ptr(), bufs[1].data_ptr(), max_blocks,
                    ctypes.addressof(grid))
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
