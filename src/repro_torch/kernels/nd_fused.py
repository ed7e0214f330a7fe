"""The fused N-D forward refinement level (nd = 2 and 3).

One launch of ``csrc/nd_fused.cu`` computes a whole N-D level with the
per-axis Kronecker factors: it contracts the trailing axes ``d-1..1`` with
their factors ``R_a`` (shared, or per family on a charted axis), then
axis 0 with ``R_0``, adds ``sqrtD_0 · ξ0`` and writes the fine field once.
It replaces the JAX package's ``_nd_fused_kernel``. The noise factors of
axes ``1..d-1`` are contracted into ξ beforehand (``prepare_xi0``), and the
reflect padding is done before the launch; both are plain torch glue, as
in the JAX package.

On CPU tensors the plain version ``refine_nd_fused_plain`` runs instead;
a CUDA tensor launches the kernel or raises.

The level is differentiable in the field and ξ at fixed matrices: its
backward (``refine_nd_fused_adjoint``) composes the 1-D adjoint kernels in
reverse axis order, axis 0 with noise (giving ``dξ0``) and the trailing
axes without. This level has no backward in its factors: with factors
that require grad it raises, and ``dispatch.refine`` takes such a level
on the ``nd-axes`` route instead (``nd.refine_axes``), whose 1-D passes
give the factors' cotangents.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core.refine import LevelGeom, reflect_pad, reflect_pad_T

from . import build, launch
from .icr_refine import refine_charted_adjoint, refine_stationary_adjoint
from .ref import accum_dtype_for, windows_1d

__all__ = ["refine_nd_fused", "refine_nd_fused_core", "refine_nd_fused_plain",
           "refine_nd_fused_adjoint", "nd_operands", "nd_operands_T",
           "precontract_noise", "prepare_xi0", "prepare_xi0_T", "nd_tile",
           "nd_fused_plan", "nd_smem_bytes", "tile_maps"]

# shared memory a block may take: four blocks of 256 threads fit on an SM
# of the H100 (228 KB, 1 KB of it reserved per block)
_SMEM_BUDGET = 48 * 1024
BLOCKS_PER_SM = 4
# tiles a level should have, samples included: one per co-resident block
# (4 on each of the H100's 132 SMs); and the work items (four fine
# positions of one axis-0 family) below which a tile is not split further
_TARGET_TILES = 132 * BLOCKS_PER_SM
_MIN_ITEMS = 128


def precontract_noise(xi_nd, ds, *, off: int, accum,
                      transpose: bool = False) -> torch.Tensor:
    """Contract the trailing-axis noise factors ``sqrt(D_a)``, a >= 1, into
    the ``(..., T_0..T_{d-1}, f_0..f_{d-1})`` excitation tensor (``off``
    leading sample dims). Only the axis-0 stage adds noise in the kernel.
    ``transpose=True`` contracts with ``sqrt(D_a)ᵀ`` instead."""
    nd = (xi_nd.ndim - off) // 2
    xi_nd = xi_nd.to(accum)
    for a in range(1, nd):
        x2 = torch.movedim(xi_nd, (off + a, off + nd + a), (-2, -1))
        if ds[a].ndim == 2:
            eq = "...tf,fj->...tj" if transpose else "...tj,fj->...tf"
        else:
            eq = "...tf,tfj->...tj" if transpose else "...tj,tfj->...tf"
        x2 = torch.einsum(eq, x2, ds[a].to(accum))
        xi_nd = torch.movedim(x2, (-2, -1), (off + a, off + nd + a))
    return xi_nd


def prepare_xi0(xi, ds, T: tuple, fsz: int, *, accum, storage):
    """``(S, prod T, fsz^d)`` ξ -> the kernel layout ``(S, T_0·fsz,
    prod_f)``, trailing noise contracted, rounded to the storage dtype."""
    nd = len(T)
    n_s = xi.shape[0]
    xi_nd = precontract_noise(
        xi.reshape((n_s,) + tuple(T) + (fsz,) * nd), ds, off=1, accum=accum)
    perm = [0, 1, 1 + nd]
    for a in range(1, nd):
        perm += [1 + a, 1 + nd + a]
    return (xi_nd.permute(perm).reshape(n_s, T[0] * fsz, -1)
            .to(storage).contiguous())


def prepare_xi0_T(dxi0, ds, T: tuple, fsz: int, *, accum, storage):
    """Transpose of ``prepare_xi0``: ``(S, T_0·fsz, prod_f)`` -> ``(S,
    prod T, fsz^d)``."""
    nd = len(T)
    n_s = dxi0.shape[0]
    perm = [0, 1, 1 + nd]
    for a in range(1, nd):
        perm += [1 + a, 1 + nd + a]
    x = dxi0.reshape([n_s] + [(tuple(T) + (fsz,) * nd)[p - 1]
                              for p in perm[1:]])
    x = x.permute([perm.index(i) for i in range(len(perm))])
    x = precontract_noise(x, ds, off=1, accum=accum, transpose=True)
    return x.reshape(n_s, -1, fsz**nd).to(storage)


def refine_nd_fused_plain(field, xi0, r0, d0, rts, T) -> torch.Tensor:
    """Plain version of the kernel on the same operands.

    field: (S, L_0, ..., L_{d-1}) padded coarse field; xi0: (S, T_0·fsz,
    prod_f); r0/d0: axis-0 factors, shared or per family; rts: trailing
    factors R_1..R_{d-1} -> (S, T_0·fsz, prod_f). Trailing stages stay in
    the accumulation dtype; the result is rounded once.
    """
    nd = field.ndim - 1
    fsz, csz = r0.shape[-2], r0.shape[-1]
    s = fsz // 2
    acc = accum_dtype_for(field, xi0)
    x = field.to(acc)
    for a in range(nd - 1, 0, -1):
        arr = torch.movedim(x, 1 + a, -1)
        w = windows_1d(arr, T[a], csz, s)
        r = rts[a - 1].to(acc)
        eq = "...tc,tfc->...tf" if r.ndim == 3 else "...tc,fc->...tf"
        fine = torch.einsum(eq, w, r).reshape(arr.shape[:-1] + (T[a] * fsz,))
        x = torch.movedim(fine, -1, 1 + a)
    n_s = x.shape[0]
    prod_f = xi0.shape[2]
    arr = torch.movedim(x, 1, -1)                   # (S, *F_trail, L_0)
    w = windows_1d(arr, T[0], csz, s)
    eq = "...tc,tfc->...tf" if r0.ndim == 3 else "...tc,fc->...tf"
    fine = torch.einsum(eq, w, r0.to(acc))          # (S, *F_trail, T0, fsz)
    fine = fine.reshape(n_s, prod_f, T[0], fsz).permute(0, 2, 3, 1)
    xi3 = xi0.to(acc).reshape(n_s, T[0], fsz, prod_f)
    eq = "stjp,tfj->stfp" if d0.ndim == 3 else "stjp,fj->stfp"
    fine = fine + torch.einsum(eq, xi3, d0.to(acc))
    return fine.reshape(n_s, T[0] * fsz, prod_f).to(field.dtype)


def _smem_floats(tile, T, nd, csz, fsz, charted) -> int:
    """Shared memory (floats) of one block of ``nd_fused.cu`` (its host
    formula ``nd_smem_floats``, for the 3-box with a unit middle axis on
    2-D levels): the axis-2 output, one buffer for the box and the axis-1
    output, and the matrices."""
    s = fsz // 2
    b = tile if nd == 3 else (tile[0], 1, tile[1])
    ch = charted if nd == 3 else (charted[0], False, charted[1])
    e0, e2 = (b[0] - 1) * s + csz, (b[2] - 1) * s + csz
    e1 = (b[1] - 1) * s + csz if nd == 3 else 1
    g1 = b[1] * fsz if nd == 3 else 1
    g2 = -(-b[2] * fsz // 4) * 4
    n = e0 * e1 * g2 + max(e0 * e1 * e2, e0 * g1 * g2 if nd == 3 else 0)
    n += (b[0] if ch[0] else 1) * (fsz * csz + fsz * fsz)
    n += (b[1] if ch[1] else 1) * fsz * csz if nd == 3 else 0
    n += (b[2] if ch[2] else 1) * fsz * csz
    return n


def _work_items(tile, nd, fsz) -> int:
    """Axis-0 work items of a tile: one axis-0 family times four
    consecutive fine positions of the trailing axes."""
    g1 = tile[1] * fsz if nd == 3 else 1
    return tile[0] * g1 * -(-tile[-1] * fsz // 4)


def nd_tile(T: tuple, csz: int, fsz: int, charted: tuple,
            samples: int = 1) -> tuple:
    """Families per block on each axis: 2x8x8 in 3-D (2x16x16 at n_fsz=2),
    8x64 in 2-D (8x128), 512 work items of four fine positions, clipped to
    the level and halved along the largest axis until the block fits the
    shared budget (four blocks per SM); then, while the level has fewer
    than ``_TARGET_TILES`` tiles at ``samples`` samples, halved further as
    long as a tile keeps ``_MIN_ITEMS`` work items, so that small levels
    fill the card."""
    nd = len(T)
    if nd == 3:
        tile = [2, 8, 8] if fsz >= 4 else [2, 16, 16]
    else:
        tile = [8, 64] if fsz >= 4 else [8, 128]
    tile = [max(1, min(b, t)) for b, t in zip(tile, T)]

    def halved(tile):
        a = max(range(nd), key=lambda i: tile[i])
        return None if tile[a] == 1 else [
            b // 2 if i == a else b for i, b in enumerate(tile)]

    while _smem_floats(tile, T, nd, csz, fsz, charted) * 4 > _SMEM_BUDGET:
        tile = halved(tile)
        if tile is None:
            raise ValueError(f"no tile of {T} fits shared memory")
    while samples * math.prod(-(-t // b) for t, b in zip(T, tile)) < \
            _TARGET_TILES:
        smaller = halved(tile)
        if smaller is None or _work_items(smaller, nd, fsz) < _MIN_ITEMS:
            break
        tile = smaller
    return tuple(tile)


def nd_smem_bytes(tile3, T3, csz: int, fsz: int, charted3,
                  contract1: bool) -> int:
    """Dynamic shared memory (bytes) of a block of ``nd_fused.cu`` or of
    the pyramid's N-D levels: the C entries' ``nd_smem_floats``
    (``csrc/nd_tile.cuh``, ``NdPitch``) transcribed, on the 3-axis form
    (a 2-D level's middle axis has extent 1)."""
    s = fsz // 2
    b0, b1, b2 = tile3
    e0, e2 = (b0 - 1) * s + csz, (b2 - 1) * s + csz
    e1 = (b1 - 1) * s + csz if contract1 else 1
    g1 = b1 * fsz if contract1 else 1
    g2 = (b2 * fsz + 3) // 4 * 4
    box = e0 * e1 * e2
    a1 = e0 * g1 * g2 if contract1 else 0
    n = e0 * e1 * g2 + max(box, a1)
    n += (b0 if charted3[0] else 1) * (fsz * csz + fsz * fsz)
    n += (b1 if charted3[1] else 1) * fsz * csz if contract1 else 0
    n += (b2 if charted3[2] else 1) * fsz * csz
    return 4 * n


def tile_maps(*, samples: int, T3, tile3, csz: int, fsz: int, charted3,
              contract1: bool):
    """Ownership of the tiles of one N-D level (``nd_fused_tile`` in
    ``csrc/nd_tile.cuh``): for tile ``k`` (sample ``k // per``, tile ``k %
    per`` of the sample's ``per``), the box of the fine output and of ξ0
    it touches, on the 4-axis view ``(S, T_0·f, T_1·f, T_2·f)``, the
    padded coarse box it reads, ``[f_a·s, f_a·s + E_a)`` per axis, the
    windows its families need, and the factor rows. -> ``(writes, reads,
    needs)`` of ``launch.Boxes`` keyed by operand (``field`` in padded
    coordinates)."""
    Boxes = launch.Boxes
    s = fsz // 2
    n = [-(-t // b) for t, b in zip(T3, tile3)]
    per = n[0] * n[1] * n[2]
    k = np.arange(samples * per, dtype=np.int64)
    smp, j = k // per, k % per
    j2, j1, j0 = j % n[2], (j // n[2]) % n[1], j // (n[1] * n[2])
    f = [j0 * tile3[0], j1 * tile3[1], j2 * tile3[2]]
    nb = [np.minimum(tile3[a], T3[a] - f[a]) for a in range(3)]
    rows = (smp, smp + 1)
    fine = [(f[a] * fsz, (f[a] + nb[a]) * fsz) for a in range(3)]
    if not contract1:
        fine[1] = (0, 1)
    box = Boxes.of(rows, *fine)
    win = []
    for a in range(3):
        if a == 1 and not contract1:
            win.append((0, 1))
            continue
        # the box the kernel loads: E_a = (nb_a - 1)·s + C from f_a·s
        win.append((f[a] * s, f[a] * s + (nb[a] - 1) * s + csz))
    need = []
    for a in range(3):
        if a == 1 and not contract1:
            need.append((0, 1))
            continue
        # family t needs [t·s, t·s + C): the union over the tile's
        last = f[a] + nb[a] - 1
        need.append((f[a] * s, last * s + csz))
    mats = {}
    for a, name in ((0, "r0"), (1, "r1"), (2, "r2")):
        if a == 1 and not contract1:
            continue
        mats[name] = (Boxes.of((f[a], f[a] + nb[a]), (0, fsz), (0, csz))
                      if charted3[a] else Boxes.of((0, fsz), (0, csz)))
    mats["d0"] = (Boxes.of((f[0], f[0] + nb[0]), (0, fsz), (0, fsz))
                  if charted3[0] else Boxes.of((0, fsz), (0, fsz)))
    writes = {"out": box}
    reads = {"field": Boxes.of(rows, *win), "xi0": box, **mats}
    needs = {"field": Boxes.of(rows, *need), "xi0": box, **mats}
    return writes, reads, needs


def nd_fused_plan(*, samples: int, field_shape: tuple, T: tuple, n_fsz: int,
                  n_csz: int, charted: tuple, dtype="float32"):
    """The launch plan of one ``nd_fused.cu`` launch (#9): ``samples``
    samples of the padded field ``field_shape`` (the level's axes, padded),
    on ``nd_tile``'s tile."""
    return _nd_fused_plan(samples, tuple(field_shape), tuple(T), n_fsz,
                          n_csz, tuple(charted), launch.dtype_name(dtype))


# the wrapper's own cache, keyed by its operands' geometry: ``nd_tile`` is
# a pure function of it, so a launch looks its plan up once
@functools.lru_cache(maxsize=256)
def _nd_fused_plan(samples, field_shape, T, fsz, csz, charted, storage):
    tile = tuple(nd_tile(T, csz, fsz, charted, samples))
    return _nd_fused_record(samples, field_shape, T, fsz, csz, charted,
                            storage, tile)


# a plan is immutable: built once per geometry, the tile included
@functools.lru_cache(maxsize=256)
def _nd_fused_record(samples, field_shape, T, fsz, csz, charted, storage,
                     tile):
    nd = len(T)
    budget = 4 * _smem_floats(tile, tuple(T), nd, csz, fsz, tuple(charted))
    three = (lambda v, fill: tuple(v) if nd == 3
             else (v[0], fill, v[1]))
    T3, tile3, L3 = three(T, 1), three(tile, 1), three(field_shape, 1)
    ch3 = three(charted, False)
    prod_f = math.prod(t * fsz for t in T[1:])
    grid = (math.prod(-(-t // b) for t, b in zip(T3, tile3)), samples, 1)
    smem = nd_smem_bytes(tile3, T3, csz, fsz, ch3, nd == 3)

    def mat(a):
        return ((T[a],) if charted[a] else ()) + (fsz, csz)

    ops = [launch.Operand("field", (samples,) + tuple(field_shape), storage),
           launch.Operand("xi0", (samples, T[0] * fsz, prod_f), storage),
           launch.Operand("r0", mat(0), storage),
           launch.Operand("d0", ((T[0],) if charted[0] else ())
                          + (fsz, fsz), storage)]
    ops += [launch.Operand(f"r{a}" if nd == 3 else "r2", mat(a), storage)
            for a in range(1, nd)]
    ops.append(launch.Operand("out", (samples, T[0] * fsz, prod_f), storage,
                              out=True))
    view = (samples, T3[0] * fsz, T3[1] * fsz if nd == 3 else 1,
            T3[2] * fsz)

    def maps():
        spaces = {op.name: op.shape for op in ops}
        spaces.update(out=view, xi0=view, field=(samples,) + tuple(L3))
        return (launch.Group("refine_nd_fused", spaces, *tile_maps(
            samples=samples, T3=T3, tile3=tile3, csz=csz, fsz=fsz,
            charted3=ch3, contract1=nd == 3)),)

    return launch.LaunchPlan(
        kernel="refine_nd_fused", library="nd_fused",
        entry="refine_nd_fused_fwd",
        instance={"dtype": storage, "noise": True, "charted": list(charted),
                  "stencil": (fsz, csz) if (fsz, csz) in ((4, 5), (2, 3))
                  else "runtime", "tile": list(tile), "nd": nd},
        grid=grid, block=(launch.THREADS, 1, 1), smem=smem,
        operands=tuple(ops), smem_budget=budget, ownership=maps)


def _nd_fused(field, xi0, r0, d0, rts, T, out=None) -> torch.Tensor:
    if field.device.type == "cpu":
        return refine_nd_fused_plain(field, xi0, r0, d0, rts, T)
    nd = field.ndim - 1
    if nd not in (2, 3):
        raise ValueError(f"the fused N-D kernel takes 2-D and 3-D levels, "
                         f"not {nd}-D")
    build.dtype_code(field.dtype)
    fsz, csz = r0.shape[-2], r0.shape[-1]
    s = fsz // 2
    n_s = field.shape[0]
    prod_f = 1
    for a in range(1, nd):
        prod_f *= T[a] * fsz
    if tuple(xi0.shape) != (n_s, T[0] * fsz, prod_f):
        raise ValueError(f"xi0 {tuple(xi0.shape)} does not match T={T}")
    for a in range(nd):
        if field.shape[1 + a] < (T[a] - 1) * s + csz:
            raise ValueError(f"field axis {a} too short for {T[a]} families")
    charted = (r0.ndim == 3,) + tuple(r.ndim == 3 for r in rts)
    if n_s > 65535:
        raise ValueError(f"{n_s} samples exceed the launch grid")
    plan = nd_fused_plan(samples=n_s, field_shape=tuple(field.shape[1:]),
                         T=tuple(T), n_fsz=fsz, n_csz=csz, charted=charted,
                         dtype=field.dtype)
    tile = plan.instance["tile"]
    if out is None:
        out = torch.empty_like(xi0)
    if nd == 3:
        L, TT, B = field.shape[1:], T, tile
        r1, r2, ch1, ch2 = rts[0], rts[1], charted[1], charted[2]
    else:
        L = (field.shape[1], 1, field.shape[2])
        TT, B = (T[0], 1, T[1]), (tile[0], 1, tile[1])
        r1, r2, ch1, ch2 = None, rts[0], False, charted[1]
    named = {"field": field, "xi0": xi0, "r0": r0, "d0": d0, "out": out,
             "r2": r2}
    if r1 is not None:
        named["r1"] = r1
    launch.run_plan(plan, named, build.dtype_code(field.dtype),
                    field.data_ptr(), xi0.data_ptr(), r0.data_ptr(),
                    d0.data_ptr(), None if r1 is None else r1.data_ptr(),
                    r2.data_ptr(), out.data_ptr(), n_s, *L, *TT, csz, fsz,
                    int(charted[0]), int(ch1), int(ch2), *B, int(nd == 3))
    return out


def refine_nd_fused_adjoint(g, r0, d0, rts, T, field_shape) -> tuple:
    """Transpose of the level at fixed matrices: the 1-D adjoint kernels in
    reverse axis order. g: (S, T_0·fsz, prod_f) cotangent of the output ->
    (dfield (S, L_0, ..., L_{d-1}) of the padded field, dxi0 (S, T_0·fsz,
    prod_f)). Axis 0 runs with noise; each trailing axis without, over its
    whole padded length, so entries no window reaches come back zero. The
    ``movedim`` copies between the axes are torch glue."""
    nd = len(field_shape) - 1
    fsz = r0.shape[-2]
    n_s, l0 = field_shape[0], field_shape[1]
    prod_f = g.shape[2]
    f_trail = tuple(T[a] * fsz for a in range(1, nd))

    def adjoint(r):
        return refine_charted_adjoint if r.ndim == 3 else \
            refine_stationary_adjoint

    gb = g.reshape(n_s, T[0] * fsz, prod_f).movedim(1, -1)
    dc0, dxi0 = adjoint(r0)(gb.reshape(n_s * prod_f, -1).contiguous(), r0,
                            d0, coarse_len=l0)
    dxi = (dxi0.reshape(n_s, prod_f, T[0], fsz).permute(0, 2, 3, 1)
           .reshape(n_s, T[0] * fsz, prod_f))
    cur = dc0.reshape((n_s,) + f_trail + (l0,)).movedim(-1, 1)
    for a in range(1, nd):
        arr = cur.movedim(1 + a, -1)
        la = field_shape[1 + a]
        dca = adjoint(rts[a - 1])(
            arr.reshape(-1, T[a] * fsz).contiguous(), rts[a - 1],
            coarse_len=la)
        cur = dca.reshape(arr.shape[:-1] + (la,)).movedim(-1, 1 + a)
    return cur, dxi


class _NDFused(torch.autograd.Function):
    """The fused N-D level at fixed matrices; backward by 1-D adjoints."""

    @staticmethod
    def forward(ctx, field, xi0, r0, d0, T, *rts):
        ctx.T, ctx.field_shape = T, tuple(field.shape)
        ctx.save_for_backward(r0, d0, *rts)
        return _nd_fused(field, xi0, r0, d0, rts, T)

    @staticmethod
    def backward(ctx, g):
        r0, d0, *rts = ctx.saved_tensors
        dfield, dxi0 = refine_nd_fused_adjoint(g.contiguous(), r0, d0, rts,
                                               ctx.T, ctx.field_shape)
        return (dfield, dxi0) + (None,) * (3 + len(rts))


def refine_nd_fused_core(field, xi0, r0, d0, rts, T) -> torch.Tensor:
    """The kernel on prepared operands (see ``nd_operands``): launches
    ``nd_fused.cu`` on CUDA tensors, runs ``refine_nd_fused_plain`` on CPU
    tensors. -> (S, T_0·fsz, prod_f). Differentiable in ``field`` and
    ``xi0``; factors that require grad raise ``NotImplementedError``
    (``dispatch.refine`` routes those levels to ``nd-axes``)."""
    if torch.is_grad_enabled():
        if any(m.requires_grad for m in (r0, d0, *rts)):
            raise NotImplementedError(
                "learned θ has no backward on the fused N-D kernel "
                "(ROADMAP.md, 'Learned θ as a compiled fit'): run such a "
                "level through "
                "dispatch.refine, which takes the nd-axes route "
                "(nd.refine_axes) when a factor requires grad")
        if field.requires_grad or xi0.requires_grad:
            return _NDFused.apply(field, xi0, r0, d0, tuple(T), *rts)
    return _nd_fused(field, xi0, r0, d0, rts, T)


def nd_operands(field, xi, rs, ds, geom: LevelGeom, *,
                sample_axis: bool = False) -> tuple:
    """The torch glue before the kernel: ξ to the kernel layout with the
    trailing noise contracted, and the reflect padding. Returns the
    arguments of ``refine_nd_fused_core``."""
    nd = len(geom.coarse_shape)
    if nd < 2:
        raise ValueError("refine_nd_fused needs an N-D level (ndim >= 2)")
    fsz, T = geom.n_fsz, tuple(geom.T)
    if not sample_axis:
        field, xi = field[None], xi[None]
    xi0 = prepare_xi0(xi, ds, T, fsz, accum=accum_dtype_for(field, xi),
                      storage=field.dtype)
    if geom.boundary == "reflect":
        field = reflect_pad(field, geom.b, nd)
    rts = tuple(rs[a].contiguous() for a in range(1, nd))
    return (field.contiguous(), xi0, rs[0].contiguous(), ds[0].contiguous(),
            rts, T)


def nd_operands_T(dfield, dxi0, ds, geom: LevelGeom) -> tuple:
    """Transpose of the glue of ``nd_operands`` (sample axis leading):
    the padded field's and the kernel-layout ξ's cotangents -> those of the
    field (S, *coarse_shape) and ξ (S, prod T, fsz^d)."""
    nd = len(geom.coarse_shape)
    if geom.boundary == "reflect":
        dfield = reflect_pad_T(dfield, geom.b, nd)
    dxi = prepare_xi0_T(dxi0, ds, tuple(geom.T), geom.n_fsz,
                        accum=accum_dtype_for(dxi0), storage=dxi0.dtype)
    return dfield, dxi


def refine_nd_fused(field, xi, rs, ds, geom: LevelGeom, *,
                    sample_axis: bool = False) -> torch.Tensor:
    """One fused launch for a whole N-D refinement level.

    field: (*coarse_shape) or (S, *coarse_shape); xi: (prod(T), n_fsz^d)
    or (S, prod(T), n_fsz^d); rs[a]/ds[a]: per-axis factors from
    ``axis_refinement_matrices_level``. Returns the fine field,
    (*fine_shape) or (S, *fine_shape).
    """
    out = refine_nd_fused_core(*nd_operands(field, xi, rs, ds, geom,
                                            sample_axis=sample_axis))
    out = out.reshape(out.shape[:1] + tuple(geom.fine_shape))
    return out if sample_axis else out[0]
