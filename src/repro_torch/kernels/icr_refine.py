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

import functools

import numpy as np
import torch

from . import build, launch
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
           "charted_shape_1d", "refine_1d_plan", "adjoint_1d_plan",
           "stream_maps"]

# threads per block of the streaming kernels (kThreads in csrc/common.cuh)
THREADS = launch.THREADS
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


def stream_maps(i, *, batch: int, t: int, coarse_len: int, n_fsz: int,
                n_csz: int, families: int, rows: int, runs: int,
                charted: bool, noise: bool, adjoint: bool) -> tuple:
    """Ownership of the threads ``i`` (an int64 array) of a streaming 1-D
    launch, the index math of ``refine_1d.cu`` / ``refine_1d_adjoint.cu``
    (and of the pyramid's 1-D levels): thread ``i`` owns run ``i % runs``
    (``families`` families) of the rows ``[(i // runs)·rows, +rows)``.
    -> ``(writes, reads, needs)``, ``launch.Boxes`` keyed by operand:
    ``coarse``/``xi``/``out`` forward, ``g``/``dc``/``dxi`` adjoint, ``r``
    and ``d``. A thread past the last row owns nothing (empty boxes)."""
    B = launch.Boxes.of
    f, c, s, nf = n_fsz, n_csz, n_fsz // 2, families
    chunk = i // runs
    b0 = chunk * rows
    rws = (b0, np.minimum(b0 + rows, batch))
    t0 = (i - chunk * runs) * nf
    t1 = np.minimum(t0 + nf, t)
    fam = (t0, t1)
    mats = {"r": B(fam, (0, f), (0, c)) if charted else B((0, f), (0, c))}
    if noise:
        mats["d"] = (B(fam, (0, f), (0, f)) if charted else
                     B((0, f), (0, f)))
    if not adjoint:
        # the run's coarse window, (t1 - t0 - 1)·s + n_csz from t0·s; each
        # family t needs [t·s, t·s + n_csz)
        writes = {"out": B(rws, (t0 * f, t1 * f))}
        reads = {"coarse": B(rws, (t0 * s, t0 * s + (t1 - t0 - 1) * s + c)),
                 **mats}
        first, last = t0, t1 - 1
        needs = {"coarse": B(rws, (first * s, last * s + c)), **mats}
        if noise:
            reads["xi"] = needs["xi"] = B(rws, fam, (0, f))
    else:
        q = (c - 1) // s
        # dcoarse [t0·s, (t0+NF)·s); the row's last run on to L
        c1 = np.where(t0 + nf >= t, coarse_len, (t0 + nf) * s)
        writes = {"dc": B(rws, (t0 * s, c1))}
        # g of the run's families and of the q_max to their left
        lo = np.maximum(t0 - q, 0)
        reads = {"g": B(rws, (lo * f, t1 * f)), **mats}
        # dcoarse i gathers from the families t with 0 <= i - t·s < n_csz
        t_lo = np.clip(-((c - 1 - t0 * s) // s), 0, t)
        t_hi = np.clip((c1 - 1) // s + 1, 0, t)
        needs = {"g": B(rws, (np.minimum(t_lo, t0) * f,
                              np.maximum(t_hi, t1) * f)), **mats}
        if charted:
            reads["r"] = B((lo, t1), (0, f), (0, c))
            needs["r"] = B((np.minimum(t_lo, t0), np.maximum(t_hi, t1)),
                           (0, f), (0, c))
        if noise:
            writes["dxi"] = B(rws, fam, (0, f))
    live = (b0 < batch) & (t0 < t)
    return tuple({k: v.masked(live) for k, v in m.items()}
                 for m in (writes, reads, needs))


# the wrappers' plans by argument list and the charted kernels' tuning
# (which ``charted_shape_1d`` reads): a launch looks its plan up once
_PLANS_1D: dict = {}


def _plan_1d(*, batch: int, t: int, coarse_len: int, n_fsz: int, n_csz: int,
             dtype, charted: bool, noise: bool,
             adjoint: bool) -> launch.LaunchPlan:
    """The launch plan of one streaming 1-D launch (forward or adjoint):
    its geometry from ``stream_shape_1d`` / ``charted_shape_1d``, then the
    record (``_plan_1d_record``)."""
    key = (batch, t, coarse_len, n_fsz, n_csz, dtype, charted, noise,
           adjoint, CHARTED_THREADS, CHARTED_MAX_ROWS)
    plan = _PLANS_1D.get(key)
    if plan is None:
        if len(_PLANS_1D) >= 512:
            _PLANS_1D.clear()
        plan = _PLANS_1D[key] = _geometry_plan_1d(
            batch, t, coarse_len, n_fsz, n_csz, dtype, charted, noise,
            adjoint)
    return plan


def _geometry_plan_1d(batch, t, coarse_len, n_fsz, n_csz, dtype, charted,
                      noise, adjoint) -> launch.LaunchPlan:
    storage = launch.dtype_name(dtype)
    itemsize = {"float32": 4, "bfloat16": 2}.get(storage, 8)
    if charted:
        nf, sb, runs, blocks = charted_shape_1d(batch, t, n_fsz, n_csz,
                                                itemsize)
    else:
        nf, runs, blocks = stream_shape_1d(batch, t, n_fsz, n_csz, itemsize,
                                           adjoint=adjoint)
        sb = 1
    table = CHARTED_FAMILIES if charted else STREAM_FAMILIES[
        "adjoint" if adjoint else "forward"]
    stencil = ((n_fsz, n_csz) if (n_fsz, n_csz, itemsize) in table
               else "runtime")
    return _plan_1d_record(batch, t, coarse_len, n_fsz, n_csz, storage,
                           charted, noise, adjoint, stencil, nf, sb, runs,
                           blocks)


# a plan is immutable: built once per geometry (the key holds the geometry
# the shape functions chose, so a changed tuning table makes a new plan)
@functools.lru_cache(maxsize=512)
def _plan_1d_record(batch, t, coarse_len, f, c, storage, charted, noise,
                    adjoint, stencil, nf, sb, runs,
                    blocks) -> launch.LaunchPlan:
    """The plan's operands and ownership maps, the index math of
    ``refine_1d.cu`` / ``refine_1d_adjoint.cu``: thread ``i`` owns run ``i
    % runs`` (NF families) of row ``i // runs`` (stationary) or of the
    rows ``[(i // runs)·SB, +SB)`` (charted)."""
    mat = (t,) if charted else ()
    ops = [launch.Operand("g", (batch, t * f), storage) if adjoint else
           launch.Operand("coarse", (batch, coarse_len), storage)]
    if noise and not adjoint:
        ops.append(launch.Operand("xi", (batch, t, f), storage))
    ops.append(launch.Operand("r", mat + (f, c), storage))
    if noise:
        ops.append(launch.Operand("d", mat + (f, f), storage))
    if adjoint:
        ops.append(launch.Operand("dc", (batch, coarse_len), storage,
                                  out=True))
        if noise:
            ops.append(launch.Operand("dxi", (batch, t, f), storage,
                                      out=True))
    else:
        ops.append(launch.Operand("out", (batch, t * f), storage, out=True))
    kernel = ("refine_charted" if charted else "refine_stationary") + (
        "_adjoint" if adjoint else "") + ("" if noise else "_nn")

    def maps() -> tuple:
        i = np.arange(blocks * launch.THREADS, dtype=np.int64)
        spaces = {op.name: op.shape for op in ops}
        return (launch.Group(kernel, spaces, *stream_maps(
            i, batch=batch, t=t, coarse_len=coarse_len, n_fsz=f, n_csz=c,
            families=nf, rows=sb, runs=runs, charted=charted, noise=noise,
            adjoint=adjoint)),)

    return launch.LaunchPlan(
        kernel=kernel, library="refine_1d_adjoint" if adjoint else
        "refine_1d",
        entry=("refine_1d_" + ("charted" if charted else "stationary")
               + ("_adj" if adjoint else "_fwd")),
        instance={"dtype": storage, "noise": noise, "charted": charted,
                  "stencil": stencil, "families": nf, "rows": sb,
                  "runs": runs},
        grid=(blocks, 1, 1), block=(launch.THREADS, 1, 1), smem=0,
        operands=tuple(ops), ownership=maps)


def refine_1d_plan(*, batch: int, t: int, coarse_len: int, n_fsz: int,
                   n_csz: int, dtype="float32", charted: bool,
                   noise: bool = True) -> launch.LaunchPlan:
    """The plan of a forward 1-D launch (#1-#4): ``batch`` rows of ``t``
    families over coarse rows of ``coarse_len``."""
    return _plan_1d(batch=batch, t=t, coarse_len=coarse_len, n_fsz=n_fsz,
                    n_csz=n_csz, dtype=dtype, charted=charted, noise=noise,
                    adjoint=False)


def adjoint_1d_plan(*, batch: int, t: int, coarse_len: int, n_fsz: int,
                    n_csz: int, dtype="float32", charted: bool,
                    noise: bool = True) -> launch.LaunchPlan:
    """The plan of an adjoint 1-D launch (#5-#8)."""
    return _plan_1d(batch=batch, t=t, coarse_len=coarse_len, n_fsz=n_fsz,
                    n_csz=n_csz, dtype=dtype, charted=charted, noise=noise,
                    adjoint=True)


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


def _refine_1d(coarse, xi, r, d, *, charted: bool, t: int | None = None,
               out=None):
    """The forward kernel; ``xi=None`` (with ``d=None`` and the family count
    ``t``) is the noise-free variant. ``out``: a tensor of the output's
    shape to write into, instead of a new one."""
    noise = xi is not None
    if coarse.device.type == "cpu":
        if noise:
            plain = refine_charted_plain if charted else refine_stationary_plain
            return plain(coarse, xi, r, d)
        return (refine_charted_nn_plain(coarse, r) if charted
                else refine_stationary_nn_plain(coarse, r, t))
    build.dtype_code(coarse.dtype)
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
    plan = refine_1d_plan(batch=batch, t=t, coarse_len=length, n_fsz=n_fsz,
                          n_csz=n_csz, dtype=coarse.dtype, charted=charted,
                          noise=noise)
    inst = plan.instance
    shape = ((inst["families"], inst["rows"], inst["runs"]) if charted
             else (inst["families"], inst["runs"]))
    if out is None:
        out = torch.empty((batch, t * n_fsz), dtype=coarse.dtype,
                          device=coarse.device)
    launch.run_plan(plan, {"coarse": coarse, "xi": xi, "r": r, "d": d,
                           "out": out},
                    build.dtype_code(coarse.dtype), int(noise),
                    coarse.data_ptr(), xi.data_ptr() if noise else None,
                    r.data_ptr(), d.data_ptr() if noise else None,
                    out.data_ptr(), batch, length, t, n_csz, n_fsz, *shape)
    return out


def _adjoint_1d(g, r, d, coarse_len: int, *, charted: bool, out=None):
    """The adjoint kernel; ``out``: ``(dcoarse, dxi or None)`` tensors to
    write into, instead of new ones."""
    noise = d is not None
    if g.device.type == "cpu":
        plain = (refine_charted_adjoint_plain if charted
                 else refine_stationary_adjoint_plain)
        return plain(g, r, d, coarse_len=coarse_len)
    build.dtype_code(g.dtype)
    n_fsz, n_csz = r.shape[-2:]
    batch, width = g.shape
    t = width // n_fsz
    if t * n_fsz != width:
        raise ValueError(f"g width {width} is not a multiple of n_fsz "
                         f"{n_fsz}")
    _check_1d("refine_1d_adjoint", batch, t, n_fsz, n_csz, coarse_len,
              mat_lead=(t,) if charted else (), r=r, d=d)
    plan = adjoint_1d_plan(batch=batch, t=t, coarse_len=coarse_len,
                           n_fsz=n_fsz, n_csz=n_csz, dtype=g.dtype,
                           charted=charted, noise=noise)
    inst = plan.instance
    shape = ((inst["families"], inst["rows"], inst["runs"]) if charted
             else (inst["families"], inst["runs"]))
    if out is None:
        dc = torch.empty((batch, coarse_len), dtype=g.dtype, device=g.device)
        dxi = (torch.empty((batch, t, n_fsz), dtype=g.dtype, device=g.device)
               if noise else None)
    else:
        dc, dxi = out
    launch.run_plan(plan, {"g": g, "r": r, "d": d, "dc": dc, "dxi": dxi},
                    build.dtype_code(g.dtype), int(noise), g.data_ptr(),
                    r.data_ptr(), d.data_ptr() if noise else None,
                    dc.data_ptr(), dxi.data_ptr() if noise else None, batch,
                    coarse_len, t, n_csz, n_fsz, *shape)
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
