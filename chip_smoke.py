#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ICR on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --eager-step LABEL=SRC[:fpad] ...`` instead
times the eager dust fit step of the package under each SRC, one process
each, to compare two trees in one call: see ``eager_step_ab``.)

Phases (any failure ends the run with a non-zero exit code):

1. build   — compile every CUDA kernel of the port from ``src/repro_torch``
   (one nvcc per source, in parallel); print the build time and the card,
   and (``ptxas`` line) the registers and spills of each instance of the
   streaming 1-D kernels (stationary and charted, forward and adjoint),
   the N-D kernel and the pyramid, with the shared memory of the N-D and
   pyramid launches and the blocks an SM holds.
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes of every level of four charts (flagship dust
   ``galactic_dust_chart((8,16,16), 3)``, ``regular_chart(1024, 10)``,
   ``log_chart(1024, 8, n_csz=5, n_fsz=4)``, ``log_polar_chart((64,64),
   3)``), S=8 samples, real refinement matrices, in float32 (max relative
   error <= 1e-5) and with bfloat16 storage (<= 5e-2): the three forward
   kernels, the two noise-free forward kernels at every non-final pass the
   nd-axes route makes on the N-D levels, the pyramid at each chart's
   residency prefix (``dispatch.pyramid_prefix`` at S=8; ``pyramid_cover``
   keeps regular's alone; on the 1-D charts it must equal the per-level
   kernels bit for bit), the four adjoint kernels at every launch a
   level's backward makes (1-D levels; axis 0 and the trailing axes of N-D
   levels), and the charted forward at the nd-axes route's axis-0 pass of
   dust's last level in a learned-θ step (S=1: 16,384 rows of 16
   families).
3. path    — ``ICR(..., use_pallas=True).sample_batch(gen, 8)`` on each
   chart at both dtype policies, twice: with the pyramid (the default),
   which must launch once for its cover plus the per-level kernel once per
   uncovered level, and with ``use_pyramid=False``, every level on its
   per-level kernel; each held against the same apply through the plain
   versions on the card, the launch counters zeroed just before.
4. train   — training on the kernel route, float32, each path with the
   launch counters zeroed just before and read just after: ``dust`` 20
   ``map_fit`` and 10 ``advi_fit`` steps (n_mc=2) on ``charted_gp_dataset``
   (obs_frac 0.3, noise 0.05); ``regular``, ``dust_theta`` and
   ``log_polar_theta`` 10 joint (ξ, ρ) MAP steps under a lognormal prior,
   the matrices rebuilt in every step (the N-D ones through the pyramid's
   replay over the nd-axes route); ``log`` and ``log_polar`` 10 MAP steps
   at fixed θ. Losses must fall and every kernel the path reaches must
   have launched. Then, per path, one step's gradient through the kernels
   against the same through the plain versions (ξ <= 1e-5; on the
   learned-θ paths the matrix cotangents <= 1e-4 and dρ reported, see
   ``theta_gradient``), and ``ICR.apply_sqrt_T_batch`` on the kernels
   against autograd of the plain apply at both policies. The fixed-θ
   fits run compiled (``jit=True``: one captured CUDA graph per step,
   replayed); the learned-θ ones with ``jit=False`` (their eigh syncs
   with the host).
4b. graphs — the compiled paths against the same code run op by op on
   the card, bit for bit: ``map_fit(jit=True)`` against ``jit=False`` on
   dust, log and log_polar (10 steps, losses and ξ̂), dust's ADVI fit
   against its eager twin from the same generator state,
   ``apply_sqrt_T_batch`` (a replay of its cached graph) against its chain
   op by op on the four charts at S = 1 and 8 and both policies (and
   against autograd of the plain apply at the tolerances above), and
   ``map_fit(jit=True)`` on regular's learned-θ forward, which must raise
   naming ``jit=False``; every capture holds its kernel nodes to its
   wrappers' launches (``core/graphs.capture``). One ``graphs`` line.
5. serve   — ``GPFieldServer(demo_posterior(...), slab=8)`` on each
   chart at both dtype policies serves ``mixed_requests(3, 16)`` cold,
   then warm, the launch counters zeroed just before and read just after
   (every kernel of the chart's plan must have launched). Each slab is
   one replay of a captured CUDA graph whose kernel nodes, counted by
   name at capture, equal the plan's launches kernel for kernel (each
   replay adds those counts); checked: the graph's slab equals
   the eager kernel route on the same ξ bit for bit (and that route its
   plain version, at the tolerances above), warm traffic captures no
   graph and rebuilds no matrices and no plan, the card's integer noise
   stream equals the CPU's, every field is finite and every moments std
   positive. The ``serve`` line gives per chart and dtype the slab's
   milliseconds replayed and eager (CUDA events after the flush), the
   host milliseconds to enqueue each, the draw's and the device-to-host
   copy's milliseconds, the host milliseconds of one numpy Welford merge
   of a whole slab, cold and warm milliseconds, rows per second, the
   modeled slab bytes (``plan()``'s ``hbm_bytes``) and their bound at the
   card's bandwidth, the draw's floor bytes (``draw_floor_bytes``) and
   bound, the bound of the whole slab (levels, draw and the f32 cast),
   and the card's name and power limit.
6. condition — the data-conditioned solve on the four charts at full
   width, float32, one ``condition`` line per chart, the launch counters
   zeroed just before each driven path and read just after (every kernel
   of the forward's plan and of its adjoint must have launched):
   (a) ``cg_posterior`` with 4,096 seeded on-grid observations of a prior
   draw, σ = 0.25, at its default config (rtol 1e-7, the bar rising to
   the float32 matvec's rounding δ at each column's own iterate, capped
   at ``floor_cap``; the report stating rtol, the cap and δ): rungs,
   iterations, status, the reported relres, the preconditioner's bytes
   and the solve's wall ms; matvec milliseconds by CUDA events at k = 1
   and 17 and the host time to enqueue one; checked: status
   ``converged`` or ``dense``, and the residual ‖y − A α‖/‖y‖ of the
   solve's own α (``cg_posterior``'s ``_solution``) recomputed through
   the plain versions at float64 on the solve's own matrices
   (``residuals64``, ``same``) within 10·max(rtol, min(δ, cap)) < 1, δ
   the rounding of one float32 kernel-route matvec at α; the residual on
   matrices built
   at float64 is printed beside it; then the same solve at the JAX
   package's rtol 1e-7 (``cond_tight``: the CG rungs stall, the dense
   rung answers); both solves again with their CG segments replayed from
   captured graphs and run op by op, equal bit for bit in status,
   iterations and α (``graph_vs_eager``), and one CG iteration's
   milliseconds and a segment's enqueue each way at k = 1 and 17
   (``cg_iteration_ms``); (b)
   ``condition_matvec`` on the kernels against the plain route
   (``plain_matvec``) at k = 17, <= 1e-5 at f32 and <= 5e-2 with bf16
   storage; on dust and regular, (c) one served ``kind="condition"``
   request (n = 16) at rtol 1e-7: its mean and (a)'s at rtol 1e-7
   against each other and against the float64 posterior mean of the same
   system (``mean64``) within ``COND_MEAN_F64``, its std finite, its
   ``SolveReport`` in ``metrics()``; (e) on ``charted_gp_dataset``'s
   pattern (30 %, σ = 0.05: 314,572 observations) ``cg_posterior`` and a
   served request at their default configs must answer, α's float64
   residual within 10·max(rtol, min(δ, cap)) < 1, with the device bytes
   of the preconditioner and of the server's cached system beside it;
   each line ends with the bytes the card still holds once the chart's
   systems are dropped; (d) on that pattern the ICR rung at
   the level-0 basis (the default system's preconditioner) against the
   unpreconditioned rung (500 iterations): iterations, status and the
   float64 residual of each; a rung that reports ``converged`` above
   10·rtol on its own matrices fails the run.
7. times   — per kernel at its chart's largest level (the pyramid at
   regular's cover, the one ``ICR`` runs, and at the dust prefix, with the
   per-level kernels it replaces beside it):
   CUDA-event medians of the kernel, its plain version and, where one
   PyTorch call computes (part of) the same function, that call
   (``F.conv1d``, ``F.conv_transpose1d`` or an einsum over a strided view
   of the coarse rows); a device copy of as many bytes (``copy_ms``: what
   this timing gives a kernel that only moves its bytes); #7 also at the
   N-D backward's axis-0 shape (dust's last level), #3 at the nd-axes
   route's axis-0 shape (``shape.nd_axes``); the
   byte/operation bound; whole-path milliseconds per chart with the
   pyramid on and off; per level of each chart at float32, the torch glue
   against the kernels, forward and backward, and ``apply_sqrt_T_batch``
   replayed and op by op with the host enqueue of each; and one training
   step's milliseconds (forward, backward and update) per path, with its
   host enqueue time, op by op and, at fixed θ, as one graph replay.

The last three lines are the ``kernels`` JSON line, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.

Relative error is ``max|kernel - plain| / max|plain|``. Float32 matmuls
and convolutions run without TF32 throughout.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
S = 8                        # samples per apply (the serving slab)
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
REPS = 25                    # timed repetitions after warm-up
F32_PEAK = 67e12             # H100 SXM f32 (non-tensor) FLOP/s, data sheet
# device memory bandwidth by card name (NVIDIA data sheets)
BANDWIDTH = [("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12)]

FWD_SRC = "src/repro_torch/kernels/csrc/refine_1d.cu"
ADJ_SRC = "src/repro_torch/kernels/csrc/refine_1d_adjoint.cu"
# per kernel: its source, the TPU kernel it replaces, and the chart (and
# level axis, for the noise-free passes and the trailing-axis adjoints)
# whose largest level it is timed at
KERNEL_INFO = {
    "refine_stationary": {
        "source": FWD_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:98",
        "replaces_fn": "_stationary_kernel",
        "chart": "regular"},
    "refine_stationary_nn": {
        "source": FWD_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:115",
        "replaces_fn": "_stationary_nn_kernel",
        "chart": "dust", "axis": 1},
    "refine_charted": {
        "source": FWD_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:129",
        "replaces_fn": "_charted_kernel",
        "chart": "log"},
    "refine_charted_nn": {
        "source": FWD_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:145",
        "replaces_fn": "_charted_nn_kernel",
        "chart": "log_polar", "axis": 1},
    "refine_stationary_adjoint": {
        "source": ADJ_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:184",
        "replaces_fn": "_stationary_adjoint_kernel",
        "chart": "regular"},
    "refine_stationary_adjoint_nn": {
        "source": ADJ_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:204",
        "replaces_fn": "_stationary_adjoint_nn_kernel",
        "chart": "dust"},
    "refine_charted_adjoint": {
        "source": ADJ_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:220",
        "replaces_fn": "_charted_adjoint_kernel",
        "chart": "log"},
    "refine_charted_adjoint_nn": {
        "source": ADJ_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:242",
        "replaces_fn": "_charted_adjoint_nn_kernel",
        "chart": "log_polar"},
    "refine_nd_fused": {
        "source": "src/repro_torch/kernels/csrc/nd_fused.cu",
        "replaces": "src/repro/kernels/nd_fused.py:119",
        "replaces_fn": "_nd_fused_kernel",
        "chart": "dust"},
    "refine_pyramid": {
        "source": "src/repro_torch/kernels/csrc/pyramid.cu",
        "replaces": "src/repro/kernels/pyramid.py:150",
        "replaces_fn": "_pyramid_kernel",
        "chart": "regular"},
}
FORWARD = ("refine_stationary", "refine_charted", "refine_nd_fused")
NOISE_FREE = ("refine_stationary_nn", "refine_charted_nn")
PYRAMID = "refine_pyramid"
ADJOINT = tuple(k for k in KERNEL_INFO
                if k not in FORWARD + NOISE_FREE + (PYRAMID,))
# the kernels each training path must reach: regular (learned θ) through
# the pyramid's forward and its replay over the 1-D kernels; the charts
# the pyramid does not cover (dispatch.pyramid_cover: N-D and charted 1-D)
# through their per-level kernels and the adjoints, the learned-θ N-D
# paths through the nd-axes route
TRAIN_REACHES = {
    "dust": ("refine_nd_fused", "refine_charted_adjoint",
             "refine_stationary_adjoint_nn"),
    "regular": (PYRAMID, "refine_stationary", "refine_stationary_adjoint"),
    "log": ("refine_charted", "refine_charted_adjoint"),
    "log_polar": ("refine_nd_fused", "refine_charted_adjoint",
                  "refine_charted_adjoint_nn"),
    "dust_theta": ("refine_charted", "refine_stationary_nn",
                   "refine_charted_adjoint", "refine_stationary_adjoint_nn"),
    "log_polar_theta": ("refine_charted", "refine_charted_nn",
                        "refine_charted_adjoint",
                        "refine_charted_adjoint_nn"),
}
NOISE = 0.05                 # observation noise of the training data
OBS_FRAC = 0.3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def charts():
    from repro_torch import (galactic_dust_chart, log_chart, log_polar_chart,
                             matern32, regular_chart)

    return {
        "dust": (galactic_dust_chart((8, 16, 16), 3),
                 matern32.with_defaults(rho=0.5)),
        "regular": (regular_chart(1024, 10, boundary="reflect"),
                    matern32.with_defaults(rho=5000.0)),
        "log": (log_chart(1024, 8, n_csz=5, n_fsz=4, delta0=0.0197 / 16),
                matern32.with_defaults(rho=1.0)),
        "log_polar": (log_polar_chart((64, 64), 3),
                      matern32.with_defaults(rho=2.0)),
    }


def rel_err(got, ref) -> tuple:
    diff = float((got.float() - ref.float()).abs().max())
    return diff, diff / max(float(ref.float().abs().max()), 1e-30)


def level_inputs(icr, mats, lvl, dtype, gen):
    """Seeded coarse field and ξ of level `lvl`, plus its matrices."""
    import torch

    from repro_torch.core.refine import LevelGeom

    geom = LevelGeom.for_level(icr.chart, lvl)
    field = torch.randn((S,) + geom.coarse_shape, generator=gen,
                        device="cuda").to(dtype)
    xi = torch.randn((S,) + icr.xi_shapes()[lvl + 1], generator=gen,
                     device="cuda").to(dtype)
    axis_mats = ((mats["Rax"][lvl], mats["sqrtDax"][lvl])
                 if "Rax" in mats else None)
    r = mats["R"][lvl] if "R" in mats else None
    d = mats["sqrtD"][lvl] if "sqrtD" in mats else None
    return geom, field, xi, r, d, axis_mats


def adjoint_ops():
    """name -> (kernel wrapper, plain version) of the adjoint kernels."""
    from repro_torch.kernels import icr_refine as ir

    return {
        "refine_stationary_adjoint": (ir.refine_stationary_adjoint,
                                      ir.refine_stationary_adjoint_plain),
        "refine_stationary_adjoint_nn": (ir.refine_stationary_adjoint,
                                         ir.refine_stationary_adjoint_plain),
        "refine_charted_adjoint": (ir.refine_charted_adjoint,
                                   ir.refine_charted_adjoint_plain),
        "refine_charted_adjoint_nn": (ir.refine_charted_adjoint,
                                      ir.refine_charted_adjoint_plain),
    }


def adjoint_cases(icr, mats, lvl, dtype, gen):
    """Every adjoint launch of level `lvl`'s backward at S samples, with a
    seeded cotangent: ``[(kernel name, g, r, d or None, coarse_len)]``.
    1-D levels make one launch; N-D levels one on axis 0 with noise and one
    per trailing axis without, over the other axes' padded or fine
    extents (``nd_fused.refine_nd_fused_adjoint``)."""
    import torch

    from repro_torch.core.refine import LevelGeom
    from repro_torch.kernels import dispatch

    chart = icr.chart
    geom = LevelGeom.for_level(chart, lvl)
    fsz, csz, t = geom.n_fsz, geom.n_csz, geom.T
    padded = [n + 2 * geom.b if geom.boundary == "reflect" else n
              for n in geom.coarse_shape]
    if chart.ndim == 1:
        charted = (dispatch.route_for(geom) == dispatch.ROUTE_CHARTED_1D)
        lead = (t[0],) if charted else ()
        axes = [(charted, S, 0, mats["R"][lvl].reshape(lead + (fsz, csz)),
                 mats["sqrtD"][lvl].reshape(lead + (fsz, fsz)))]
    else:
        rs, ds = mats["Rax"][lvl], mats["sqrtDax"][lvl]
        fine = [n * fsz for n in t]
        axes = [(rs[0].ndim == 3, S * math.prod(fine[1:]), 0, rs[0], ds[0])]
        axes += [(rs[a].ndim == 3,
                  S * math.prod(padded[:a]) * math.prod(fine[a + 1:]), a,
                  rs[a], None) for a in range(1, chart.ndim)]
    out = []
    for charted, rows, a, r, d in axes:
        name = (("refine_charted_adjoint" if charted
                 else "refine_stationary_adjoint")
                + ("" if d is not None else "_nn"))
        g = torch.randn((rows, t[a] * fsz), generator=gen,
                        device="cuda").to(dtype)
        out.append((name, g, r.to(dtype).contiguous(),
                    None if d is None else d.to(dtype).contiguous(),
                    padded[a]))
    return out


def nn_cases(icr, mats, lvl, dtype, gen):
    """Every noise-free pass the nd-axes route makes on N-D level `lvl`
    (axes d-1..1, before axis 0's pass with noise) at S samples, with a
    seeded coarse input of that pass's shape: ``[(kernel name, coarse, r,
    families, axis)]``. The rows of axis a's pass are the samples times the
    other axes: coarse extents before a, fine extents after it."""
    import torch

    from repro_torch.core.refine import LevelGeom

    geom = LevelGeom.for_level(icr.chart, lvl)
    fsz, t = geom.n_fsz, geom.T
    b = geom.b if geom.boundary == "reflect" else 0
    out = []
    for a in range(icr.chart.ndim - 1, 0, -1):
        r = mats["Rax"][lvl][a].to(dtype).contiguous()
        rows = (S * math.prod(geom.coarse_shape[:a])
                * math.prod(n * fsz for n in t[a + 1:]))
        coarse = torch.randn((rows, geom.coarse_shape[a] + 2 * b),
                             generator=gen, device="cuda").to(dtype)
        name = "refine_charted_nn" if r.ndim == 3 else "refine_stationary_nn"
        out.append((name, coarse, r, t[a], a))
    return out


def nn_ops():
    """name -> (kernel wrapper, plain version) of the noise-free kernels,
    each called as f(coarse, r, families)."""
    from repro_torch.kernels import icr_refine as ir

    return {
        "refine_stationary_nn": (ir.refine_stationary_nn,
                                 ir.refine_stationary_nn_plain),
        "refine_charted_nn": (lambda c, r, t: ir.refine_charted_nn(c, r),
                              lambda c, r, t: ir.refine_charted_nn_plain(
                                  c, r)),
    }


def pyramid_case(icr, mats, dtype, gen, samples=S):
    """The pyramid's operands at the chart's residency prefix
    (``dispatch.pyramid_prefix``: the levels the kernel can take, whether
    or not ``pyramid_cover`` keeps them) for `samples` samples of `dtype`
    (seeded field and ξ): ``(geoms, field, levels)``, or None when the
    chart has no prefix."""
    import torch

    from repro_torch.core.icr import _pyramid_mats
    from repro_torch.core.refine import LevelGeom
    from repro_torch.kernels import dispatch, pyramid

    k = dispatch.pyramid_prefix(icr.chart, samples=samples,
                                itemsize=dtype.itemsize)
    if k is None:
        return None
    geoms = [LevelGeom.for_level(icr.chart, lvl) for lvl in range(k)]
    field = torch.randn((samples,) + geoms[0].coarse_shape, generator=gen,
                        device="cuda").to(dtype)
    xis = [torch.randn((samples,) + icr.xi_shapes()[lvl + 1], generator=gen,
                       device="cuda").to(dtype) for lvl in range(k)]
    pm = [_pyramid_mats(mats, g, lvl) for lvl, g in enumerate(geoms)]
    pm = [([r.to(dtype) for r in rs], [d.to(dtype) for d in ds])
          for rs, ds in pm]
    field, levels = pyramid.pyramid_operands(field, xis, pm, geoms,
                                             sample_axis=True)
    return geoms, field, levels


def plain_apply(icr, mats, xi):
    """``icr.apply_sqrt_batch`` with every kernel replaced by its plain
    version, on the same device (differentiable by plain autograd)."""
    import torch

    from repro_torch.core.refine import LevelGeom
    from repro_torch.kernels import dispatch

    pol = icr.policy if icr.dtype_policy is not None else None
    field = torch.matmul(xi[0], mats["sqrt0"].T).reshape(
        (xi[0].shape[0],) + icr.chart.shape0)
    if pol is not None:
        field = field.to(pol.storage_dtype)
    for lvl in range(icr.chart.n_levels):
        geom = LevelGeom.for_level(icr.chart, lvl)
        axis_mats = ((mats["Rax"][lvl], mats["sqrtDax"][lvl])
                     if "Rax" in mats else None)
        r = mats["R"][lvl] if "R" in mats else None
        d = mats["sqrtD"][lvl] if "sqrtD" in mats else None
        route, args = dispatch.level_operands(
            field, xi[lvl + 1], r, d, geom, axis_mats=axis_mats,
            sample_axis=True)
        field = dispatch.PLAIN[route](*args).reshape(
            (field.shape[0],) + tuple(geom.fine_shape))
    return field


def time_ms(fn, flush) -> float:
    """Median milliseconds of `fn` by CUDA events, L2 flushed before each
    repetition. The flush (a 2 GiB memset, ~0.64 ms on the card) also
    keeps the card busy while the host enqueues `fn`, so the events time
    the device work and not the host's launch overhead, unless `fn` takes
    the host longer than that to enqueue (``enqueue_ms``; the pyramid's
    wrapper takes 0.1-0.3 ms, more than a 512 MB memset hid)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def enqueue_ms(fn) -> float:
    """Median host milliseconds to enqueue `fn` on an idle card: where it
    is near `fn`'s device time, the card waits on the host."""
    import torch

    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def operand_bytes(route, args, out) -> int:
    """Bytes a kernel must move: each operand read once, the output
    written once."""
    tensors = [out, *args] if route != "nd-fused" else [
        out, *args[:4], *args[4]]
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_fmas(route, args) -> int:
    """Multiply-adds the function needs on these operands."""
    if route != "nd-fused":
        _, xi, r, _ = args
        n_fsz, n_csz = r.shape[-2:]
        return xi.numel() * (n_csz + n_fsz)
    field, xi0, r0, _, _, T = args
    fsz, csz = r0.shape[-2:]
    s = fsz // 2
    nd = field.ndim - 1
    ext = [(T[a] - 1) * s + csz for a in range(nd)]   # coarse rows read
    fmas = 0
    for a in range(nd - 1, 0, -1):                     # trailing stages
        n = field.shape[0] * csz
        for b in range(nd):
            n *= T[b] * fsz if b > a else (T[a] * fsz if b == a else ext[b])
        fmas += n
    return fmas + xi0.numel() * (csz + fsz)            # axis 0 + noise


def adjoint_cost(g, r, d, outs) -> tuple:
    """(bytes, multiply-adds) of one adjoint launch: g and the matrices
    read once, dcoarse (and dxi) written once; per family ``n_fsz·n_csz``
    multiply-adds for the overlap-add and ``n_fsz²`` for dxi."""
    n_fsz, n_csz = r.shape[-2:]
    moved = sum(t.numel() * t.element_size()
                for t in (g, r, *outs) + ((d,) if d is not None else ()))
    fam = g.numel() // n_fsz
    return moved, fam * (n_fsz * n_csz + (n_fsz * n_fsz if d is not None
                                          else 0))


WINDOW_EINSUM = ('torch.einsum("tfc,btc->btf", R, '
                 'coarse.unfold(1, n_csz, n_fsz//2))')


def window_einsum(coarse, r, t):
    """The charted window contraction as one PyTorch call over a strided
    view of the coarse rows: the charted kernels' library yardstick."""
    import torch

    n_fsz, n_csz = r.shape[-2:]
    win = coarse.unfold(1, n_csz, n_fsz // 2)[:, :t]
    return torch.einsum("tfc,btc->btf", r, win)


# per instance of the kernels the ``ptxas`` line reports: a pattern of its
# mangled name and how to name it from the pattern's groups (dtype, then
# the instance's template arguments)
_INSTANCES = (
    (r"((?:stationary|charted)(?:_adj)?)_kernelI(13__nv_bfloat16|f)Lb([01])E"
     r"Li(\d+)ELi(\d+)ELi(\d+)E", lambda kind, noise, f, c, nf: (
         kind, "noise" if noise == "1" else "nn", f, c, nf)),
    (r"(nd_fused)_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E",
     lambda kind, f, c: (kind, "", f, c, None)),
    (r"(pyramid)_kernelI(13__nv_bfloat16|f)Lb([01])ELi(\d+)ELi(\d+)E",
     lambda kind, nd, f, c: (kind, "nd" if nd == "1" else "1d", f, c, None)),
)
SM_REGISTERS = 65536         # 32-bit registers of an H100 SM
SM_SMEM = 233472             # shared memory of an H100 SM (228 KB)
BLOCK_SMEM_RESERVED = 1024   # shared memory the runtime keeps per block


def blocks_per_sm(registers: int, smem: int) -> int:
    """Resident blocks of 256 threads an H100 SM holds at `registers` per
    thread (allocated in units of 8 per thread, i.e. 256 per warp) and
    `smem` bytes of shared memory per block; at most 8 (2048 threads)."""
    by_regs = SM_REGISTERS // (-(-registers // 8) * 8 * 256)
    by_smem = SM_SMEM // (smem + BLOCK_SMEM_RESERVED) if smem else 8
    return min(8, by_regs, by_smem)


def ptxas_lines(smem=None,
                libs=("refine_1d", "refine_1d_adjoint", "nd_fused",
                      "pyramid")) -> dict:
    """Registers and spill bytes of the streaming 1-D instances, the N-D
    per-level instances and the pyramid's, from the ``-Xptxas -v`` report
    kept beside each built library; for the N-D and pyramid instances also
    the dynamic shared memory of their main-path launch (`smem`: kind ->
    bytes, at f32 and bf16 alike) and the blocks of 256 an SM holds."""
    import re

    from repro_torch.kernels import build

    smem = smem or {}
    out = {}
    for lib in libs:
        log = build.library_path(lib).with_suffix(".log").read_text()
        for entry, body in re.findall(
                r"Compiling entry function '(\S+)'.*?\n(.*?)(?=Compiling "
                r"entry function|\Z)", log, flags=re.S):
            for pattern, parts in _INSTANCES:
                inst = re.search(pattern, entry)
                if inst is not None:
                    break
            else:
                continue
            kind, dtype, *rest = inst.groups()
            kind, variant, f, c, nf = parts(kind, *rest)
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", body)
            stencil = (f"({f}, {c})" + (f" NF={nf}" if nf else "")
                       if f != "0" else "runtime-size")
            name = " ".join(x for x in (
                kind, "bf16" if "bf" in dtype else "f32", variant, stencil)
                if x)
            row = {"registers": int(regs.group(1)),
                   "spill_stores": int(spill.group(1)),
                   "spill_loads": int(spill.group(2))}
            key = f"{kind} {variant}".strip()
            if key in smem and f != "0":
                row["smem_bytes"] = smem[key]
                row["blocks_per_sm"] = blocks_per_sm(row["registers"],
                                                     smem[key])
            out[name] = row
    return out


def main_path_smem(models) -> dict:
    """Dynamic shared memory (bytes) of the N-D and pyramid launches at
    S=8: nd_fused at dust's last level, the pyramid at the dust prefix (its
    N-D instance); its 1-D levels stream without shared memory."""
    from repro_torch.core.refine import LevelGeom
    from repro_torch.kernels import dispatch, nd_fused

    def nd_smem(geom, charted):
        tile = nd_fused.nd_tile(tuple(geom.T), geom.n_csz, geom.n_fsz,
                                charted, S)
        return 4 * nd_fused._smem_floats(tile, tuple(geom.T), len(geom.T),
                                         geom.n_csz, geom.n_fsz, charted)

    dust = models["dust"][0].chart
    charted = tuple(not k for k in dust.invariant)
    k = dispatch.pyramid_prefix(dust, samples=S) or 1
    geoms = [LevelGeom.for_level(dust, lvl) for lvl in range(k)]
    return {"nd_fused": nd_smem(LevelGeom.for_level(dust, dust.n_levels - 1),
                                charted),
            "pyramid nd": max(nd_smem(g, charted) for g in geoms),
            "pyramid 1d": 0}


def bound(moved, fmas, bandwidth) -> tuple:
    t_bytes = moved / bandwidth * 1e3
    t_ops = 2 * fmas / F32_PEAK * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def max_rel(got, want) -> float:
    return max(rel_err(a, b)[1] for a, b in zip(got, want))


# -- phases ----------------------------------------------------------------------
def check_kernels(models, gen) -> dict:
    """Phase 2: every kernel against its plain version at every level."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.policy import cast_tree

    adj = adjoint_ops()
    errors = {k: {} for k in KERNEL_INFO}

    def record(kname, dname, absd, rel, where):
        worst = errors[kname].get(dname, (0.0, 0.0))
        errors[kname][dname] = (max(worst[0], absd), max(worst[1], rel))
        if not rel <= TOL[dname]:
            raise AssertionError(f"{kname} {where} {dname}: relative error "
                                 f"{rel:.3g} > {TOL[dname]}")

    from repro_torch.kernels import pyramid

    nn = nn_ops()
    for cname, (icr, mats, _) in models.items():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            m = cast_tree(mats, dtype)
            gen.manual_seed(1)
            case = pyramid_case(icr, m, dtype, gen)
            if case is not None:
                geoms, field, levels = case
                got = pyramid.refine_pyramid_core(field, geoms, levels)
                torch.cuda.synchronize()
                ref = pyramid.refine_pyramid_plain(field, geoms, levels)
                record(PYRAMID, dname, *rel_err(got, ref),
                       f"{cname} cover {len(geoms)}")
                if icr.chart.ndim == 1:
                    # a 1-D level runs its per-level kernel's body: the
                    # same sums, so the same bits
                    kern, args, _ = per_level_chain(field, geoms, levels)[-1]
                    if not torch.equal(got, kern(*args).reshape(got.shape)):
                        raise AssertionError(
                            f"{cname} {dname}: the pyramid differs from "
                            f"its per-level kernels")
            for lvl in range(icr.chart.n_levels):
                if icr.chart.ndim > 1:
                    for name, coarse, r, t, _ in nn_cases(icr, m, lvl,
                                                          dtype, gen):
                        kern, plain = nn[name]
                        got = kern(coarse, r, t)
                        torch.cuda.synchronize()
                        record(name, dname,
                               *rel_err(got, plain(coarse, r, t)),
                               f"{cname} level {lvl} rows {coarse.shape[0]}")
                geom, field, xi, r, d, axis_mats = level_inputs(
                    icr, m, lvl, dtype, gen)
                route, args = dispatch.level_operands(
                    field, xi, r, d, geom, axis_mats=axis_mats,
                    sample_axis=True)
                got = dispatch.KERNELS[route](*args)
                torch.cuda.synchronize()
                ref = dispatch.PLAIN[route](*args)
                record(dispatch.KERNEL_OF_ROUTE[route], dname,
                       *rel_err(got, ref), f"{cname} level {lvl}")
                for name, g, r1, d1, length in adjoint_cases(
                        icr, m, lvl, dtype, gen):
                    kern, plain = adj[name]
                    got = as_tuple(kern(g, r1, d1, coarse_len=length))
                    torch.cuda.synchronize()
                    want = as_tuple(plain(g, r1, d1, coarse_len=length))
                    absd = max(rel_err(a, b)[0] for a, b in zip(got, want))
                    record(name, dname, absd, max_rel(got, want),
                           f"{cname} level {lvl} g {tuple(g.shape)}")
    from repro_torch.kernels import icr_refine

    for dtype in (torch.float32, torch.bfloat16):
        gen.manual_seed(2)
        args = nd_axes_operands(models, dtype, gen)
        got = icr_refine.refine_charted(*args)
        torch.cuda.synchronize()
        record("refine_charted", str(dtype).split(".")[1],
               *rel_err(got, icr_refine.refine_charted_plain(*args)),
               f"dust nd-axes axis 0 rows {args[0].shape[0]}")
    missing = [k for k, v in errors.items() if not v]
    if missing:
        raise AssertionError(f"kernels never checked: {missing}")
    return errors


def check_path(models, gen) -> tuple:
    """Phase 3: sample_batch at both policies, twice per chart: with the
    pyramid (the default), which must launch once for its cover and the
    per-level kernel once for every other level, and with
    ``use_pyramid=False``, every level on its per-level kernel."""
    import torch

    from repro_torch import ICR
    from repro_torch.kernels import build, dispatch

    launches = {k: 0 for k in KERNEL_INFO}
    path_err, covers = {}, {}
    for cname, (icr0, _, _) in models.items():
        for pol in (None, "bf16"):
            for use_pyramid in (True, False):
                icr = ICR(icr0.chart, icr0.kernel, use_pallas=True,
                          dtype_policy=pol, use_pyramid=use_pyramid)
                build.LAUNCHES.clear()
                gen.manual_seed(7)
                out = icr.sample_batch(gen, S)
                torch.cuda.synchronize()
                counts = {k: build.LAUNCHES[k] for k in KERNEL_INFO}
                for k, n in counts.items():
                    launches[k] += n
                key = f"{cname}-{pol or 'fp32'}" + (
                    "" if use_pyramid else "-per-level")
                cover = (dispatch.pyramid_cover(
                    icr.chart, samples=S,
                    itemsize=icr.policy.storage_dtype.itemsize)
                    if use_pyramid else None) or 0
                if use_pyramid:
                    covers[key] = cover
                want = dispatch.plan(icr.chart)[0]["kernel"]
                expect = {want: icr.chart.n_levels - cover,
                          PYRAMID: int(cover > 0)}
                if {k: counts[k] for k in expect} != expect or sum(
                        counts.values()) != sum(expect.values()):
                    raise AssertionError(f"{key}: launches {counts}, "
                                         f"expected {expect}")
                gen.manual_seed(7)
                xi = icr.init_xi(gen, batch=S)
                ref = plain_apply(icr, icr.matrices(), xi)
                if (tuple(out.shape) != (S,) + icr.chart.final_shape
                        or not bool(torch.isfinite(out).all())):
                    raise AssertionError(f"{key}: bad output "
                                         f"{tuple(out.shape)}")
                _, rel = rel_err(out, ref)
                tol = TOL["float32" if pol is None else "bfloat16"]
                path_err[key] = rel
                if not rel <= tol:
                    raise AssertionError(f"{key}: whole path relative "
                                         f"error {rel:.3g} > {tol}")
    missing = [k for k in FORWARD + (PYRAMID,) if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    return launches, path_err, covers


# learned-θ paths: chart -> (ρ of the data, mean and std of ρ's lognormal
# prior); regular's are multiples of its point count
THETA_PATHS = {"regular": (0.04, 0.06, 0.03), "dust_theta": (0.5, 0.8, 0.4),
               "log_polar_theta": (2.0, 3.0, 1.5)}


# dρ through the kernels against the float64 witness: the float32 build
# of the level-0 square root rounds its eigenvalues near the clip by
# ~1e-7 ‖K‖, which its derivative 1/(2 sqrt λ) amplifies (0.38 % on a
# (6, 8, 8) dust chart on the CPU; PERF.md)
DRHO_F64_TOL = 1e-2


def train_problems(models, gen) -> dict:
    """Per path: the float32 ICR of the training path, its data
    (``charted_gp_dataset``), its likelihood, initial parameters, and its
    forward map through the kernels (``forward``) and, at fixed θ, through
    the plain versions (``plain_forward``). ``regular``, ``dust_theta`` and
    ``log_polar_theta`` learn (ξ, ρ) jointly under a lognormal prior on ρ,
    as ``examples/gp_regression_vi.py`` does: their forward rebuilds the
    matrices from θ (``ICR.__call__``); the N-D ones train through the
    pyramid's replay over the nd-axes route."""
    from repro_torch import (ICR, StandardizedModel, charted_gp_dataset,
                             gaussian_log_likelihood, lognormal_prior)

    out = {}
    paths = [(c, c) for c in models] + [("dust_theta", "dust"),
                                        ("log_polar_theta", "log_polar")]
    for pname, cname in paths:
        icr, mats, _ = models[cname]
        p = {}
        if pname in THETA_PATHS:
            scale = icr.chart.size if pname == "regular" else 1
            rho, mean, std = (scale * v for v in THETA_PATHS[pname])
            icr = ICR(icr.chart, icr.kernel.with_defaults(rho=rho),
                      use_pallas=True)
            priors = StandardizedModel({"rho": lognormal_prior(mean, std)})

            def joint(latent, icr=icr, priors=priors):
                theta = dict(priors(latent[1]))
                theta["sigma"] = 1.0
                return icr(latent[0], theta)

            # the example's lr (2e-2 at n0 = 64 level-0 points) at the
            # same step of the dominant level-0 mode: every one of the n0
            # coordinates of ξ0 reaches it through the symmetric root
            # V sqrt(Λ) Vᵀ, so Adam's per-coordinate step moves it by
            # lr·sqrt(n0)
            n0 = math.prod(icr.chart.shape(0))
            p.update(priors=priors, params=(icr.zero_xi(), priors.zero_xi()),
                     forward=joint, lr=2e-2 * math.sqrt(64 / n0))
        else:
            p.update(params=icr.zero_xi(), lr=3e-2,
                     forward=lambda xi, icr=icr, m=mats: icr.apply_sqrt(m, xi),
                     plain_forward=lambda xi, icr=icr, m=mats: plain_apply(
                         icr, m, [x[None] for x in xi])[0])
        gen.manual_seed(21)
        _, obs_idx, y = charted_gp_dataset(icr, gen, obs_frac=OBS_FRAC,
                                           noise_std=NOISE)
        p.update(icr=icr, mats=mats, y=y, obs_idx=obs_idx,
                 ll=gaussian_log_likelihood(NOISE, obs_idx))
        out[pname] = p
    return out


def theta_gradient(pname, p, point) -> dict:
    """A learned-θ path's joint (ξ, ρ) gradient at ξ = `point`, ρ's latent
    0.3: the matrices are built once from θ and the loss differentiated
    through the kernels and through the plain versions on the card. The
    ξ gradients are held at 1e-5 and the matrix cotangents (d sqrt0 and
    every level's dR, dsqrtD, or on N-D charts every per-axis factor's)
    at 1e-4: they are everything the kernel route contributes to dρ. dρ
    sums them through the square roots' backward, which weighs modes near
    the clip by up to 1/(2 sqrt(eps)), so dρ through the kernels is held
    against the plain versions' at 1e-3. The witness of dρ itself is the plain versions in float64 on the
    card, matrices built in float64 (``ICR.matrices(dtype=)``): dρ through
    the kernels is held against it at ``DRHO_F64_TOL``, the float32
    rounding of the level-0 eigenvalues near the clip (PERF.md). The plain
    versions in float32 on the CPU are reported beside them."""
    import torch

    from repro_torch import ICR, gaussian_log_likelihood, neg_log_joint
    from repro_torch.kernels.policy import tree_leaves

    def grads(icr, applies, obs_idx, y, point, dtype=torch.float32):
        rho = torch.tensor(0.3, device=icr.device, dtype=dtype,
                           requires_grad=True)
        theta = dict(p["priors"]({"rho": rho}))
        theta["sigma"] = 1.0
        mats = icr.matrices(theta, dtype=dtype)
        leaves = tree_leaves(mats)
        ll = gaussian_log_likelihood(NOISE, obs_idx)
        out = []
        for apply in applies:
            xi = _trainable([x.to(dtype) for x in point])
            loss = neg_log_joint(ll, lambda x: apply(mats, x))(
                xi, y.to(dtype))
            g = torch.autograd.grad(loss, xi + leaves + [rho],
                                    retain_graph=True)
            out.append((g[:len(xi)], g[len(xi):-1], float(g[-1])))
        return out

    icr = p["icr"]
    plain = [lambda m, xi, icr=icr: plain_apply(icr, m, [x[None]
                                                          for x in xi])[0]]
    (gx, gm, drho), (px, pm, prho) = grads(
        icr, [icr.apply_sqrt] + plain, p["obs_idx"], p["y"], point)
    ((_, _, wrho),) = grads(icr, plain, p["obs_idx"], p["y"], point,
                            dtype=torch.float64)
    cpu = ICR(icr.chart, icr.kernel, use_pallas=True, device="cpu")
    plain_cpu = [lambda m, xi: plain_apply(cpu, m, [x[None]
                                                     for x in xi])[0]]
    ((_, _, crho),) = grads(cpu, plain_cpu, p["obs_idx"].cpu(),
                            p["y"].cpu(), [x.cpu() for x in point])
    mat_err = max_rel(gm, pm)
    out = {"grad_xi_max_rel_err": max_rel(gx, px),
           "grad_mats_max_rel_err": mat_err,
           "drho": {"kernels": drho, "plain": prho, "plain_f64": wrho,
                    "plain_cpu": crho},
           "drho_rel_err": abs(drho - prho) / abs(prho),
           "drho_vs_f64_rel_err": abs(drho - wrho) / abs(wrho),
           "drho_plain_vs_f64_rel_err": abs(prho - wrho) / abs(wrho),
           "drho_plain_cpu_vs_f64_rel_err": abs(crho - wrho) / abs(wrho),
           "drho_plain_card_vs_cpu_rel": abs(prho - crho) / abs(crho)}
    print(f"{pname} θ-gradient: {json.dumps(out)}", file=sys.stderr)
    if not mat_err <= 1e-4:
        raise AssertionError(f"{pname}: matrix cotangent relative error "
                             f"{mat_err:.3g} > 1e-4")
    if not out["drho_rel_err"] <= 1e-3:
        raise AssertionError(f"{pname}: dρ through the kernels is "
                             f"{out['drho_rel_err']:.3g} > 1e-3 from the "
                             f"plain versions'")
    if not out["drho_vs_f64_rel_err"] <= DRHO_F64_TOL:
        raise AssertionError(f"{pname}: dρ through the kernels is "
                             f"{out['drho_vs_f64_rel_err']:.3g} > "
                             f"{DRHO_F64_TOL} from the float64 witness")
    return out


def _trainable(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().clone().requires_grad_(True)
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    return type(tree)(_trainable(v) for v in tree)


def check_train(problems, gen) -> tuple:
    """Phase 4: the training paths on the kernels, one step's gradient
    against the plain versions', and apply_sqrt_T against autograd (on
    the fixed-θ twin of each chart)."""
    import torch

    from repro_torch import ICR, advi_fit, map_fit, neg_log_joint
    from repro_torch.kernels import build

    launches = {k: 0 for k in KERNEL_INFO}
    report = {}
    for cname, p in problems.items():
        icr = p["icr"]
        build.LAUNCHES.clear()
        # a learned-θ forward rebuilds the matrices, whose eigh syncs
        # with the host: it cannot be captured, and runs op by op
        fit, losses = map_fit(p["ll"], p["forward"], p["params"], p["y"],
                              steps=20 if cname == "dust" else 10,
                              lr=p["lr"], jit=cname not in THETA_PATHS)
        entry = {"map_losses": [float(v) for v in losses]}
        if cname == "dust":
            _, elbos = advi_fit(
                gen, p["ll"],
                lambda xi, icr=icr, m=p["mats"]: icr.apply_sqrt_batch(m, xi),
                icr.zero_xi(), p["y"], steps=10, n_mc=2)
            entry["advi_elbos"] = [float(v) for v in elbos]
            if not (bool(torch.isfinite(elbos).all())
                    and float(elbos[-1]) > float(elbos[0])):
                raise AssertionError(f"dust ADVI: the ELBO did not rise: "
                                     f"{entry['advi_elbos']}")
        torch.cuda.synchronize()
        counts = {k: build.LAUNCHES[k] for k in KERNEL_INFO}
        entry["launches"] = counts
        if not (bool(torch.isfinite(losses).all())
                and float(losses[-1]) < float(losses[0])):
            raise AssertionError(f"{cname}: the MAP loss did not fall: "
                                 f"{entry['map_losses']}")
        if cname in THETA_PATHS:
            entry["rho_hat"] = float(p["priors"](fit[1])["rho"])
            if not torch.isfinite(torch.tensor(entry["rho_hat"])):
                raise AssertionError(f"{cname}: rho_hat {entry['rho_hat']}")
        silent = [k for k in TRAIN_REACHES[cname] if counts[k] == 0]
        if silent:
            raise AssertionError(f"{cname}: kernels never launched on the "
                                 f"training path: {silent}")
        for k in KERNEL_INFO:
            launches[k] += counts[k]

        # one step's gradient, through the kernels and the plain versions
        gen.manual_seed(23)
        point = [0.5 * x for x in icr.init_xi(gen)]
        if cname in THETA_PATHS:
            entry.update(theta_gradient(cname, p, point))
        else:
            grads = []
            for f in (p["forward"], p["plain_forward"]):
                params = _trainable(point)
                loss = neg_log_joint(p["ll"], f)(params, p["y"])
                grads.append(torch.autograd.grad(loss, params))
            entry["grad_xi_max_rel_err"] = max_rel(*grads)
        if not entry["grad_xi_max_rel_err"] <= TOL["float32"]:
            raise AssertionError(
                f"{cname}: ξ gradient relative error "
                f"{entry['grad_xi_max_rel_err']:.3g} > {TOL['float32']}")

        # the transpose on the kernels against autograd of the plain apply
        report[cname] = entry
        if cname.endswith("_theta"):
            continue
        entry["apply_sqrt_T_max_rel_err"] = {}
        for pol in (None, "bf16"):
            icr_p = ICR(icr.chart, icr.kernel, use_pallas=True,
                        dtype_policy=pol)
            m = icr_p.matrices()
            dt = icr_p.policy.storage_dtype
            gen.manual_seed(29)
            v = torch.randn((2,) + icr_p.out_shape, generator=gen,
                            device="cuda").to(dt)
            got = icr_p.apply_sqrt_T_batch(m, v)
            zero = [torch.zeros((2,) + s, dtype=dt, device="cuda",
                                requires_grad=True)
                    for s in icr_p.xi_shapes()]
            want = torch.autograd.grad(plain_apply(icr_p, m, zero), zero, v)
            err = max_rel(got, want)
            tol = TOL["float32" if pol is None else "bfloat16"]
            entry["apply_sqrt_T_max_rel_err"][pol or "fp32"] = err
            if not err <= tol:
                raise AssertionError(f"{cname} {pol}: apply_sqrt_T relative "
                                     f"error {err:.3g} > {tol}")
    return launches, report


GRAPH_FITS = ("dust", "log", "log_polar")   # the fixed-θ training paths
GRAPH_STEPS = 10


def same_bits(a, b) -> bool:
    """Every tensor of `a` equal to its counterpart in `b`, bit for bit."""
    import torch

    from repro_torch.kernels.policy import tree_leaves

    a, b = tree_leaves(a), tree_leaves(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def check_graphs(problems, models, gen) -> tuple:
    """Phase 4b: the compiled paths as CUDA graphs, each held bit for bit
    against the same code run op by op on the card: ``map_fit(jit=True)``
    against ``jit=False`` on dust, log and log_polar (losses and ξ̂, 10
    steps), the dust ADVI fit against its eager twin from the same
    generator state, ``apply_sqrt_T_batch`` (a replay of its cached graph)
    against its op-by-op chain on the four charts at S = 1 and 8 and both
    dtype policies (and against autograd of the plain apply at 1e-5 /
    5e-2), and ``map_fit(jit=True)`` on regular's learned-θ forward, which
    must raise and name ``jit=False``. Every capture checks that its
    kernel nodes equal its wrappers' launches; every graphed path must
    launch the kernels its chart reaches, the counters zeroed just before
    and read just after. Returns ``(launches, record)``."""
    import torch

    from repro_torch import ICR, advi_fit, map_fit
    from repro_torch.core import graphs
    from repro_torch.kernels import build

    launches = {k: 0 for k in KERNEL_INFO}

    def read(what, reaches):
        torch.cuda.synchronize()
        counts = {k: build.LAUNCHES[k] for k in KERNEL_INFO}
        silent = [k for k in reaches if counts[k] == 0]
        if silent:
            raise AssertionError(f"graphs {what}: kernels never launched: "
                                 f"{silent}")
        for k, n in counts.items():
            launches[k] += n
        return counts

    record = {"fits": {}, "apply_sqrt_T": {}}
    for cname in GRAPH_FITS:
        p = problems[cname]
        args = (p["ll"], p["forward"], p["params"], p["y"])
        build.LAUNCHES.clear()
        fit_g, loss_g = map_fit(*args, steps=GRAPH_STEPS, lr=p["lr"])
        counts = read(f"{cname} map_fit", TRAIN_REACHES[cname])
        fit_e, loss_e = map_fit(*args, steps=GRAPH_STEPS, lr=p["lr"],
                                jit=False)
        entry = {"losses_equal": same_bits(loss_g, loss_e),
                 "xi_equal": same_bits(fit_g, fit_e),
                 "launches": counts}
        if cname == "dust":
            icr, m = p["icr"], p["mats"]

            def fwd(xi, icr=icr, m=m):
                return icr.apply_sqrt_batch(m, xi)

            gen.manual_seed(41)
            build.LAUNCHES.clear()
            q_g, elbo_g = advi_fit(gen, p["ll"], fwd, icr.zero_xi(), p["y"],
                                   steps=GRAPH_STEPS)
            read("dust advi_fit", TRAIN_REACHES[cname])
            gen.manual_seed(41)
            with graphs.eager():
                q_e, elbo_e = advi_fit(gen, p["ll"], fwd, icr.zero_xi(),
                                       p["y"], steps=GRAPH_STEPS)
            entry.update(advi_elbos_equal=same_bits(elbo_g, elbo_e),
                         advi_params_equal=same_bits(q_g, q_e))
        record["fits"][cname] = entry
        if not all(v for k, v in entry.items() if k != "launches"):
            raise AssertionError(f"graphs {cname}: the graphed fit differs "
                                 f"from the eager one: {entry}")

    for cname, (icr0, _, _) in models.items():
        for pol in (None, "bf16"):
            icr = ICR(icr0.chart, icr0.kernel, use_pallas=True,
                      dtype_policy=pol)
            m = icr.matrices()
            dt = icr.policy.storage_dtype
            tol = TOL["float32" if pol is None else "bfloat16"]
            for n_s in (1, S):
                gen.manual_seed(43)
                v = torch.randn((n_s,) + icr.out_shape, generator=gen,
                                device="cuda").to(dt)
                build.LAUNCHES.clear()
                first = icr.apply_sqrt_T_batch(m, v)    # captures
                again = icr.apply_sqrt_T_batch(m, v)    # replays
                read(f"{cname} apply_sqrt_T", ())
                want = icr.apply_sqrt_T_batch(m, v, cached=False)
                zero = [torch.zeros((n_s,) + s, dtype=dt, device="cuda",
                                    requires_grad=True)
                        for s in icr.xi_shapes()]
                plain = torch.autograd.grad(plain_apply(icr, m, zero), zero,
                                            v)
                entry = {"equal": same_bits(first, want)
                         and same_bits(again, want),
                         "graphs": len(icr._sqrt_T_graphs),
                         "plain_max_rel_err": max_rel(first, plain)}
                record["apply_sqrt_T"][f"{cname}-{pol or 'fp32'}-S{n_s}"] = \
                    entry
                if not (entry["equal"]
                        and entry["plain_max_rel_err"] <= tol):
                    raise AssertionError(f"graphs {cname} {pol} S={n_s}: "
                                         f"apply_sqrt_T {entry}")
            del icr, m

    # a learned-θ forward syncs with the host (eigh): the capture raises
    p = problems["regular"]
    try:
        map_fit(p["ll"], p["forward"], p["params"], p["y"], steps=2,
                lr=p["lr"])
    except RuntimeError as exc:
        record["learned_theta_raises"] = str(exc)[:240]
        if "jit=False" not in str(exc) or "ROADMAP" not in str(exc):
            raise AssertionError(f"graphs: the learned-θ capture raised "
                                 f"without naming jit=False: {exc}")
    else:
        raise AssertionError("graphs: map_fit(jit=True) on a learned-θ "
                             "forward did not raise")
    torch.cuda.synchronize()
    record["launches"] = launches
    return launches, record


def per_level_chain(field, geoms, levels) -> list:
    """The per-level kernels the pyramid replaces, on its operands: per
    level ``(kernel wrapper, its operands, route)``, each level's coarse
    input the previous level's kernel output, reflect-padded."""
    from repro_torch.core.refine import reflect_pad
    from repro_torch.kernels import dispatch

    chain, x = [], field
    n_s = field.shape[0]
    for geom, (xi0, rs, d0) in zip(geoms, levels):
        nd = len(geom.coarse_shape)
        if geom.boundary == "reflect":
            x = reflect_pad(x, geom.b, nd)
        if nd == 1:
            route = (dispatch.ROUTE_CHARTED_1D if rs[0].ndim == 3
                     else dispatch.ROUTE_STATIONARY_1D)
            args = (x.contiguous(), xi0.reshape(n_s, geom.T[0], geom.n_fsz),
                    rs[0], d0)
        else:
            route = dispatch.ROUTE_ND_FUSED
            args = (x.contiguous(), xi0, rs[0], d0, tuple(rs[1:]),
                    tuple(geom.T))
        kern = dispatch.KERNELS[route]
        x = kern(*args).reshape((n_s,) + tuple(geom.fine_shape))
        chain.append((kern, args, route))
    return chain


def kernel_times(models, bandwidth, flush, gen) -> dict:
    """Per kernel at the largest level of its chart (the noise-free passes
    at their axis; the pyramid at regular's cover, the one ``ICR`` runs),
    float32 and bfloat16 storage: kernel, plain version and library call
    times, and the bound. The pyramid has no library call; beside it stand
    the per-level kernels it replaces, timed one by one on the same
    operands, and (``dust_prefix``) its time at the dust prefix."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.policy import cast_tree

    adj = adjoint_ops()
    out = {}
    for kname, info in KERNEL_INFO.items():
        icr, mats, _ = models[info["chart"]]
        lvl = icr.chart.n_levels - 1
        per_dtype = {}
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            m = cast_tree(mats, dtype)
            gen.manual_seed(3)
            library_ms = library_call = None
            if kname in FORWARD:
                geom, field, xi, r, d, axis_mats = level_inputs(
                    icr, m, lvl, dtype, gen)
                route, args = dispatch.level_operands(
                    field, xi, r, d, geom, axis_mats=axis_mats,
                    sample_axis=True)
                kern, plain = dispatch.KERNELS[route], dispatch.PLAIN[route]
                ms = time_ms(lambda: kern(*args), flush)
                plain_ms = time_ms(lambda: plain(*args), flush)
                if route == "stationary-1d":
                    coarse, _, r1, _ = args
                    c3, w = coarse[:, None, :], r1[:, None, :]
                    library_call = ("F.conv1d(coarse, R, stride=n_fsz//2): "
                                    "the window contraction without the "
                                    "noise term")
                    library_ms = time_ms(lambda: torch.nn.functional.conv1d(
                        c3, w, stride=geom.n_fsz // 2), flush)
                elif route == "charted-1d":
                    coarse, xi1, r1, _ = args
                    library_call = (f"{WINDOW_EINSUM}: the window "
                                    "contraction without the noise term")
                    library_ms = time_ms(lambda: window_einsum(
                        coarse, r1, xi1.shape[1]), flush)
                moved = operand_bytes(route, args, kern(*args))
                fmas = kernel_fmas(route, args)
                enq = enqueue_ms(lambda: kern(*args))
                shape = {"coarse": list(field.shape),
                         "fine": [S] + list(geom.fine_shape)}
                if kname == "refine_charted":
                    shape["nd_axes"] = nd_axes_time(models, dtype, gen,
                                                    bandwidth, flush)
            elif kname in NOISE_FREE:
                (_, coarse, r, t, a), = [
                    c for c in nn_cases(icr, m, lvl, dtype, gen)
                    if c[4] == info["axis"]]
                kern, plain = nn_ops()[kname]
                ms = time_ms(lambda: kern(coarse, r, t), flush)
                plain_ms = time_ms(lambda: plain(coarse, r, t), flush)
                if kname == "refine_stationary_nn":
                    c3, w = coarse[:, None, :], r[:, None, :].contiguous()
                    library_call = ("F.conv1d(coarse, R, stride=n_fsz//2): "
                                    "the same function in channel-major "
                                    "layout")
                    library_ms = time_ms(lambda: torch.nn.functional.conv1d(
                        c3, w, stride=r.shape[-2] // 2), flush)
                else:
                    library_call = (f"{WINDOW_EINSUM}: the same function "
                                    "over a view")
                    library_ms = time_ms(
                        lambda: window_einsum(coarse, r, t), flush)
                fine = kern(coarse, r, t)
                moved = sum(x.numel() * x.element_size()
                            for x in (coarse, r, fine))
                fmas = fine.numel() * r.shape[-1]
                enq = enqueue_ms(lambda: kern(coarse, r, t))
                shape = {"coarse": list(coarse.shape),
                         "fine": list(fine.shape), "level": lvl, "axis": a}
            elif kname == PYRAMID:
                cover = dispatch.pyramid_cover(icr.chart, samples=S,
                                               itemsize=dtype.itemsize)
                ms, plain_ms, moved, fmas, enq, shape = pyramid_time(
                    icr, m, dtype, gen, flush)
                if shape["levels"] != cover:
                    raise AssertionError(
                        f"{kname} timed at {shape['levels']} levels, "
                        f"ICR covers {cover}")
                shape["dust_prefix"] = pyramid_prefix_time(
                    models, dtype, gen, bandwidth, flush)
            else:
                cases = [c for c in adjoint_cases(icr, m, lvl, dtype, gen)
                         if c[0] == kname]
                _, g, r, d, length = max(cases, key=lambda c: c[1].numel())
                kern, plain = adj[kname]
                ms = time_ms(lambda: kern(g, r, d, coarse_len=length), flush)
                plain_ms = time_ms(lambda: plain(g, r, d, coarse_len=length),
                                   flush)
                if kname.startswith("refine_stationary"):
                    n_fsz = r.shape[-2]
                    gc = g.reshape(g.shape[0], -1, n_fsz).transpose(1, 2)
                    gc, w = gc.contiguous(), r[:, None, :].contiguous()
                    library_call = (
                        "F.conv_transpose1d(g, R, stride=n_fsz//2) on g in "
                        "channel-major layout: the overlap-add without dxi")
                    library_ms = time_ms(
                        lambda: torch.nn.functional.conv_transpose1d(
                            gc, w, stride=n_fsz // 2), flush)
                outs = as_tuple(kern(g, r, d, coarse_len=length))
                moved, fmas = adjoint_cost(g, r, d, outs)
                enq = enqueue_ms(lambda: kern(g, r, d, coarse_len=length))
                shape = {"g": list(g.shape), "coarse_len": length}
                if kname == "refine_charted_adjoint":
                    shape["nd_backward"] = nd_backward_time(
                        models, dtype, gen, bandwidth, flush)
            bound_ms, bound_by = bound(moved, fmas, bandwidth)
            per_dtype[dname] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "copy_ms": copy_ms(moved, flush),
                "enqueue_ms": enq, "library_call": library_call,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
                "level": lvl, "shape": shape}
        out[kname] = per_dtype
    return out


def nd_axes_operands(models, dtype, gen) -> tuple:
    """The other shape of #3's launches: the axis-0 pass (with ξ0) of the
    nd-axes route at dust's last level, as a learned-θ training step (S=1)
    launches it, very many short rows: ``(coarse, xi, r, d)``."""
    import torch

    from repro_torch.core.refine import LevelGeom
    from repro_torch.kernels.policy import cast_tree

    icr, mats, _ = models["dust"]
    lvl = icr.chart.n_levels - 1
    geom = LevelGeom.for_level(icr.chart, lvl)
    fsz, t = geom.n_fsz, geom.T
    b = geom.b if geom.boundary == "reflect" else 0
    rows = math.prod(n * fsz for n in t[1:])
    r = cast_tree(mats["Rax"][lvl][0], dtype).contiguous()
    d = cast_tree(mats["sqrtDax"][lvl][0], dtype).contiguous()
    coarse = torch.randn((rows, geom.coarse_shape[0] + 2 * b), generator=gen,
                         device="cuda").to(dtype)
    xi = torch.randn((rows, t[0], fsz), generator=gen,
                     device="cuda").to(dtype)
    return coarse, xi, r, d


def nd_axes_time(models, dtype, gen, bandwidth, flush) -> dict:
    """#3 at the nd-axes route's axis-0 shape (``nd_axes_operands``)."""
    from repro_torch.kernels import icr_refine as ir

    args = nd_axes_operands(models, dtype, gen)
    ms = time_ms(lambda: ir.refine_charted(*args), flush)
    moved = operand_bytes("charted-1d", args, ir.refine_charted(*args))
    bound_ms, bound_by = bound(moved, kernel_fmas("charted-1d", args),
                               bandwidth)
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": moved, "copy_ms": copy_ms(moved, flush),
            "coarse": list(args[0].shape), "xi": list(args[1].shape),
            "chart": "dust", "level": models["dust"][0].chart.n_levels - 1,
            "axis": 0, "samples": 1}


def nd_backward_time(models, dtype, gen, bandwidth, flush) -> dict:
    """#7 at the other shape of its launches: the axis-0 pass (with dxi)
    of the N-D backward at dust's last level, very many short rows."""
    import torch

    from repro_torch.kernels import icr_refine as ir
    from repro_torch.kernels.policy import cast_tree

    icr, mats, _ = models["dust"]
    lvl = icr.chart.n_levels - 1
    m = cast_tree(mats, dtype)
    (_, g, r, d, length), = [
        c for c in adjoint_cases(icr, m, lvl, dtype, gen)
        if c[0] == "refine_charted_adjoint"]
    ms = time_ms(lambda: ir.refine_charted_adjoint(g, r, d,
                                                   coarse_len=length), flush)
    outs = ir.refine_charted_adjoint(g, r, d, coarse_len=length)
    moved, fmas = adjoint_cost(g, r, d, outs)
    bound_ms, bound_by = bound(moved, fmas, bandwidth)
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": moved, "copy_ms": copy_ms(moved, flush),
            "g": list(g.shape), "coarse_len": length, "chart": "dust",
            "level": lvl, "axis": 0}


def pyramid_time(icr, mats, dtype, gen, flush) -> tuple:
    """#10 at `icr`'s residency prefix (S=8): ``(ms, plain_ms, bytes,
    fmas, enqueue_ms, shape)``, the shape holding the per-level kernels it
    replaces, each timed alone on the same operands (its yardstick)."""
    from repro_torch.kernels import pyramid

    geoms, field, levels = pyramid_case(icr, mats, dtype, gen)
    ms = time_ms(lambda: pyramid.refine_pyramid_core(field, geoms, levels),
                 flush)
    grid = pyramid.last_grid
    plain_ms = time_ms(lambda: pyramid.refine_pyramid_plain(
        field, geoms, levels), flush)
    chain = per_level_chain(field, geoms, levels)
    chain_ms = [time_ms(lambda k=k, a=a: k(*a), flush) for k, a, _ in chain]
    fine = pyramid.refine_pyramid_core(field, geoms, levels)
    moved = sum(x.numel() * x.element_size() for x in (
        field, fine, *(t for xi0, rs, d0 in levels for t in (xi0, *rs, d0))))
    fmas = sum(kernel_fmas(route, a) for _, a, route in chain)
    enq = enqueue_ms(lambda: pyramid.refine_pyramid_core(field, geoms,
                                                         levels))
    shape = {"coarse": list(field.shape), "fine": list(fine.shape),
             "levels": len(geoms), "grid_blocks": grid,
             "per_level_kernels_ms": chain_ms,
             "per_level_kernels_sum_ms": sum(chain_ms)}
    return ms, plain_ms, moved, fmas, enq, shape


def pyramid_prefix_time(models, dtype, gen, bandwidth, flush) -> dict:
    """#10 at the dust prefix, which ``pyramid_cover`` declines (ICR runs
    the per-level kernels there), with its bound and copy time."""
    from repro_torch.kernels.policy import cast_tree

    icr, mats, _ = models["dust"]
    ms, _, moved, fmas, _, shape = pyramid_time(
        icr, cast_tree(mats, dtype), dtype, gen, flush)
    bound_ms, bound_by = bound(moved, fmas, bandwidth)
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": moved, "copy_ms": copy_ms(moved, flush),
            "chart": "dust", **shape}


def copy_ms(moved, flush) -> float:
    """A device copy of `moved` bytes (half read, half written)."""
    import torch

    src = torch.empty(moved // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return time_ms(lambda: dst.copy_(src), flush)


def pyramid_covers(models, flush, gen) -> dict:
    """Per chart and storage dtype, the pyramid at its residency prefix
    (S=8) against the per-level kernels it replaces, each timed alone on
    the same operands: the pyramid's yardstick, since no PyTorch call
    computes it. ``kept``: whether ``dispatch.pyramid_cover`` takes the
    prefix (``ICR`` runs the pyramid there); ``faster``: whether the
    pyramid beat the per-level kernels summed in this run."""
    import torch

    from repro_torch.kernels import dispatch, pyramid
    from repro_torch.kernels.policy import cast_tree

    out = {}
    for cname, (icr, mats, _) in models.items():
        for dtype in (torch.float32, torch.bfloat16):
            gen.manual_seed(13)
            geoms, field, levels = pyramid_case(
                icr, cast_tree(mats, dtype), dtype, gen)
            ms = time_ms(lambda: pyramid.refine_pyramid_core(
                field, geoms, levels), flush)
            chain = [time_ms(lambda k=k, a=a: k(*a), flush)
                     for k, a, _ in per_level_chain(field, geoms, levels)]
            out[f"{cname}-{str(dtype).split('.')[1]}"] = {
                "cover": len(geoms), "levels": icr.chart.n_levels,
                "kept": dispatch.pyramid_cover(
                    icr.chart, samples=S, itemsize=dtype.itemsize)
                is not None,
                "ms": ms, "faster": ms < sum(chain),
                "grid_blocks": pyramid.last_grid,
                "per_level_kernels_ms": chain,
                "per_level_kernels_sum_ms": sum(chain)}
    return out


def level_split(models, flush, gen) -> dict:
    """Per level of each chart at float32: the torch glue before a forward
    launch against the kernel, and a level's whole transpose
    (``dispatch.refine_T``: adjoint kernels, movedim copies and the
    transposed glue) against its adjoint kernels alone."""
    import torch

    from repro_torch.kernels import dispatch

    adj = adjoint_ops()
    split = {}
    for cname, (icr, mats, _) in models.items():
        gen.manual_seed(5)
        rows = []
        for lvl in range(icr.chart.n_levels):
            geom, field, xi, r, d, axis_mats = level_inputs(
                icr, mats, lvl, torch.float32, gen)

            def glue():
                return dispatch.level_operands(
                    field, xi, r, d, geom, axis_mats=axis_mats,
                    sample_axis=True)

            route, args = glue()
            kern = dispatch.KERNELS[route]
            g = torch.randn((S,) + tuple(geom.fine_shape), generator=gen,
                            device="cuda")
            bwd_ms = time_ms(lambda: dispatch.refine_T(
                g, r, d, geom, axis_mats=axis_mats), flush)
            adj_ms = sum(
                time_ms(lambda c=c: adj[c[0]][0](c[1], c[2], c[3],
                                                 coarse_len=c[4]), flush)
                for c in adjoint_cases(icr, mats, lvl, torch.float32, gen))
            rows.append({"level": lvl, "glue_ms": time_ms(glue, flush),
                         "kernel_ms": time_ms(lambda: kern(*args), flush),
                         "bwd_ms": bwd_ms, "adjoint_kernel_ms": adj_ms,
                         "bwd_glue_ms": bwd_ms - adj_ms})
        split[cname] = rows
    return split


def train_step_times(problems, flush) -> dict:
    """One float32 fit step per chart (``core/vi._fit_step``: the loss,
    the backward through the kernels, AdamW in place, the loss into its
    buffer), op by op: CUDA-event milliseconds and host enqueue, and
    where they go: the loss alone (forward, recording the graph), the
    update alone, and the backward as the rest; and on the fixed-θ paths
    the same step as one replay of its captured CUDA graph (``graph_*``;
    null where θ is learned: that step cannot be captured)."""
    import torch

    from repro_torch import neg_log_joint
    from repro_torch.core import graphs, vi
    from repro_torch.kernels.policy import tree_leaves
    from repro_torch.optim import adamw, linear_warmup_cosine

    out = {}
    for cname, p in problems.items():
        loss_fn = neg_log_joint(p["ll"], p["forward"])

        def fit_step(loss_fn=loss_fn, y=p["y"]):
            params = _trainable(p["params"])
            # far more steps than any timing runs: the loss buffer's index
            # stays in range
            step, _ = vi._fit_step(lambda q: loss_fn(q, y), params, 10_000,
                                   p["lr"])
            return params, step

        params, step = fit_step()
        leaves = tree_leaves(params)
        opt = adamw(linear_warmup_cosine(p["lr"], 2, 20))

        def loss(params=params, loss_fn=loss_fn, y=p["y"]):
            return loss_fn(params, y)

        grads = torch.autograd.grad(loss(), leaves)
        step_ms, loss_ms = time_ms(step, flush), time_ms(loss, flush)
        update_ms = time_ms(lambda: opt.update(grads, leaves), flush)
        entry = {"train_step_ms": step_ms,
                 "train_step_enqueue_ms": enqueue_ms(step),
                 "loss_ms": loss_ms, "update_ms": update_ms,
                 "backward_ms": step_ms - loss_ms - update_ms,
                 "graph_step_ms": None, "graph_step_enqueue_ms": None,
                 "points": p["icr"].chart.size,
                 "learns_theta": cname in THETA_PATHS}
        if cname not in THETA_PATHS:
            _, gstep = fit_step()
            replay = graphs.capture(gstep, device="cuda")
            entry.update(graph_step_ms=time_ms(replay, flush),
                         graph_step_enqueue_ms=enqueue_ms(replay),
                         graph_kernel_nodes=sum(replay.launches.values()))
            del replay
        out[cname] = entry
    return out


def draw_floor_bytes(entry, storage) -> int:
    """The least bytes a slab's draw must move, each input read once and
    each output written once: the q-parameters (mean, std: float32 over
    the excitation), the client ξ rows of the rows flagged in the entry's
    buffers, and every row's excitation written at the storage dtype. The
    hash and Box-Muller are arithmetic on counters and move nothing."""
    import torch

    n_xi, cap = sum(entry["sizes"]), entry["capacity"]
    flagged = int(entry["bufs"]["meta"][2].count_nonzero())
    width = torch.finfo(storage).bits // 8
    return 4 * n_xi * (2 + flagged) + width * n_xi * cap


def serve_case(cname, chart, rho, pol, flush, bandwidth, card) -> tuple:
    """Phase 5 on one chart and dtype policy: ``GPFieldServer(
    demo_posterior(...), slab=8)`` serves ``mixed_requests(3, 16)`` cold,
    then warm, with the launch counters zeroed just before and read just
    after; then the checks and times of the ``serve`` line. Returns
    ``(launches, record)``."""
    import numpy as np
    import torch

    from repro_torch.kernels import build, dispatch
    from repro_torch.launch import serve_gp as sg

    key = f"{cname}-{pol or 'fp32'}"
    post = sg.demo_posterior(chart, rho, dtype_policy=pol)
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    srv = sg.GPFieldServer(post, slab=S)
    cold_reqs = srv.run(sg.mixed_requests(3, 16))
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    mats_stats = dict(post.icr.matrices_cache_stats)
    plan_stats = dict(dispatch.plan_cache_stats)
    rows0, slabs0 = srv.rows_served, srv.slabs_run
    t0 = time.perf_counter()
    warm_reqs = srv.run(sg.mixed_requests(3, 16))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = {k: build.LAUNCHES[k] for k in KERNEL_INFO}
    m = srv.metrics()

    # 2. warm traffic: no new graph, no matrices, no plan
    if (m["graph_captures"] != m["cached_entries"] or m["graph_captures"]
            != 1 or m["mode"] != "single:cuda-graph"):
        raise AssertionError(f"serve {key}: captures {m}")
    if (dict(post.icr.matrices_cache_stats) != mats_stats
            or dict(dispatch.plan_cache_stats) != plan_stats):
        raise AssertionError(f"serve {key}: warm traffic rebuilt matrices "
                             f"or the plan")
    want = collections.Counter()
    for lvl in srv._entry["plan"]:
        want[lvl["kernel"]] += lvl["launches"]
    want = +want
    nodes = srv._entry["fn"].launches   # the graph's kernel nodes
    # each slab attempt replays the graph once; the capture's eager
    # warm-up launched every node's kernel once more
    runs = m["slabs_attempted"] + m["graph_captures"]
    if not want or nodes != want or {k: n for k, n in launches.items()
                                     if n} != {k: n * runs
                                               for k, n in nodes.items()}:
        raise AssertionError(f"serve {key}: launches {launches}, graph "
                             f"nodes {dict(nodes)}, the plan runs "
                             f"{dict(want)}")
    # 4. finite fields, positive moments std
    for r in cold_reqs + warm_reqs:
        if not r.done or r.error:
            raise AssertionError(f"serve {key}: request failed: {r.error}")
        arrays = r.fields if r.kind == "sample" else [r.mean, r.std]
        if not all(np.isfinite(a).all() for a in arrays) or (
                r.kind == "moments" and not (r.std > 0).all()):
            raise AssertionError(f"serve {key}: non-finite field or "
                                 f"non-positive std ({r.kind})")

    # 1. the graph's slab equals the eager kernel route bit for bit, and
    # the eager route its plain version (the buffers hold the last slab)
    e = srv._entry
    graph_out = e["fn"]().clone()
    xi = e["draw"](*e["args"])
    eager = post.icr.apply_sqrt_batch(e["mats"], xi).float()
    if not torch.equal(graph_out, eager):
        raise AssertionError(f"serve {key}: graph and eager slabs differ by "
                             f"{rel_err(graph_out, eager)[0]:.3g}")
    _, rel_plain = rel_err(eager, plain_apply(post.icr, e["mats"], xi))
    tol = TOL["float32" if pol is None else "bfloat16"]
    if not rel_plain <= tol:
        raise AssertionError(f"serve {key}: eager slab against the plain "
                             f"versions {rel_plain:.3g} > {tol}")
    # 3. the card's integer noise stream equals the CPU's
    if pol is None:
        seeds, rows = e["bufs"]["meta"][0], e["bufs"]["meta"][1]
        counters = sg.noise_counters(sum(e["sizes"]), "cuda")
        bits = sg.row_noise_bits(seeds, rows, counters).cpu()
        if not torch.equal(bits, sg.row_noise_bits(
                seeds.cpu(), rows.cpu(), counters.cpu())):
            raise AssertionError(f"serve {key}: card and CPU noise streams "
                                 "differ")
        del bits, counters

    # times (CUDA events after the 2 GiB flush; host clock for enqueue)
    out = e["fn"]()
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    args = e["args"]
    moved = srv.modeled_slab_bytes()
    drawn = draw_floor_bytes(e, post.icr.policy.storage_dtype)
    cast = (0 if post.icr.policy.storage_dtype == torch.float32 else
            out.numel() * (torch.finfo(post.icr.policy.storage_dtype).bits
                           // 8 + out.element_size()))
    batch = out.cpu().numpy()      # one slab's fields on the host
    state = sg._welford_merge(0, None, None, batch)
    welford = []
    for _ in range(REPS // 5):
        t0 = time.perf_counter()
        sg._welford_merge(*state, batch)
        welford.append((time.perf_counter() - t0) * 1e3)
    record = {
        "slab_graph_ms": time_ms(e["fn"], flush),
        "slab_eager_ms": time_ms(lambda: e["slab_fn"](*args), flush),
        "host_graph_ms": enqueue_ms(e["fn"]),
        "host_eager_ms": enqueue_ms(lambda: e["slab_fn"](*args)),
        "draw_ms": time_ms(lambda: e["draw"](*args), flush),
        "d2h_ms": time_ms(lambda: host.copy_(out, non_blocking=True), flush),
        "welford_ms": statistics.median(welford),
        "cold_ms": cold_ms, "warm_ms": warm_s * 1e3,
        "rows_per_s": (srv.rows_served - rows0) / warm_s,
        "slabs_warm": m["slabs_run"] - slabs0, "route": srv.route,
        "modeled_slab_bytes": moved,
        "bound_ms": moved / bandwidth * 1e3,
        "draw_floor_bytes": drawn,
        "draw_bound_ms": drawn / bandwidth * 1e3,
        "cast_bytes": cast,
        "slab_bound_ms": (moved + drawn + cast) / bandwidth * 1e3,
        "field_bytes": out.numel() * out.element_size(),
        "graph_kernel_nodes": dict(nodes),
        "eager_vs_plain_rel": rel_plain,
        "cache": {k: m[k] for k in ("cache_hits", "cache_misses",
                                    "graph_captures")},
        "card": card}
    del srv, e, out, host, xi, eager, graph_out, batch, state
    torch.cuda.empty_cache()
    return launches, record


def check_serve(flush, bandwidth, card) -> tuple:
    """Phase 5: the server on the four charts at both dtype policies."""
    launches = {k: 0 for k in KERNEL_INFO}
    records = {}
    for cname, (chart, kernel) in charts().items():
        for pol in (None, "bf16"):
            counts, rec = serve_case(cname, chart,
                                     kernel.default_theta["rho"], pol,
                                     flush, bandwidth, card)
            for k, n in counts.items():
                launches[k] += n
            records[f"{cname}-{pol or 'fp32'}"] = rec
    return launches, records


# the condition phase: the entry-point solve's on-grid observations (the
# dense rung's dense_max, so the whole ladder is available), its noise (the
# CG example's default), the matvec batch timed beside k = 1 (the mean and
# 16 Matheron columns of a served request), and the charts served
COND_OBS = 4096
COND_NOISE = 0.25
COND_K = 17
COND_SERVED = ("dust", "regular")
# the served and the entry point's mean fields against each other and
# against the float64 posterior mean of the same system (``mean64``):
# 10x the largest reading of a sound run, 1.8e-5 (dust; both solves end
# on the dense rung; NVIDIA H100 80GB HBM3 at 700 W, PERF.md §5).
# The float32 correction K Wᵀ α sums Sᵀ over Wᵀα's cancelling entries in
# float32: from the exact α it sits 2.8e-6 (dust) and 7.9e-6 (regular)
# from the float64 mean, and α's own float32 floor adds to that, so two
# float32 means of one system do not meet 1e-5 on dust
COND_MEAN_F64 = 2e-4


def plain_correct(icr, mats, op, v):
    """``ConditionSystem.correct`` (K Wᵀ v, the fields) with every kernel
    replaced by its plain version, on the same device: Sᵀ by autograd
    through ``plain_apply`` at zero ξ (the map is linear in ξ), then
    ``plain_apply``."""
    import torch

    k = v.shape[0]
    u = op.apply_t(v).reshape((k,) + tuple(icr.chart.final_shape))
    zero = [torch.zeros((k,) + tuple(s), dtype=mats["sqrt0"].dtype,
                        device=v.device, requires_grad=True)
            for s in icr.xi_shapes()]
    with torch.enable_grad():
        f = plain_apply(icr, mats, zero)
        xi = torch.autograd.grad(f, zero, grad_outputs=u.to(f.dtype))
    with torch.no_grad():
        return plain_apply(icr, mats, list(xi)).reshape(k, -1)


def plain_matvec(icr, mats, op, noise_var, v):
    """``condition_matvec`` on the plain versions."""
    return (op.apply(plain_correct(icr, mats, op, v)).to(v.dtype)
            + noise_var * v)


def residuals64(icr, mats, mats64, op, noise_var, x, y, matvec,
                rtol, cap: float = 0.0) -> dict:
    """The residual ‖y − A64 x‖/‖y‖ of a float32 solution `x` (1, n_obs),
    A64 applied through the plain versions at float64, beside δ =
    ‖A32 x − A64 x‖/‖y‖, the float32 kernel-route operator's (`matvec`)
    own distance from A64 at x, and the bound 10·max(rtol, δ), δ capped
    at `cap` where the solve's ``CGConfig.floor_cap`` is above 0 (so the
    bound is at most 10·cap and x = 0, whose residual is 1, fails it).
    A64 is built two
    ways: from the solve's own float32 matrices at float64 (``same``, the
    checked one: δ is then the rounding of one float32 matvec at x, the
    floor under which no float32 solution holds its residual) and, for
    the record, from matrices built at float64 (``built_f64``: δ also
    holds the two builds' difference, up to percent on reflect charts,
    ROADMAP queue 3)."""
    import torch

    from repro_torch.kernels.policy import cast_tree

    yd = y.reshape(1, -1).double()
    ny = float(torch.linalg.vector_norm(yd))
    with torch.no_grad():
        a32 = matvec(x).double()
    out = {}
    for key, m in (("same", cast_tree(mats, torch.float64)),
                   ("built_f64", mats64)):
        with torch.no_grad():
            a64 = plain_matvec(icr, m, op, noise_var, x.double())
        delta = float(torch.linalg.vector_norm(a32 - a64)) / ny
        held = min(delta, cap) if cap > 0 else delta
        out[key] = {"residual": float(torch.linalg.vector_norm(a64 - yd))
                    / ny, "delta": delta, "bound": 10 * max(rtol, held)}
    return out


def mean64(system, mats, alpha, y, steps=3):
    """The posterior mean field K Wᵀ α64 at float64 on the solve's own
    matrices: α64 solves A64 α = y (A64 the plain versions at float64),
    reached by iterative refinement from the float32 `alpha` with the
    dense rung's matrix as the approximate inverse (‖A⁻¹(A64 − A)‖ is the
    float32 rounding). Returns ``(field, ‖y − A64 α64‖/‖y‖, α64)``."""
    import torch

    from repro_torch.kernels.policy import cast_tree

    icr, op, nv = system.icr, system.obs, system.noise_var
    m64 = cast_tree(mats, torch.float64)
    yd = y.reshape(1, -1).double()
    lu = torch.linalg.lu_factor(
        system.dense_matrix(torch.float32, y.device).double())
    a = alpha.double()
    for _ in range(steps):
        r = yd - plain_matvec(icr, m64, op, nv, a)
        a = a + torch.linalg.lu_solve(*lu, r.T).T
    res = float(torch.linalg.vector_norm(
        yd - plain_matvec(icr, m64, op, nv, a))
        / torch.linalg.vector_norm(yd))
    return plain_correct(icr, m64, op, a).reshape(-1), res, a


def condition_reaches(chart, samples) -> set:
    """The kernels a matvec at `samples` columns launches: the forward's
    per level (the pyramid over its cover), and the adjoints of every
    level (``apply_sqrt_T_batch`` runs no pyramid)."""
    from repro_torch.kernels import dispatch

    plan = dispatch.plan(chart, pyramid=True, samples=samples)
    return ({e["kernel"] for e in plan if e["launches"]}
            | {v["kernel"] for e in plan for v in e["vjp"]})


def condition_case(cname, chart, kernel, flush, card,
                   device="cuda") -> tuple:
    """Phase 6 on one chart, float32: (a) ``cg_posterior`` on 4,096
    seeded on-grid observations of a prior draw at σ = 0.25 at its
    default config, its residual recomputed at float64 through the plain
    versions, then at the JAX package's rtol 1e-7 (the dense rung's α);
    both solves again with their CG segments replayed and op by op, bit
    for bit, and one CG iteration's ms each way; (b) the kernel route's
    matvec against the plain route at k = 17, f32 and bf16; on dust and
    regular (c) one served ``kind="condition"`` request (n = 16) at rtol
    1e-7 whose mean is held to (a)'s and to the float64 posterior mean,
    (e) ``cg_posterior`` and a served request at their default configs on
    the training data's pattern (314,572 observations), and (d) the ICR
    rung at the level-0 basis against the unpreconditioned rung on that
    pattern. Returns ``(launches, record)``."""
    import numpy as np
    import torch

    from repro_torch import ICR, cg_posterior, charted_gp_dataset
    from repro_torch.kernels import build
    from repro_torch.launch import serve_gp as sg
    from repro_torch.solvers import CGConfig, condition_matvec, solve_guarded

    sync = (torch.cuda.synchronize if device == "cuda" else lambda: None)
    post = sg.demo_posterior(chart, kernel.default_theta["rho"],
                             device=device)
    icr = post.icr
    mats = icr.matrices_cached()
    mats64 = icr.matrices(dtype=torch.float64)
    srv = (sg.GPFieldServer(post, slab=S) if cname in COND_SERVED
           else None)
    gen = torch.Generator(device=device).manual_seed(31)
    truth = icr.sample(gen).reshape(-1)
    n_obs = min(COND_OBS, truth.numel() // 2)
    obs = torch.sort(torch.randperm(truth.numel(), generator=gen,
                                    device=device)[:n_obs]).values
    y = truth[obs].float() + COND_NOISE * torch.randn(
        n_obs, generator=gen, device=device)
    obs_np = obs.cpu().numpy()
    noise_var = COND_NOISE ** 2
    launches = {k: 0 for k in KERNEL_INFO}

    def reached(window, samples):
        counts = {k: build.LAUNCHES[k] for k in KERNEL_INFO}
        missing = sorted(k for k in condition_reaches(chart, samples)
                         if counts[k] == 0)
        if missing:
            raise AssertionError(f"condition {cname} {window}: kernels "
                                 f"never launched: {missing} ({counts})")
        for k, n in counts.items():
            launches[k] += n

    # (a) the entry point at its default config (rtol from the matvec's
    # rounding), the launch counters zeroed just before; the residual of
    # its own α, recomputed at float64 through the plain versions on the
    # solve's own matrices
    sync()
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    solution = {}
    _, rep = cg_posterior(icr, obs_np, y, noise_std=COND_NOISE,
                          _solution=solution)
    sync()
    solve_ms = (time.perf_counter() - t0) * 1e3
    reached("cg_posterior", 1)
    if rep.status[0] not in ("converged", "dense"):
        raise AssertionError(f"condition {cname}: cg_posterior ended "
                             f"{rep.summary()}")
    system, alpha = solution["system"], solution["alpha"]
    op = system.obs
    residuals = residuals64(icr, mats, mats64, op, noise_var, alpha, y,
                            system.matvec, rep.rtol, rep.floor_cap)
    if not (residuals["same"]["residual"] <= residuals["same"]["bound"]
            < 1.0 and rep.floor_cap > 0 and rep.delta is not None):
        raise AssertionError(f"condition {cname}: float64 residual "
                             f"{residuals}, report {rep.summary()}")

    # the same solve at the JAX package's rtol 1e-7, under float32's floor:
    # the CG rungs stall and the dense rung answers at float64; the mean
    # fields are held with this α
    tight = cond_tight(n_obs)
    sol_t = {}
    post_t, rep_t = cg_posterior(icr, obs_np, y, noise_std=COND_NOISE,
                                 config=tight, _solution=sol_t)
    residuals_t = residuals64(icr, mats, mats64, op, noise_var,
                              sol_t["alpha"], y, system.matvec, tight.rtol)
    if (rep_t.status[0] not in ("converged", "dense")
            or not (residuals_t["same"]["residual"]
                    <= residuals_t["same"]["bound"])):
        raise AssertionError(f"condition {cname}: cg_posterior at rtol "
                             f"1e-7 ended {rep_t.summary()}, float64 "
                             f"residual {residuals_t}")
    with torch.no_grad():
        mean_a = icr.apply_sqrt(mats, post_t.mean).reshape(-1)

    # graphed CG segments against eager ones: both solves again, bit for
    # bit; one CG iteration's ms and a segment's enqueue at k = 1 and 17
    yb = y.reshape(1, -1)
    graphed = {"default": graph_vs_eager(system, yb, solution["cfg"],
                                         cname, sync),
               "rtol_1e-7": graph_vs_eager(system, yb, tight, cname, sync)}
    vk = torch.randn((COND_K, n_obs), generator=gen, device=device)
    for b in (yb, vk):
        graphed[f"k{b.shape[0]}"] = cg_iteration_ms(system, b, flush)

    # matvec times by CUDA events, k = 1 and 17, and one matvec's enqueue
    v1 = torch.randn((1, n_obs), generator=gen, device=device)
    times = {"matvec_k1_ms": time_ms(lambda: system.matvec(v1), flush),
             f"matvec_k{COND_K}_ms": time_ms(lambda: system.matvec(vk),
                                             flush),
             "matvec_k1_enqueue_ms": enqueue_ms(lambda: system.matvec(v1))}

    # (b) the kernel route's matvec against the plain route, same matrices
    parity = {}
    icr_bf = ICR(chart, icr.kernel, use_pallas=True, dtype_policy="bf16",
                 device=device)
    for key, ic, m in (("fp32", icr, mats),
                       ("bf16", icr_bf, icr_bf.matrices())):
        with torch.no_grad():
            got = condition_matvec(ic, m, op, noise_var, vk)
        _, parity[key] = rel_err(got, plain_matvec(ic, m, op, noise_var, vk))
        tol = TOL["float32" if key == "fp32" else "bfloat16"]
        if not parity[key] <= tol:
            raise AssertionError(f"condition {cname} {key}: matvec against "
                                 f"the plain route {parity[key]:.3g} > {tol}")
    del icr_bf
    record = {"chart": cname, "n_obs": n_obs, "noise_std": COND_NOISE,
              "rtol": rep.rtol, "floor_cap": rep.floor_cap,
              "delta": rep.delta,
              "precond_bytes": getattr(system.precond, "nbytes", 0),
              "report": rep.summary(), "relres_reported": rep.relres[0],
              "solve_ms": solve_ms, "residual_f64": residuals,
              "report_rtol_1e-7": rep_t.summary(),
              "residual_f64_rtol_1e-7": residuals_t, "graphs": graphed,
              **times, "matvec_vs_plain_rel": parity}

    if srv is not None:
        # (c) one served request on (a)'s system at rtol 1e-7 (column 0 y,
        # 16 Matheron columns): its mean against (a)'s, and both against
        # the float64 posterior mean of the same system and matrices
        srv.solver_config = tight
        req = sg.GPRequest(kind="condition", n=COND_K - 1, seed=5,
                           y=y.cpu().numpy(), obs_idx=obs_np,
                           noise_std=COND_NOISE)
        sync()
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        srv.run([req])
        sync()
        served_ms = (time.perf_counter() - t0) * 1e3
        reached("served", COND_K)
        if not req.done or req.error is not None:
            raise AssertionError(f"condition {cname}: served request "
                                 f"failed: {req.error}")

        def rel2(got, want):
            got = torch.as_tensor(got, device=device).reshape(-1).double()
            want = want.reshape(-1).double()
            return float(torch.linalg.vector_norm(got - want)
                         / torch.linalg.vector_norm(want))

        want, res64, alpha64 = mean64(system, mats, sol_t["alpha"], y)
        with torch.no_grad():
            # the float32 correction alone, from the float64 α
            corr = system.correct(alpha64.float()).reshape(-1)
        served = {"ms": served_ms,
                  "correct_f32_of_alpha64_vs_f64": rel2(corr, want),
                  "mean_vs_cg_posterior": rel2(req.mean, mean_a),
                  "mean_vs_f64": rel2(req.mean, want),
                  "cg_posterior_vs_f64": rel2(mean_a, want),
                  "f64_residual": res64,
                  "std_mean": float(np.mean(req.std)),
                  "report": req.report.summary()}
        reports = srv.metrics()["solve_reports"]
        if (not served["mean_vs_cg_posterior"] <= COND_MEAN_F64
                or not served["mean_vs_f64"] <= COND_MEAN_F64
                or not served["cg_posterior_vs_f64"] <= COND_MEAN_F64
                or not np.isfinite(req.std).all() or not reports
                or reports[-1] != req.report.summary()):
            raise AssertionError(f"condition {cname}: served {served}, "
                                 f"finite std "
                                 f"{bool(np.isfinite(req.std).all())}, "
                                 f"reports {len(reports)}")
        record["served"] = served
        srv.solver_config = None

        # (e) on the training data's pattern (30 %, σ = 0.05: 314,572
        # observations), past the dense rung's reach: cg_posterior and a
        # served request at their default configs must answer, α's float64
        # residual within 10·max(rtol, δ), the report stating both
        gen.manual_seed(21)
        _, obs_d, y_d = charted_gp_dataset(icr, gen, obs_frac=OBS_FRAC,
                                           noise_std=NOISE)
        obs_d_np = obs_d.cpu().numpy()
        sync()
        t0 = time.perf_counter()
        sol_e = {}
        _, rep_e = cg_posterior(icr, obs_d_np, y_d, noise_std=NOISE,
                                _solution=sol_e)
        sync()
        ms_e = (time.perf_counter() - t0) * 1e3
        sys_d = sol_e["system"]
        op_d = sys_d.obs
        res_e = residuals64(icr, mats, mats64, op_d, NOISE ** 2,
                            sol_e["alpha"], y_d, sys_d.matvec, rep_e.rtol,
                            rep_e.floor_cap)
        held0 = torch.cuda.memory_allocated() if device == "cuda" else 0
        req_e = sg.GPRequest(kind="condition", n=COND_K - 1, seed=7,
                             y=y_d.cpu().numpy(), obs_idx=obs_d_np,
                             noise_std=NOISE)
        sync()
        t0 = time.perf_counter()
        srv.run([req_e])
        sync()
        served_sys = list(srv._cond_cache.values())
        default = {"n_obs": op_d.n_obs, "solve_ms": ms_e,
                   "report": rep_e.summary(), "residual_f64": res_e,
                   "served_ms": (time.perf_counter() - t0) * 1e3,
                   # device memory: the entry point's system (U and the
                   # factor of its preconditioner), and what the served
                   # request's cached system added on the card
                   "precond_bytes": getattr(sys_d.precond, "nbytes", 0),
                   "served_systems": len(served_sys),
                   "served_precond_bytes": sum(
                       getattr(q.precond, "nbytes", 0) for q in served_sys),
                   "served_added_bytes": (
                       torch.cuda.memory_allocated() - held0
                       if device == "cuda" else 0),
                   "served_segment_graphs": sum(
                       len(q.graphs) for q in served_sys),
                   "served_error": (None if req_e.error is None
                                    else req_e.error.code),
                   "served_report": (req_e.report.summary()
                                     if req_e.report is not None else None)}
        record["default_314k"] = default
        if (rep_e.status[0] not in ("converged", "dense")
                or not (res_e["same"]["residual"]
                        <= res_e["same"]["bound"] < 1.0)
                or rep_e.floor_cap <= 0 or rep_e.delta is None
                or not req_e.done or req_e.error is not None
                or req_e.report.delta is None):
            raise AssertionError(f"condition {cname}: the default solve "
                                 f"on {op_d.n_obs} observations: {default}")

        # (d) the ICR rung at the level-0 basis (the default system's
        # preconditioner) against the unpreconditioned rung on that pattern
        level0 = icr.xi_shapes()[0][0]
        rungs = {"n_obs": op_d.n_obs, "basis": level0}
        cfg_d = CGConfig(max_iters=500)
        for name, pc in (("icr", sys_d.precond), ("none", None)):
            t0 = time.perf_counter()
            x, rep_d = solve_guarded(sys_d.matvec, y_d[None],
                                     preconds=[(name, pc)], cfg=cfg_d,
                                     tag=f"rung:{name}",
                                     segment_graphs=sys_d.graphs)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            res_d = residuals64(icr, mats, mats64, op_d, NOISE ** 2, x,
                                y_d, sys_d.matvec, cfg_d.rtol)
            if rep_d.status[0] == "converged" and not (
                    res_d["same"]["residual"] <= 10 * cfg_d.rtol):
                raise AssertionError(
                    f"condition {cname} rung {name}: reports converged "
                    f"with float64 residuals {res_d}")
            rungs[name] = {"iterations": rep_d.iterations[0],
                           "status": rep_d.status[0],
                           "relres_reported": rep_d.relres[0],
                           "residual_f64": res_d, "solve_ms": ms}
        record["icr_rung"] = rungs
        del sys_d, sol_e
    record["card"] = card
    del srv, post, mats64, system, solution, sol_t
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches, record


def cond_tight(n_obs: int):
    """The JAX package's default ``CGConfig`` (rtol 1e-7): under float32's
    floor at full width, so every CG rung stalls and, up to ``dense_max``
    observations, the dense rung answers at float64."""
    from repro_torch.solvers import CGConfig

    return CGConfig(rtol=1e-7, max_iters=max(4 * n_obs, 200))


def graph_vs_eager(system, b, cfg, tag, sync) -> dict:
    """One solve of `b` on `system` down its ladder at `cfg`, its CG
    segments replayed from the system's captured graphs and then run op by
    op: the wall ms of each, and status, iterations and x, which must
    agree bit for bit (the on-grid matvec is deterministic)."""
    from repro_torch.core import graphs
    from repro_torch.solvers import solve_guarded

    ladder = ([("icr", system.precond)] if system.precond is not None
              else []) + [("none", None)]
    out, runs = {}, {}
    for name, mode in (("graph", contextlib.nullcontext),
                       ("eager", graphs.eager)):
        sync()
        t0 = time.perf_counter()
        with mode():
            runs[name] = solve_guarded(
                system.matvec, b, preconds=ladder, cfg=cfg,
                dense_solve=system.dense_solve, tag=tag,
                segment_graphs=system.graphs)
        sync()
        out[f"solve_{name}_ms"] = (time.perf_counter() - t0) * 1e3
    (xg, rg), (xe, re_) = runs["graph"], runs["eager"]
    out.update(rungs=list(rg.rungs), status=list(rg.status),
               iterations=list(rg.iterations),
               graph_equals_eager=(rg.status == re_.status
                                   and rg.iterations == re_.iterations
                                   and same_bits(xg, xe)))
    if not out["graph_equals_eager"]:
        raise AssertionError(f"condition {tag}: the graphed solve differs "
                             f"from the eager one: {rg.summary()} against "
                             f"{re_.summary()}")
    return out


def cg_iteration_ms(system, b, flush) -> dict:
    """Milliseconds of one CG iteration on the system's first rung at
    ``b.shape[0]`` columns (CUDA events over a segment of ``pcg.SEGMENT``
    iterations, divided), replayed from its captured graph and op by op,
    with the host time to enqueue a segment each way."""
    from repro_torch.core import graphs
    from repro_torch.solvers import CGConfig, pcg

    cfg = CGConfig(rtol=1e-7, max_iters=10**9)
    carry = pcg._pcg_init(system.matvec, b, system.precond, cfg)
    out = {"rung": "none" if system.precond is None else "icr"}
    for name, mode in (("graph", contextlib.nullcontext),
                       ("eager", graphs.eager)):
        runner = pcg._iterations(system.matvec, system.precond, cfg, carry,
                                 {})

        def segment(runner=runner, mode=mode):
            with mode():
                runner.advance(pcg.SEGMENT)

        out[f"iteration_{name}_ms"] = time_ms(segment, flush) / pcg.SEGMENT
        out[f"segment_{name}_enqueue_ms"] = enqueue_ms(segment)
    return out


def check_condition(flush, card) -> dict:
    """Phase 6: the data-conditioned solve on the four charts; one
    ``condition`` line per chart. Returns the launches."""
    import torch

    launches = {k: 0 for k in KERNEL_INFO}
    for cname, (chart, kernel) in charts().items():
        counts, rec = condition_case(cname, chart, kernel, flush, card)
        for k, n in counts.items():
            launches[k] += n
        # what the card still holds once the chart's systems, server and
        # graphs are dropped
        rec["allocated_after_bytes"] = torch.cuda.memory_allocated()
        rec["reserved_after_bytes"] = torch.cuda.memory_reserved()
        print("condition: " + json.dumps(rec), flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout holding src/repro_torch",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import ICR
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    bandwidth = next((bw for key, bw in BANDWIDTH if key in name), None)
    if bandwidth is None:
        print(f"chip_smoke: no bandwidth known for {name!r}",
              file=sys.stderr)
        return 1

    # -- 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    for lib in build.SIGNATURES:
        build.library(lib)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(build.SIGNATURES)} libraries; card: {card}", flush=True)

    gen = torch.Generator(device="cuda")
    models = {}
    for cname, (chart, kernel) in charts().items():
        icr = ICR(chart, kernel, use_pallas=True)
        t0 = time.perf_counter()
        mats = icr.matrices()
        torch.cuda.synchronize()
        models[cname] = (icr, mats, time.perf_counter() - t0)
    print("ptxas: " + json.dumps(ptxas_lines(main_path_smem(models))),
          flush=True)

    # -- 2. each kernel against its plain version -------------------------------
    errors = check_kernels(models, gen)
    print("kernels: " + json.dumps(
        {k: {d: {"max_abs_err": e[0], "max_rel_err": e[1]}
             for d, e in v.items()} for k, v in errors.items()}),
          flush=True)
    print(f"phase 2 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 3. the sampling path, with the pyramid and per level ------------------
    launches, path_err, covers = check_path(models, gen)
    print("path: " + json.dumps({"launches": launches, "covers": covers,
                                 "max_rel_err": path_err}), flush=True)

    # -- 4. training through the adjoint kernels and nd-axes --------------------
    problems = train_problems(models, gen)
    train_launches, train = check_train(problems, gen)
    for k, n in train_launches.items():
        launches[k] += n
    print("train: " + json.dumps(train), flush=True)
    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 4b. the compiled paths as CUDA graphs, against eager ---------------
    graph_launches, graph_record = check_graphs(problems, models, gen)
    for k, n in graph_launches.items():
        launches[k] += n
    print("graphs: " + json.dumps(graph_record), flush=True)
    print(f"phase 4b done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 5. serving: one CUDA graph per slab ------------------------------------
    flush = torch.empty(512 * 2**20, dtype=torch.float32, device="cuda")
    serve_launches, serve = check_serve(flush, bandwidth, card)
    for k, n in serve_launches.items():
        launches[k] += n
    print("serve: " + json.dumps(serve), flush=True)
    print(f"phase 5 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 6. data-conditioned solves: cg_posterior and kind="condition" ------
    for k, n in check_condition(flush, card).items():
        launches[k] += n
    print(f"phase 6 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 7. times ---------------------------------------------------------------
    times = kernel_times(models, bandwidth, flush, gen)
    entries = []
    for kname, info in KERNEL_INFO.items():
        f32 = times[kname]["float32"]
        entry = {"name": kname, "route": "cuda", "source": info["source"],
                 "replaces": info["replaces"],
                 "replaces_fn": info["replaces_fn"],
                 "launches": launches[kname],
                 "max_abs_err": errors[kname]["float32"][0],
                 "ms": f32["ms"], "plain_ms": f32["plain_ms"],
                 "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
                 "library_ms": f32["library_ms"],
                 "max_rel_err": {d: e[1] for d, e in errors[kname].items()},
                 "chart": info["chart"], "per_dtype": times[kname]}
        entries.append(entry)
        print(json.dumps(entry), flush=True)

    whole = {}
    for cname, (icr0, mats, mats_s) in models.items():
        for pol in (None, "bf16"):
            icr = ICR(icr0.chart, icr0.kernel, use_pallas=True,
                      dtype_policy=pol)
            m = icr.matrices()
            per_level = ICR(icr0.chart, icr0.kernel, use_pallas=True,
                            dtype_policy=pol, use_pyramid=False)
            gen.manual_seed(11)
            xi = icr.init_xi(gen, batch=S)
            v = torch.randn((S,) + icr.out_shape, generator=gen,
                            device="cuda").to(icr.policy.storage_dtype)

            def sqrt_t(icr=icr, m=m, v=v):
                return icr.apply_sqrt_T_batch(m, v)

            def sqrt_t_eager(icr=icr, m=m, v=v):
                return icr.apply_sqrt_T_batch(m, v, cached=False)

            whole[f"{cname}-{pol or 'fp32'}"] = {
                # the transpose: a replay of its cached graph (input copy
                # and output copies included) against the chain op by op
                "apply_sqrt_T_graph_ms": time_ms(sqrt_t, flush),
                "apply_sqrt_T_eager_ms": time_ms(sqrt_t_eager, flush),
                "apply_sqrt_T_graph_enqueue_ms": enqueue_ms(sqrt_t),
                "apply_sqrt_T_eager_enqueue_ms": enqueue_ms(sqrt_t_eager),
                "apply_ms": time_ms(lambda: icr.apply_sqrt_batch(m, xi),
                                    flush),
                "apply_per_level_ms": time_ms(
                    lambda: per_level.apply_sqrt_batch(m, xi), flush),
                "plain_apply_ms": time_ms(lambda: plain_apply(icr, m, xi),
                                          flush),
                "apply_enqueue_ms": enqueue_ms(
                    lambda: icr.apply_sqrt_batch(m, xi)),
                "apply_per_level_enqueue_ms": enqueue_ms(
                    lambda: per_level.apply_sqrt_batch(m, xi)),
                "cover": covers[f"{cname}-{pol or 'fp32'}"],
                "matrices_s": mats_s, "points": icr.chart.size,
                "samples": S}
    print("whole_path: " + json.dumps(whole), flush=True)
    print("pyramid_covers: " + json.dumps(pyramid_covers(models, flush, gen)),
          flush=True)
    print("levels_fp32: " + json.dumps(level_split(models, flush, gen)),
          flush=True)
    print("train_step: " + json.dumps(train_step_times(problems, flush)),
          flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


# fit steps per timed call of the eager-step comparison
EAGER_STEPS = 20


def eager_step_one(src: str, variant: str) -> dict:
    """The eager dust fixed-θ fit (``map_fit``, op by op) of the package
    under `src`: ms per step by CUDA events and its host enqueue, and the
    loss alone and the loss with its gradient, each way. ``fpad`` swaps
    ``reflect_pad`` for F.pad alone (``core.refine._pad``) in every module
    that calls it."""
    import importlib
    import inspect

    import torch

    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import (ICR, charted_gp_dataset,
                             gaussian_log_likelihood, map_fit, neg_log_joint)
    from repro_torch.kernels import build

    build.build()
    for lib in build.SIGNATURES:
        build.library(lib)
    if variant == "fpad":
        from repro_torch.core import refine

        for name in ("core.refine", "kernels.dispatch", "kernels.pyramid",
                     "kernels.nd", "kernels.nd_fused"):
            importlib.import_module("repro_torch." + name).reflect_pad = (
                refine._pad)
    chart, kernel = charts()["dust"]
    icr = ICR(chart, kernel, use_pallas=True)
    mats = icr.matrices()
    gen = torch.Generator(device="cuda").manual_seed(21)
    _, obs_idx, y = charted_gp_dataset(icr, gen, obs_frac=OBS_FRAC,
                                       noise_std=NOISE)
    ll = gaussian_log_likelihood(NOISE, obs_idx)

    def fwd(xi):
        return icr.apply_sqrt(mats, xi)

    loss_fn = neg_log_joint(ll, fwd)
    xi = [x.clone().requires_grad_(True) for x in icr.zero_xi()]
    kw = ({"jit": False} if "jit" in inspect.signature(map_fit).parameters
          else {})

    def loss():
        return loss_fn(xi, y)

    def grad():
        return torch.autograd.grad(loss_fn(xi, y), xi)

    def fit():
        return map_fit(ll, fwd, icr.zero_xi(), y, steps=EAGER_STEPS,
                       lr=3e-2, **kw)

    flush = torch.empty(512 * 2**20, dtype=torch.float32, device="cuda")
    return {"variant": variant, "loss_ms": time_ms(loss, flush),
            "loss_enqueue_ms": enqueue_ms(loss),
            "loss_grad_ms": time_ms(grad, flush),
            "loss_grad_enqueue_ms": enqueue_ms(grad),
            "step_ms": time_ms(fit, flush) / EAGER_STEPS,
            "step_enqueue_ms": enqueue_ms(fit) / EAGER_STEPS}


def eager_step_ab(specs) -> int:
    """``--eager-step LABEL=SRC[:fpad] ...``: the eager dust fit step of
    each package in turn (list them as parent, change, change, parent to
    see the drift), one process each; prints one ``eager_step`` line per
    run and the card."""
    for spec in specs:
        label, _, rest = spec.partition("=")
        src, _, variant = rest.partition(":")
        run = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--eager-step-one", src, variant or "as-is"],
            capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(run.stdout.strip().splitlines()[-1])
        print("eager_step: " + json.dumps({"label": label, **rec}),
              flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--eager-step"]:
        sys.exit(eager_step_ab(sys.argv[2:]))
    if sys.argv[1:2] == ["--eager-step-one"]:
        print(json.dumps(eager_step_one(*sys.argv[2:4])))
        sys.exit(0)
    sys.exit(main())
