#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ICR on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. build   — compile every CUDA kernel of the port from ``src/repro_torch``
   (one nvcc per source, in parallel); print the build time and the card.
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes of every level of the three serving charts (flagship dust
   ``galactic_dust_chart((8,16,16), 3)``, ``regular_chart(1024, 10)``,
   ``log_chart(1024, 8, n_csz=5, n_fsz=4)``), S=8 samples, real refinement
   matrices, in float32 (max relative error <= 1e-5) and with bfloat16
   storage (<= 5e-2).
3. path    — ``ICR(..., use_pallas=True).sample_batch(gen, 8)`` on each
   chart at both dtype policies, held against the same apply through the
   plain versions on the card; every kernel's launch counter, zeroed just
   before, must have risen.
4. times   — per kernel at its chart's largest level: CUDA-event medians of
   the kernel, its plain version and, where one PyTorch call computes (part
   of) the same function, that call; the byte/operation bound; whole-path
   milliseconds per chart; and, per level of each chart at float32, the
   torch glue before a launch against the kernel.

The last three lines are the ``kernels`` JSON line, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.

Relative error is ``max|kernel - plain| / max|plain|``. Float32 matmuls
and convolutions run without TF32 throughout.
"""
from __future__ import annotations

import json
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

KERNEL_INFO = {
    "refine_stationary": {
        "source": "src/repro_torch/kernels/csrc/refine_1d.cu",
        "replaces": "src/repro/kernels/icr_refine.py:98",
        "replaces_fn": "_stationary_kernel",
        "chart": "regular"},
    "refine_charted": {
        "source": "src/repro_torch/kernels/csrc/refine_1d.cu",
        "replaces": "src/repro/kernels/icr_refine.py:129",
        "replaces_fn": "_charted_kernel",
        "chart": "log"},
    "refine_nd_fused": {
        "source": "src/repro_torch/kernels/csrc/nd_fused.cu",
        "replaces": "src/repro/kernels/nd_fused.py:119",
        "replaces_fn": "_nd_fused_kernel",
        "chart": "dust"},
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def charts():
    from repro_torch import (galactic_dust_chart, log_chart, matern32,
                             regular_chart)

    return {
        "dust": (galactic_dust_chart((8, 16, 16), 3),
                 matern32.with_defaults(rho=0.5)),
        "regular": (regular_chart(1024, 10, boundary="reflect"),
                    matern32.with_defaults(rho=5000.0)),
        "log": (log_chart(1024, 8, n_csz=5, n_fsz=4, delta0=0.0197 / 16),
                matern32.with_defaults(rho=1.0)),
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


def plain_apply(icr, mats, xi):
    """``icr.apply_sqrt_batch`` with every kernel replaced by its plain
    version, on the same device."""
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
    repetition. The flush (a 512 MB memset, ~0.15 ms on the card) also
    keeps the card busy while the host enqueues `fn`, so the events time
    the device work and not the host's launch overhead, unless `fn` takes
    the host longer than that to enqueue (``enqueue_ms``)."""
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
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.policy import cast_tree

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

    # -- 2. each kernel against its plain version -------------------------------
    errors = {k: {} for k in KERNEL_INFO}
    for cname, (icr, mats, _) in models.items():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            m = cast_tree(mats, dtype)
            gen.manual_seed(1)
            for lvl in range(icr.chart.n_levels):
                geom, field, xi, r, d, axis_mats = level_inputs(
                    icr, m, lvl, dtype, gen)
                route, args = dispatch.level_operands(
                    field, xi, r, d, geom, axis_mats=axis_mats,
                    sample_axis=True)
                got = dispatch.KERNELS[route](*args)
                torch.cuda.synchronize()
                ref = dispatch.PLAIN[route](*args)
                absd, rel = rel_err(got, ref)
                kname = dispatch.KERNEL_OF_ROUTE[route]
                worst = errors[kname].get(dname, (0.0, 0.0))
                errors[kname][dname] = (max(worst[0], absd),
                                        max(worst[1], rel))
                if not rel <= TOL[dname]:
                    raise AssertionError(
                        f"{kname} {cname} level {lvl} {dname}: relative "
                        f"error {rel:.3g} > {TOL[dname]}")
    print("kernels: " + json.dumps(
        {k: {d: {"max_abs_err": e[0], "max_rel_err": e[1]}
             for d, e in v.items()} for k, v in errors.items()}),
          flush=True)

    # -- 3. the main path through the kernels -----------------------------------
    launches = {k: 0 for k in KERNEL_INFO}
    path_err = {}
    for cname, (icr0, _, _) in models.items():
        for pol in (None, "bf16"):
            icr = ICR(icr0.chart, icr0.kernel, use_pallas=True,
                      dtype_policy=pol)
            build.LAUNCHES.clear()
            gen.manual_seed(7)
            out = icr.sample_batch(gen, S)
            torch.cuda.synchronize()
            counts = {k: build.LAUNCHES[k] for k in KERNEL_INFO}
            for k, n in counts.items():
                launches[k] += n
            want = dispatch.KERNEL_OF_ROUTE[dispatch.plan(icr.chart)[0]
                                            ["route"]]
            if counts[want] != icr.chart.n_levels:
                raise AssertionError(
                    f"{cname} {pol}: {want} launched {counts[want]} times, "
                    f"expected {icr.chart.n_levels}")
            gen.manual_seed(7)
            xi = icr.init_xi(gen, batch=S)
            ref = plain_apply(icr, icr.matrices(), xi)
            if (tuple(out.shape) != (S,) + icr.chart.final_shape
                    or not bool(torch.isfinite(out).all())):
                raise AssertionError(f"{cname} {pol}: bad output "
                                     f"{tuple(out.shape)}")
            _, rel = rel_err(out, ref)
            tol = TOL["float32" if pol is None else "bfloat16"]
            path_err[f"{cname}-{pol or 'fp32'}"] = rel
            if not rel <= tol:
                raise AssertionError(f"{cname} {pol}: whole path relative "
                                     f"error {rel:.3g} > {tol}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    print("path: " + json.dumps({"launches": launches,
                                 "max_rel_err": path_err}), flush=True)

    # -- 4. times ---------------------------------------------------------------
    flush = torch.empty(128 * 2**20, dtype=torch.float32, device="cuda")
    entries = []
    for kname, info in KERNEL_INFO.items():
        icr, mats, _ = models[info["chart"]]
        per_dtype = {}
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            m = cast_tree(mats, dtype)
            gen.manual_seed(3)
            lvl = icr.chart.n_levels - 1
            geom, field, xi, r, d, axis_mats = level_inputs(
                icr, m, lvl, dtype, gen)
            route, args = dispatch.level_operands(
                field, xi, r, d, geom, axis_mats=axis_mats, sample_axis=True)
            kern, plain = dispatch.KERNELS[route], dispatch.PLAIN[route]
            ms = time_ms(lambda: kern(*args), flush)
            plain_ms = time_ms(lambda: plain(*args), flush)
            library_ms, library_call = None, None
            if route == "stationary-1d":
                coarse, _, r1, _ = args
                c3, w = coarse[:, None, :], r1[:, None, :]
                library_call = ("F.conv1d(coarse, R, stride=n_fsz//2): the "
                                "window contraction without the noise term")
                library_ms = time_ms(lambda: torch.nn.functional.conv1d(
                    c3, w, stride=geom.n_fsz // 2), flush)
            moved = operand_bytes(route, args, kern(*args))
            t_bytes = moved / bandwidth * 1e3
            t_ops = 2 * kernel_fmas(route, args) / F32_PEAK * 1e3
            per_dtype[dname] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "enqueue_ms": enqueue_ms(lambda: kern(*args)),
                "library_call": library_call,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": moved, "level": lvl,
                "shape": {"coarse": list(field.shape),
                          "fine": [S] + list(geom.fine_shape)}}
        f32 = per_dtype["float32"]
        entry = {"name": kname, "route": "cuda", "source": info["source"],
                 "replaces": info["replaces"],
                 "replaces_fn": info["replaces_fn"],
                 "launches": launches[kname],
                 "max_abs_err": errors[kname]["float32"][0],
                 "ms": f32["ms"], "plain_ms": f32["plain_ms"],
                 "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
                 "library_ms": f32["library_ms"],
                 "max_rel_err": {d: e[1] for d, e in errors[kname].items()},
                 "chart": info["chart"], "per_dtype": per_dtype}
        entries.append(entry)
        print(json.dumps(entry), flush=True)

    whole = {}
    for cname, (icr0, mats, mats_s) in models.items():
        for pol in (None, "bf16"):
            icr = ICR(icr0.chart, icr0.kernel, use_pallas=True,
                      dtype_policy=pol)
            m = icr.matrices()
            gen.manual_seed(11)
            xi = icr.init_xi(gen, batch=S)
            whole[f"{cname}-{pol or 'fp32'}"] = {
                "apply_ms": time_ms(lambda: icr.apply_sqrt_batch(m, xi),
                                    flush),
                "plain_apply_ms": time_ms(lambda: plain_apply(icr, m, xi),
                                          flush),
                "apply_enqueue_ms": enqueue_ms(
                    lambda: icr.apply_sqrt_batch(m, xi)),
                "matrices_s": mats_s, "points": icr.chart.size,
                "samples": S}
    print("whole_path: " + json.dumps(whole), flush=True)

    # where a float32 apply's time goes, level by level: the torch glue
    # before a launch (reflect pad, ξ layout and trailing-noise
    # contraction) and the kernel itself
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
            rows.append({"level": lvl, "glue_ms": time_ms(glue, flush),
                         "kernel_ms": time_ms(lambda: kern(*args), flush)})
        split[cname] = rows
    print("levels_fp32: " + json.dumps(split), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
