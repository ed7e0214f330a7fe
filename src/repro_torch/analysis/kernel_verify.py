"""Launch-plan verifier: proofs about every launch of the port's kernels.

The counterpart of the JAX package's ``analysis/kernel_verify.py``. Every
wrapper launches through its ``kernels.launch.LaunchPlan`` (the C entry
refuses a grid or shared memory other than the plan's), and
``dispatch.chart_launch_plans`` rebuilds the same records from geometry
alone, so a property proved of a plan holds of the launch. Over every
route × instance × scenario this module checks:

* **coverage** — the ownership maps' write boxes cover every element of
  every output exactly once (an N-D difference array of the boxes,
  integrated: no gap, no double write);
* **bounds** — every read and write box lies inside its index space, a
  view fits the buffer it is stored in, and a reflect-padded input pads
  by less than its stored extent;
* **halo** — each unit's read box of an input contains the windows its
  families need by definition (reflect pads included: the pyramid reads
  in padded coordinates);
* **bytes** — dynamic plus static shared memory per block is at most the
  H100's 227 KB; for #9 and #10 it equals what ``nd_tile`` budgeted; and
  a launch unit's forward plans move at least the bytes
  ``roofline/level_traffic.py`` models for it (``model_bytes``: less the
  trailing noise factors the glue contracts and the pyramid's reflect
  padding, which its kernels do not read);
* **transpose** — ⟨Ax, y⟩ = ⟨x, Aᵀy⟩ for every forward/adjoint pair
  (#1/#5, #2/#6, #3/#7, #4/#8, #9's and #10's chains), through the
  wrappers: on CPU tensors the plain versions at float64 (1e-12 relative
  to ‖Ax‖‖y‖), on the card the kernels (1e-5 at f32, 5e-2 with bf16
  storage);
* **hygiene** — one storage dtype per launch, and every main-path level
  of a chart on a kernel route (no level left to a plain version, no
  launch unit without plans). Float32 accumulation is not a plan
  property: the ``csrc`` bodies declare every accumulator ``float`` (or
  ``float4``) and convert storage through ``to_float``/``from_float``,
  so it holds by construction in the sources, not by this pass.

Findings are ``analysis.Finding`` records; ``python -m
repro_torch.analysis verify`` runs :func:`verify_all` and exits 1 on any.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from repro_torch.core.refine import LevelGeom
from repro_torch.kernels import dispatch, icr_refine, nd_fused, pyramid
from repro_torch.kernels.launch import SMEM_BLOCK_LIMIT
from repro_torch.roofline.level_traffic import (_padded_extent,
                                                refine_level_traffic)

from . import Finding
from .scenarios import SCENARIOS

__all__ = ["check_coverage", "check_bounds", "check_halo", "check_bytes",
           "check_hygiene", "check_routes", "verify_plan", "coverage_counts",
           "model_bytes",
           "written_elements", "transpose_pairs", "check_transpose_pair",
           "transpose_groups", "verify_transpose", "scenario_groups",
           "verify_groups", "verify_scenario", "verify_all", "STATIC_SMEM",
           "TRANSPOSE_RTOL"]

# static shared memory per block of each kernel (bytes, at most): the
# pyramid's level parameters and two pointers (pyramid.cu, PyrLevel)
STATIC_SMEM = {"refine_pyramid": 256}
# ⟨Ax, y⟩ against ⟨x, Aᵀy⟩, relative to ‖Ax‖·‖y‖, by operand dtype
TRANSPOSE_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5,
                  torch.bfloat16: 5e-2}


def _first(mask: np.ndarray) -> int:
    return int(np.flatnonzero(mask)[0])


def coverage_counts(boxes, shape) -> np.ndarray:
    """How many boxes cover each element of an array of ``shape``: the
    boxes' corners in a difference array (inclusion–exclusion), integrated
    along every axis. Parts of a box outside the array are clipped (they
    are the bounds pass's findings)."""
    shape = tuple(int(n) for n in shape)
    keep = ~boxes.empty()
    lo = np.clip(boxes.lo[keep], 0, shape)
    hi = np.clip(boxes.hi[keep], 0, shape)
    ext = np.asarray(shape, np.int64) + 1
    strides = np.ones(len(shape), np.int64)
    for a in range(len(shape) - 2, -1, -1):
        strides[a] = strides[a + 1] * ext[a + 1]
    pos, neg = [], []
    for corner in itertools.product((False, True), repeat=len(shape)):
        idx = (np.where(corner, hi, lo) * strides).sum(axis=1)
        (neg if sum(corner) % 2 else pos).append(idx)
    size = int(np.prod(ext))
    acc = (np.bincount(np.concatenate(pos), minlength=size)
           - np.bincount(np.concatenate(neg), minlength=size))
    acc = acc.reshape(tuple(ext))
    for a in range(len(shape)):
        np.cumsum(acc, axis=a, out=acc)
    return acc[tuple(slice(0, n) for n in shape)]


def _exact_once_2d(boxes, shape) -> bool:
    """Whether boxes in a 2-axis space tile it exactly once, by their row
    intervals in raveled order, sorted (no dense array): True when they
    do, False when the dense count must say where they do not."""
    keep = ~boxes.empty()
    lo, hi = boxes.lo[keep], boxes.hi[keep]
    if (lo < 0).any() or (hi > np.asarray(shape)).any():
        return False
    n_rows = hi[:, 0] - lo[:, 0]
    box = np.repeat(np.arange(len(lo)), n_rows)
    first = np.repeat(np.cumsum(n_rows) - n_rows, n_rows)
    row = lo[box, 0] + np.arange(len(box)) - first
    start = row * shape[1] + lo[box, 1]
    order = np.argsort(start, kind="stable")
    start = start[order]
    end = (row * shape[1] + hi[box, 1])[order]
    reach = np.maximum.accumulate(end)
    return (len(start) > 0 and start[0] == 0 and reach[-1] == math.prod(shape)
            and bool((start[1:] == reach[:-1]).all()))


def _merge_full_axes(boxes, shape):
    """The boxes on a 2-axis form of the space, merging each trailing axis
    that every box spans whole into the one before it; None when more
    than two axes remain."""
    lo, hi, shape = boxes.lo, boxes.hi, tuple(shape)
    while len(shape) > 2:
        n = shape[-1]
        if not ((lo[:, -1] == 0).all() and (hi[:, -1] == n).all()):
            return None
        lo = np.concatenate([lo[:, :-2], lo[:, -2:-1] * n], axis=1)
        hi = np.concatenate([hi[:, :-2], hi[:, -2:-1] * n], axis=1)
        shape = shape[:-2] + (shape[-2] * n,)
    if len(shape) == 1:
        return None
    return type(boxes)(lo, hi), shape


def written_elements(plan) -> dict:
    """Elements each output space's write boxes hold, summed over units:
    ``{(group, name): (written, size)}``."""
    out = {}
    for grp in plan.ownership():
        for name, b in grp.writes.items():
            vol = np.prod(np.maximum(b.hi - b.lo, 0), axis=1).sum()
            out[(grp.label, name)] = (int(vol),
                                      math.prod(grp.spaces[name]))
    return out


def check_coverage(plan, *, scenario: str = "", location: str = "",
                   own=None) -> list:
    """Every element of every output is written exactly once."""
    findings = []
    for grp in (own or plan.ownership()):
        for name, b in grp.writes.items():
            shape = grp.spaces[name]
            flat = _merge_full_axes(b, shape)
            if flat is not None and _exact_once_2d(*flat):
                continue
            counts = coverage_counts(b, shape)
            gaps, dups = counts == 0, counts > 1
            where = f"{location} {grp.label} {name}".strip()
            if gaps.any():
                idx = np.unravel_index(_first(gaps.ravel()), counts.shape)
                findings.append(Finding(
                    "coverage", scenario, where,
                    f"{plan.kernel}: {int(gaps.sum())} element(s) of "
                    f"{name} {tuple(shape)} never written (first at "
                    f"{tuple(int(i) for i in idx)})"))
            if dups.any():
                idx = np.unravel_index(_first(dups.ravel()), counts.shape)
                findings.append(Finding(
                    "coverage", scenario, where,
                    f"{plan.kernel}: {int(dups.sum())} element(s) of "
                    f"{name} written more than once (first at "
                    f"{tuple(int(i) for i in idx)}, "
                    f"{int(counts[idx])} times)"))
    return findings


def check_bounds(plan, *, scenario: str = "", location: str = "",
                 own=None) -> list:
    """Every box inside its space; views inside their buffers; reflect
    padding shorter than the stored axis."""
    findings = []
    ops = {op.name: op for op in plan.operands}

    def find(where, msg):
        findings.append(Finding("bounds", scenario,
                                f"{location} {where}".strip(),
                                f"{plan.kernel}: {msg}"))

    for grp in (own or plan.ownership()):
        for kind, maps in (("read", grp.reads), ("write", grp.writes)):
            for name, b in maps.items():
                shape = np.asarray(grp.spaces[name], np.int64)
                live = ~b.empty()
                bad = live & ((b.lo < 0).any(axis=1)
                              | (b.hi > shape).any(axis=1))
                if bad.any():
                    u = min(_first(bad), len(b.lo) - 1)
                    find(f"{grp.label} {name}",
                         f"{int(bad.sum())} unit(s) {kind} outside "
                         f"{name} {tuple(shape)} (unit {u}: "
                         f"[{b.lo[u].tolist()}, {b.hi[u].tolist()}))")
        for name, shape in grp.spaces.items():
            buf = grp.buffers.get(name, name)
            if name in grp.reflect:   # stored unpadded, read reflected
                stored = grp.reflect[name][0][:len(shape) - 1]
                shape = (shape[0],) + tuple(stored)
            if buf in ops and math.prod(shape) > math.prod(ops[buf].shape):
                find(f"{grp.label} {name}",
                     f"{name} {tuple(shape)} does not fit {buf} "
                     f"{ops[buf].shape}")
            if name in ops and math.prod(shape) != math.prod(
                    ops[name].shape):
                find(f"{grp.label} {name}",
                     f"the view {tuple(shape)} of {name} is not its "
                     f"{ops[name].shape}")
        for name, (stored, pad) in grp.reflect.items():
            nd = len(grp.spaces[name]) - 1
            stored, pad = stored[:nd], pad[:nd]
            if tuple(grp.spaces[name][1:]) != tuple(
                    n + 2 * p for n, p in zip(stored, pad)):
                find(f"{grp.label} {name}",
                     f"padded space {grp.spaces[name]} is not {stored} "
                     f"padded by {pad}")
            for a, (n, p) in enumerate(zip(stored, pad)):
                if p and p >= n:
                    find(f"{grp.label} {name}",
                         f"axis {a} reflects {p} entries of {n}: the "
                         "reflected index leaves the stored axis")
    return findings


def check_halo(plan, *, scenario: str = "", location: str = "",
               own=None) -> list:
    """Each unit reads, of every input, at least the windows its families
    need."""
    findings = []
    for grp in (own or plan.ownership()):
        for name, need in grp.needs.items():
            read = grp.reads.get(name)
            live = ~need.empty()
            if read is None:
                if live.any():
                    findings.append(Finding(
                        "halo", scenario, f"{location} {grp.label}".strip(),
                        f"{plan.kernel}: {name} is needed and never read"))
                continue
            short = live & ((read.lo > need.lo).any(axis=1)
                            | (read.hi < need.hi).any(axis=1))
            if short.any():
                u = _first(short)
                r, n = min(u, len(read.lo) - 1), min(u, len(need.lo) - 1)
                findings.append(Finding(
                    "halo", scenario,
                    f"{location} {grp.label} {name}".strip(),
                    f"{plan.kernel}: {int(short.sum())} unit(s) read less "
                    f"of {name} than their windows need (unit {u} reads "
                    f"[{read.lo[r].tolist()}, {read.hi[r].tolist()}), "
                    f"needs [{need.lo[n].tolist()}, {need.hi[n].tolist()}))"))
    return findings


def check_bytes(plan, *, model: int | None = None, scenario: str = "",
                location: str = "") -> list:
    """Shared memory within the H100's per-block limit and, for #9 and
    #10, equal to the tile's budget; the plan's bytes at least ``model``
    (the traffic model's bytes of the launch's own operands)."""
    findings = []

    def find(msg):
        findings.append(Finding("bytes", scenario, location,
                                f"{plan.kernel}: {msg}"))

    total = plan.smem + STATIC_SMEM.get(plan.kernel, 0)
    if total > SMEM_BLOCK_LIMIT:
        find(f"{total} bytes of shared memory per block exceed the "
             f"H100's {SMEM_BLOCK_LIMIT}")
    if plan.smem_budget is not None and plan.smem != plan.smem_budget:
        find(f"{plan.smem} bytes of shared memory, the tile was budgeted "
             f"{plan.smem_budget}")
    if model is not None and plan.hbm_bytes() < model:
        find(f"moves {plan.hbm_bytes()} bytes, fewer than the modeled "
             f"{model}")
    return findings


def check_hygiene(plan, *, scenario: str = "", location: str = "") -> list:
    """One storage dtype per launch: float32 or bfloat16, every operand
    in it."""
    findings = []
    storage = plan.instance["dtype"]
    if storage not in ("float32", "bfloat16"):
        findings.append(Finding("hygiene", scenario, location,
                                f"{plan.kernel}: storage {storage}"))
    mixed = {op.dtype for op in plan.operands} - {storage}
    if mixed:
        findings.append(Finding("hygiene", scenario, location,
                                f"{plan.kernel}: operands in {sorted(mixed)}"
                                f" beside {storage}"))
    return findings


_KERNEL_ROUTES = set(dispatch.VJP_ROUTE)


def check_routes(groups, *, scenario: str = "") -> list:
    """Every launch unit of a chart is on a kernel route with forward and
    VJP plans: no main-path level of a CUDA tensor reaches a plain
    version."""
    findings = []
    for grp in groups:
        where = f"level {grp['level']}"
        if grp["route"] not in _KERNEL_ROUTES:
            findings.append(Finding("hygiene", scenario, where,
                                    f"route {grp['route']!r} runs a plain "
                                    "version, not a kernel"))
        elif not grp["forward"] or not grp["vjp"]:
            findings.append(Finding("hygiene", scenario, where,
                                    f"route {grp['route']!r} has no "
                                    "launch plans"))
    return findings


def verify_plan(plan, *, model: int | None = None, scenario: str = "",
                location: str = "") -> list:
    """Coverage, bounds, halo, bytes and hygiene of one plan."""
    kw = dict(scenario=scenario, location=location)
    own = plan.ownership()
    return (check_coverage(plan, own=own, **kw)
            + check_bounds(plan, own=own, **kw)
            + check_halo(plan, own=own, **kw)
            + check_bytes(plan, model=model, **kw)
            + check_hygiene(plan, **kw))


def model_bytes(grp, samples: int, dtype) -> int:
    """What ``roofline/level_traffic.py`` models for a launch unit's
    forward (per covered level of the pyramid, the coarse read on its
    first and the fine write on its last), less the two terms its kernel
    does not move by design: an N-D level's trailing noise factors
    ``sqrt(D_a)``, a >= 1 (the glue contracts them into ξ before the
    launch, ``nd_fused.prepare_xi0``), and the pyramid's reflect padding
    of its first field (read through the index, not stored)."""
    itemsize = {"float32": 4, "bfloat16": 2}[str(dtype)]
    geoms = grp["geoms"]
    total = 0
    for i, geom in enumerate(geoms):
        m = refine_level_traffic(geom, grp["route"], samples=samples,
                                 dtype=dtype, first=i == 0,
                                 last=i == len(geoms) - 1)
        total += m["total"]
        f = geom.n_fsz
        total -= itemsize * sum((geom.T[a] if geom.kept_T[a] > 1 else 1)
                                * f * f for a in range(1, len(geom.T)))
        if grp["route"] == "pyramid" and i == 0:
            total -= samples * itemsize * (
                math.prod(_padded_extent(geom, a)
                          for a in range(len(geom.T)))
                - math.prod(geom.coarse_shape))
    return total


def verify_groups(groups, *, samples: int, dtype, scenario: str = "",
                  seen: set | None = None) -> list:
    """Every plan of ``chart_launch_plans`` groups, each distinct plan
    once (``seen``: the ``describe()`` keys already verified)."""
    seen = set() if seen is None else seen
    findings = check_routes(groups, scenario=scenario)
    for grp in groups:
        for kind in ("forward", "vjp"):
            for i, p in enumerate(grp[kind]):
                key = repr(p.describe())
                if key in seen:
                    continue
                seen.add(key)
                model = (model_bytes(grp, samples, dtype)
                         if kind == "forward" and grp["route"] != "nd-axes"
                         else None)
                findings += verify_plan(
                    p, model=model, scenario=scenario,
                    location=f"level {grp['level']} {kind}[{i}]")
    return findings


# -- transpose ----------------------------------------------------------------------
def _randn(gen, shape, dtype, device, scale=1.0):
    x = torch.randn(shape, generator=gen, dtype=torch.float64) * scale
    return x.to(device=device, dtype=dtype)


def _dot(a, b) -> float:
    return float((a.double() * b.double()).sum())


def check_transpose_pair(fwd, adj, xs, y, *, rtol: float, label: str = "",
                         scenario: str = "") -> list:
    """⟨fwd(*xs), y⟩ = Σ ⟨x_i, adj(y)_i⟩ within ``rtol`` relative to
    ‖fwd(*xs)‖·‖y‖."""
    with torch.no_grad():
        ax = fwd(*xs)
        aty = adj(y)
    aty = aty if isinstance(aty, (tuple, list)) else (aty,)
    lhs = _dot(ax, y)
    rhs = sum(_dot(x, t) for x, t in zip(xs, aty))
    scale = float(ax.double().norm() * y.double().norm()) or 1.0
    err = abs(lhs - rhs) / scale
    if not math.isfinite(err) or err > rtol:
        return [Finding("transpose", scenario, label,
                        f"<Ax, y> = {lhs:.12g} but <x, A^T y> = {rhs:.12g}:"
                        f" {err:.3g} relative, over {rtol:g}")]
    return []


def transpose_pairs(chart, grp, *, samples: int, dtype, device,
                    gen) -> list:
    """The forward/adjoint pairs of one launch unit as ``(label, fwd, adj,
    xs, y)`` on random operands of the unit's shapes, through the
    wrappers (the kernels on a CUDA device, the plain versions on the
    CPU): a 1-D level's pair with noise and its noise-free pair; an N-D
    level's fused kernel and its adjoint chain; the pyramid's launch and
    its per-level adjoints."""
    dev = torch.device(device)
    out = []
    if grp["route"] in ("stationary-1d", "charted-1d"):
        geom = grp["geoms"][0]
        charted = grp["route"] == "charted-1d"
        f, c, t = geom.n_fsz, geom.n_csz, geom.T[0]
        length = dispatch._padded_extents(geom)[0]
        lead = (t,) if charted else ()
        coarse = _randn(gen, (samples, length), dtype, dev)
        xi = _randn(gen, (samples, t, f), dtype, dev)
        r = _randn(gen, lead + (f, c), dtype, dev, c ** -0.5)
        d = _randn(gen, lead + (f, f), dtype, dev, f ** -0.5)
        y = _randn(gen, (samples, t * f), dtype, dev)
        name = "charted" if charted else "stationary"
        fwd = getattr(icr_refine, f"refine_{name}")
        nn = getattr(icr_refine, f"refine_{name}_nn")
        adj = getattr(icr_refine, f"refine_{name}_adjoint")
        out.append((f"{name} #{3 if charted else 1}/#{7 if charted else 5}",
                    lambda a, b: fwd(a, b, r, d),
                    lambda g: adj(g, r, d, coarse_len=length), [coarse, xi],
                    y))
        out.append((f"{name}_nn #{4 if charted else 2}/"
                    f"#{8 if charted else 6}",
                    (lambda a: nn(a, r)) if charted else
                    (lambda a: nn(a, r, t)),
                    lambda g: adj(g, r, None, coarse_len=length), [coarse],
                    y))
    elif grp["route"] == "nd-fused":
        geom = grp["geoms"][0]
        charted = dispatch._charted_axes(chart, geom)
        f, c, T = geom.n_fsz, geom.n_csz, tuple(geom.T)
        padded = dispatch._padded_extents(geom)
        prod_f = math.prod(ta * f for ta in T[1:])
        field = _randn(gen, (samples,) + padded, dtype, dev)
        xi0 = _randn(gen, (samples, T[0] * f, prod_f), dtype, dev)
        mats = [_randn(gen, ((T[a],) if charted[a] else ()) + (f, c), dtype,
                       dev, c ** -0.5) for a in range(len(T))]
        d0 = _randn(gen, ((T[0],) if charted[0] else ()) + (f, f), dtype,
                    dev, f ** -0.5)
        y = _randn(gen, (samples, T[0] * f, prod_f), dtype, dev)
        out.append(("nd-fused #9/adjoint chain",
                    lambda a, b: nd_fused.refine_nd_fused_core(
                        a, b, mats[0], d0, tuple(mats[1:]), T),
                    lambda g: nd_fused.refine_nd_fused_adjoint(
                        g, mats[0], d0, tuple(mats[1:]), T,
                        (samples,) + padded),
                    [field, xi0], y))
    elif grp["route"] == "pyramid":
        geoms = grp["geoms"]
        levels, xs = [], []
        field = _randn(gen, (samples,) + tuple(geoms[0].coarse_shape), dtype,
                       dev)
        for geom in geoms:
            charted = dispatch._charted_axes(chart, geom)
            f, c, T = geom.n_fsz, geom.n_csz, tuple(geom.T)
            prod_f = math.prod(ta * f for ta in T[1:])
            rs = tuple(_randn(gen, ((T[a],) if charted[a] else ()) + (f, c),
                              dtype, dev, c ** -0.5) for a in range(len(T)))
            d0 = _randn(gen, ((T[0],) if charted[0] else ()) + (f, f), dtype,
                        dev, f ** -0.5)
            xi0 = _randn(gen, (samples, T[0] * f, prod_f), dtype, dev)
            levels.append((xi0, rs, d0))
            xs.append(xi0)
        y = _randn(gen, (samples,) + tuple(geoms[-1].fine_shape), dtype, dev)

        def fwd(fld, *x0s):
            lv = tuple((x0, rs, d0) for x0, (_, rs, d0) in zip(x0s, levels))
            return pyramid.refine_pyramid_core(fld, tuple(geoms), lv)

        def adj(g):
            dfield, dxi0s = pyramid._transpose(g, tuple(geoms),
                                               tuple(levels))
            return (dfield, *dxi0s)

        out.append(("pyramid #10/adjoints", fwd, adj, [field, *xs], y))
    return out


def verify_transpose(chart, groups, *, samples: int, dtype=torch.float64,
                     device="cpu", scenario: str = "", seed: int = 0) -> list:
    """The transpose pass over a chart's launch units."""
    gen = torch.Generator().manual_seed(seed)
    rtol = TRANSPOSE_RTOL[dtype]
    findings = []
    for grp in groups:
        for label, fwd, adj, xs, y in transpose_pairs(
                chart, grp, samples=samples, dtype=dtype, device=device,
                gen=gen):
            findings += check_transpose_pair(
                fwd, adj, xs, y, rtol=rtol, scenario=scenario,
                label=f"level {grp['level']} {label}")
    return findings


def scenario_groups(scn, *, device=None) -> list:
    """The launch units a scenario runs: its chart with the pyramid's
    cover, the per-level routes underneath (``use_pyramid=False``, the
    sharded path), and on N-D charts the ``nd-axes`` route of learned θ."""
    chart = scn.chart()
    kw = dict(samples=scn.samples, dtype=scn.storage, device=device)
    groups = dispatch.chart_launch_plans(chart, pyramid=True, **kw)
    groups += [g for g in dispatch.chart_launch_plans(chart, pyramid=False,
                                                      **kw)
               if g["route"] != "pyramid"]
    if chart.ndim > 1:
        for lvl in range(chart.n_levels):
            groups.append({"level": lvl, "route": "nd-axes",
                           "vjp_route": "nd-axes-adjoint",
                           "geoms": [LevelGeom.for_level(chart, lvl)],
                           **dispatch.level_launch_plans(
                               chart, lvl, "nd-axes", samples=scn.samples,
                               dtype=scn.storage)})
    return groups


def verify_scenario(scn, *, transpose: bool = True,
                    device=None) -> list:
    """Every pass over a scenario's launch units; the transpose pass on
    the CPU at float64 (``device`` None or ``"cpu"``) or at the storage
    dtype on the card."""
    groups = scenario_groups(scn, device=device)
    findings = verify_groups(groups, samples=scn.samples, dtype=scn.storage,
                             scenario=scn.label)
    if transpose:
        cuda = device is not None and torch.device(device).type == "cuda"
        dtype = ({"float32": torch.float32, "bfloat16": torch.bfloat16}
                 [scn.storage] if cuda else torch.float64)
        findings += verify_transpose(
            scn.chart(), transpose_groups(groups),
            samples=min(scn.samples, 2), dtype=dtype,
            device=device or "cpu", scenario=scn.label)
    return findings


def transpose_groups(groups) -> list:
    """The launch units the transpose pass takes: one per (level, route),
    ``nd-axes`` aside (its passes are the 1-D pairs the other routes
    hold)."""
    unique = {}
    for g in groups:
        if g["route"] != "nd-axes":
            unique.setdefault((str(g["level"]), g["route"]), g)
    return list(unique.values())


def verify_all(scenarios=None, **kw) -> list:
    """``verify_scenario`` over the quick serving scenarios (default)."""
    findings = []
    for scn in scenarios or SCENARIOS(quick=True):
        findings += verify_scenario(scn, **kw)
    return findings
