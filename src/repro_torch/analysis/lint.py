"""Lint the port's launches against the H100's limits.

The counterpart of the JAX package's ``analysis/lint.py`` (its VMEM lint,
route coverage and dtype census), over the port's launch plans:

* **shared memory and registers** — each plan's dynamic plus static
  shared memory within the 227 KB a block may take, and the blocks of 256
  an SM holds at the plan's shared memory and the instance's registers at
  least what its ``__launch_bounds__`` promise (4 for #9 and the N-D
  pyramid, 3 for the 1-D pyramid, 1 for the streaming kernels). Without a
  build (the CPU) the registers are the launch bounds' cap; on the card
  they are ``ptxas``' own figures (``ptxas_lines``, from the ``-Xptxas
  -v`` report kept beside each built library);
* **route coverage** — every level of a chart has a kernel route and a
  kernel, and the pyramid's cover is a prefix of 1-D stationary levels;
* **dtype census** — the bytes each plan moves through device memory, by
  dtype: a bf16 scenario's launches move no float32 operand.
"""
from __future__ import annotations

import re

from repro_torch.kernels import dispatch, launch

from . import Finding
from .kernel_verify import STATIC_SMEM

__all__ = ["blocks_per_sm", "ptxas_lines", "LAUNCH_BOUNDS", "lint_plan",
           "lint_route_coverage", "dtype_census", "lint_scenario",
           "SM_REGISTERS", "SM_SMEM", "BLOCK_SMEM_RESERVED"]

SM_REGISTERS = 65536         # 32-bit registers of an H100 SM
SM_SMEM = 233472             # shared memory of an H100 SM (228 KB)
BLOCK_SMEM_RESERVED = 1024   # shared memory the runtime keeps per block
# the blocks per SM each kernel's __launch_bounds__(256, min) promises
# (its registers capped at 65536 / (256 · min)); the streaming 1-D kernels
# promise 1
LAUNCH_BOUNDS = {"refine_nd_fused": 4, "refine_pyramid nd": 4,
                 "refine_pyramid 1d": 3}


def blocks_per_sm(registers: int, smem: int) -> int:
    """Resident blocks of 256 threads an H100 SM holds at `registers` per
    thread (allocated in units of 8 per thread, i.e. 256 per warp) and
    `smem` bytes of shared memory per block; at most 8 (2048 threads)."""
    by_regs = SM_REGISTERS // (-(-registers // 8) * 8 * 256)
    by_smem = SM_SMEM // (smem + BLOCK_SMEM_RESERVED) if smem else 8
    return min(8, by_regs, by_smem)


# per instance of the kernels the ``ptxas`` report names: a pattern of its
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


def ptxas_lines(smem=None,
                libs=("refine_1d", "refine_1d_adjoint", "nd_fused",
                      "pyramid")) -> dict:
    """Registers and spill bytes of the streaming 1-D instances, the N-D
    per-level instances and the pyramid's, from the ``-Xptxas -v`` report
    kept beside each built library; for the N-D and pyramid instances also
    the dynamic shared memory of their main-path launch (`smem`: kind ->
    bytes, at f32 and bf16 alike) and the blocks of 256 an SM holds."""
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


def _bound_key(plan) -> str:
    if plan.kernel == "refine_pyramid":
        return "refine_pyramid " + ("nd" if plan.instance["nd"] else "1d")
    return plan.kernel


def _ptxas_name(plan) -> str | None:
    """The ``ptxas_lines`` name of a plan's instance (compile-time
    stencils only)."""
    st = plan.instance.get("stencil")
    if st == "runtime":
        return None
    dt = "bf16" if plan.instance["dtype"] == "bfloat16" else "f32"
    f, c = st
    if plan.kernel == "refine_nd_fused":
        return f"nd_fused {dt} ({f}, {c})"
    if plan.kernel == "refine_pyramid":
        return (f"pyramid {dt} {'nd' if plan.instance['nd'] else '1d'} "
                f"({f}, {c})")
    kind = ("charted" if plan.instance["charted"] else "stationary") + (
        "_adj" if "adjoint" in plan.kernel else "")
    variant = "noise" if plan.instance["noise"] else "nn"
    return f"{kind} {dt} {variant} ({f}, {c}) NF={plan.instance['families']}"


def lint_plan(plan, *, registers: dict | None = None, scenario: str = "",
              location: str = "") -> list:
    """Shared memory and residency of one plan (see the module
    docstring). ``registers``: ``ptxas_lines``' report, where built."""
    findings = []
    total = plan.smem + STATIC_SMEM.get(plan.kernel, 0)
    if total > launch.SMEM_BLOCK_LIMIT:
        findings.append(Finding(
            "lint", scenario, location,
            f"{plan.kernel}: {total} bytes of shared memory per block over "
            f"the H100's {launch.SMEM_BLOCK_LIMIT}"))
    need = LAUNCH_BOUNDS.get(_bound_key(plan), 1)
    # ptxas' cap under the bounds: whole units of 8 registers per thread
    regs = min(255, SM_REGISTERS // (256 * need) // 8 * 8)
    row = (registers or {}).get(_ptxas_name(plan))
    if row is not None:
        regs = row["registers"]
    held = blocks_per_sm(regs, total)
    if held < need:
        findings.append(Finding(
            "lint", scenario, location,
            f"{plan.kernel}: an SM holds {held} block(s) at {regs} "
            f"registers and {total} bytes of shared memory; its launch "
            f"bounds promise {need}"))
    return findings


def lint_route_coverage(chart, *, samples: int = 1, dtype=None,
                        scenario: str = "") -> list:
    """Every level on a kernel route with its kernel; the pyramid's cover
    a prefix of 1-D stationary levels."""
    findings = []
    entries = dispatch.plan(chart, pyramid=True, samples=samples,
                            dtype=dtype)
    covered = [e["level"] for e in entries if e["route"] == "pyramid"]
    if covered != list(range(len(covered))):
        findings.append(Finding("lint", scenario, "pyramid",
                                f"the cover {covered} is not a prefix"))
    for e in entries:
        want = dispatch.KERNEL_OF_ROUTE.get(e["route"])
        if want is None or e["kernel"] != want:
            findings.append(Finding(
                "lint", scenario, f"level {e['level']}",
                f"route {e['route']!r} runs {e['kernel']!r}, not a kernel "
                "of the port"))
        if e["route"] == "pyramid" and dispatch.route_for(
                dispatch.LevelGeom.for_level(chart, e["level"])) != \
                dispatch.ROUTE_STATIONARY_1D:
            findings.append(Finding(
                "lint", scenario, f"level {e['level']}",
                "the pyramid covers a level that is not 1-D stationary"))
    return findings


def dtype_census(groups) -> dict:
    """Bytes the launches of ``chart_launch_plans`` groups move through
    device memory, by dtype, forward and VJP."""
    out = {"forward": {}, "vjp": {}}
    for grp in groups:
        for kind in ("forward", "vjp"):
            for p in grp[kind]:
                for dt, n in p.dtype_census().items():
                    out[kind][dt] = out[kind].get(dt, 0) + n
    return out


def lint_scenario(scn, *, registers: dict | None = None) -> list:
    """All lint passes over a scenario (``scenarios.Scenario``)."""
    chart = scn.chart()
    groups = dispatch.chart_launch_plans(chart, samples=scn.samples,
                                         dtype=scn.storage, pyramid=True)
    findings = lint_route_coverage(chart, samples=scn.samples,
                                   dtype=scn.storage, scenario=scn.label)
    for grp in groups:
        for kind in ("forward", "vjp"):
            for i, p in enumerate(grp[kind]):
                findings += lint_plan(
                    p, registers=registers, scenario=scn.label,
                    location=f"level {grp['level']} {kind}[{i}]")
    census = dtype_census(groups)
    stray = {k: {dt: n for dt, n in v.items() if dt != scn.storage}
             for k, v in census.items()}
    for kind, bad in stray.items():
        if bad:
            findings.append(Finding(
                "lint", scn.label, kind,
                f"{scn.storage} launches move {bad} bytes in other dtypes"))
    return findings
