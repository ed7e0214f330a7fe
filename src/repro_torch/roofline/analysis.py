"""A per-kernel roofline of an entry point, from a ``torch.profiler`` trace.

The counterpart of the JAX package's ``roofline/analysis.py`` and
``hlo_cost.py``, which read the compiled HLO's cost analysis. The port
has no HLO: it reads the device events of a profiler trace of one call of
an entry (an apply, a VJP, a fit step, a served slab), attributes their
time to the port's kernels by symbol (``core.graphs.wrapper_of_kernel``
for mangled names, ``kernel_of_event`` for the profiler's demangled ones)
and to all other work by op name, and sets each kernel's time against its
bound: the bytes its launch plans move (``LaunchPlan.hbm_bytes``) at the
H100's 3.35 TB/s.

``attribute`` is a plain function over the trace's event dicts (Chrome
trace format: ``name``, ``cat``, ``dur`` in µs), so a CPU trace (its
``cpu_op`` events standing in for device ones) tests it; ``profile``
takes the trace of a callable on the card.
"""
from __future__ import annotations

import collections
import json
import os
import re
import tempfile

__all__ = ["HBM_BYTES_PER_S", "DEVICE_CATS", "kernel_of_event", "attribute",
           "model_flops_train", "model_flops_decode",
           "roofline", "profile"]

HBM_BYTES_PER_S = 3.35e12   # the H100 SXM's device-memory rate
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_DEMANGLED = re.compile(
    r"(refine_1d_stationary_adj_kernel|refine_1d_charted_adj_kernel|"
    r"refine_1d_stationary_kernel|refine_1d_charted_kernel|"
    r"refine_nd_fused_kernel|refine_pyramid_kernel|sym_eig_thread_kernel|"
    r"sym_eig_warp_kernel)"
    r"<(?:float|__nv_bfloat16)(?:, (true|false|1|0))?")


def kernel_of_event(name: str) -> str | None:
    """The ``build.LAUNCHES`` name of a port kernel's event, mangled or
    demangled (``repro::refine_1d_charted_kernel<float, true, ...>``), or
    None for any other event."""
    from repro_torch.core.graphs import (_ONE_INSTANCE, _WRAPPER_OF,
                                         wrapper_of_kernel)

    w = wrapper_of_kernel(name)
    if w is not None:
        return w
    m = _DEMANGLED.search(name)
    if m is None:
        return None
    stem = _WRAPPER_OF[m.group(1)]
    if stem in _ONE_INSTANCE:
        return stem
    return stem + ("" if m.group(2) in ("true", "1") else "_nn")


def _op_name(name: str) -> str:
    """Other device work by op: the name without template arguments or
    parameters."""
    name = re.sub(r"^void ", "", name)
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:80] or name[:80]


def attribute(events, *, device_cats=DEVICE_CATS) -> dict:
    """Device time of a trace's events: ``kernels`` (per port kernel: ms
    and events), ``other`` (ms per op name), ``device_ms`` (all of it) and
    ``kernel_ms`` (the port's kernels)."""
    kernels = collections.defaultdict(lambda: [0.0, 0])
    other = collections.Counter()
    for e in events:
        if e.get("cat") not in device_cats or e.get("ph", "X") != "X":
            continue
        ms = float(e.get("dur", 0.0)) * 1e-3
        w = kernel_of_event(e["name"])
        if w is None:
            other[_op_name(e["name"])] += ms
        else:
            kernels[w][0] += ms
            kernels[w][1] += 1
    kern = {w: {"ms": ms, "events": n} for w, (ms, n) in
            sorted(kernels.items())}
    kernel_ms = sum(v["ms"] for v in kern.values())
    return {"kernels": kern, "other": dict(other.most_common()),
            "kernel_ms": kernel_ms,
            "device_ms": kernel_ms + sum(other.values())}


def roofline(attrib: dict, plans, *, calls: int = 1,
             bandwidth: float = HBM_BYTES_PER_S, top: int = 6) -> dict:
    """Each kernel's time in ``attrib`` (``calls`` calls of the entry)
    against its bound: the bytes of its launch plans of one call
    (``plans``) at ``bandwidth``, per call. -> per kernel ``ms``,
    ``bound_ms``, ``share`` (bound over time) and ``launches``; the
    whole entry's ``kernel_ms``, ``device_ms``, ``bound_ms``, ``share``;
    and under ``other`` the ``top`` other ops by device ms per call."""
    bytes_of = collections.Counter()
    launches = collections.Counter()
    for p in plans:
        bytes_of[p.kernel] += p.hbm_bytes()
        launches[p.kernel] += 1
    rows = {}
    for w in sorted(set(bytes_of) | set(attrib["kernels"])):
        ms = attrib["kernels"].get(w, {}).get("ms", 0.0) / calls
        bound = bytes_of[w] / bandwidth * 1e3
        rows[w] = {"ms": ms, "bound_ms": bound, "launches": launches[w],
                   "share": bound / ms if ms else None}
    kernel_ms = attrib["kernel_ms"] / calls
    bound = sum(r["bound_ms"] for r in rows.values())
    other = sorted(attrib["other"].items(), key=lambda kv: -kv[1])[:top]
    return {"kernels": rows, "kernel_ms": kernel_ms,
            "device_ms": attrib["device_ms"] / calls, "bound_ms": bound,
            "share": bound / kernel_ms if kernel_ms else None,
            "other": {name: ms / calls for name, ms in other}}


def profile(fn, *, calls: int = 5, cuda: bool = True) -> list:
    """The Chrome-trace events of ``calls`` calls of ``fn`` (after one
    call outside the trace) under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    if cuda:
        torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def model_flops_train(n_params_active: int, tokens: int) -> float:
    """6·N·D (forward 2ND + backward 4ND), the JAX package's MFU
    numerator for a train step."""
    return 6.0 * n_params_active * tokens


def model_flops_decode(n_params_active: int, tokens: int) -> float:
    """2·N per generated token (forward only)."""
    return 2.0 * n_params_active * tokens
