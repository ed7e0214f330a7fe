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

The JAX package's HLO half, on the dry run's counts: three roofline terms
per device (``RooflineTerms``),

  compute    = FLOPs / PEAK_FLOPS_BF16
  memory     = bytes / HBM_BW
  collective = collective bytes / NVLINK_BW

at the H100 constants of ``launch/mesh.py``. ``collective_bytes`` and
``collective_counts`` read an executor's counts (the JAX package's parse
the post-SPMD HLO text); ``analyze_step`` (the counterpart of
``analyze_compiled``) runs a step under ``op_cost.OpCounter`` and fills
``memory_per_device`` from its per-owner memory: ``fits_hbm`` against
``HBM_BYTES`` where the fullest slot and the home slot both fit.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import tempfile
from typing import Optional

from repro_torch.launch import mesh as hw

__all__ = ["DEVICE_CATS", "RooflineTerms", "analyze_step", "attribute",
           "collective_bytes", "collective_counts", "kernel_of_event",
           "model_flops_train", "model_flops_decode",
           "roofline", "profile"]

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
             bandwidth: float = hw.HBM_BW, top: int = 6) -> dict:
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


# -- the HLO half: roofline terms from the dry run's counts ----------------------
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute", "ragged-all-to-all")


def collective_bytes(counts: dict) -> dict:
    """Per-device collective traffic from an executor's ``counts`` (its
    ``device_bytes``: all-gather its output, reduce-scatter its output
    times the group, all-reduce twice its output), under the JAX
    package's kind names, with ``total``."""
    from .op_cost import JAX_KIND

    out = {k: 0 for k in _COLLECTIVES}
    for kind, c in counts.items():
        out[JAX_KIND.get(kind, kind)] += int(round(c.get("device_bytes",
                                                         0.0)))
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


def collective_counts(counts: dict) -> dict:
    """Collective calls by kind from an executor's ``counts``."""
    from .op_cost import JAX_KIND

    out = {k: 0 for k in _COLLECTIVES}
    for kind, c in counts.items():
        out[JAX_KIND.get(kind, kind)] += int(c["calls"])
    return out


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-device FLOPs
    bytes_accessed: float        # per-device memory traffic (op model)
    coll_bytes: float            # per-device collective traffic
    coll_breakdown: dict
    coll_counts: dict
    memory_per_device: Optional[dict] = None
    model_flops: float = 0.0     # 6·N·D (or 6·N_active·D) useful flops/device
    raw_xla: Optional[dict] = None  # the JAX package's raw XLA numbers: none

    @property
    def t_compute(self) -> float:
        return self.flops / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / hw.NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def flops_utilization(self) -> float:
        """Fraction of the roofline-bound step spent on useful model math
        (MODEL_FLOPS at peak): the dry run's analogue of MFU."""
        if self.bound_time == 0:
            return 0.0
        return (self.model_flops / hw.PEAK_FLOPS_BF16) / self.bound_time

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes_accessed,
            "coll_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "bound_time_s": self.bound_time,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.flops_utilization,
            "coll_breakdown": {k: v for k, v in
                               self.coll_breakdown.items() if v},
            "coll_counts": {k: v for k, v in self.coll_counts.items() if v},
            "memory_per_device": self.memory_per_device,
            "raw_xla": self.raw_xla,
        }


def memory_summary(counter, static: dict, slots) -> dict:
    """``memory_per_device`` of a counted step: per slot its placed
    blocks (``static[slot]``: parameters, optimizer state, gradients,
    cache) and the peak of what its bodies allocated; the slot with the
    most, and whether it fits the card (``slot_fits_hbm``).
    ``home_device``: the home owner's peak (what the executor still
    issues there: the loss's reduced statistics; a replicated batch's
    activations) with its own slot's blocks. ``fits_hbm`` holds only
    where both fit: the executor's first device holds the home's tensors
    as well."""
    from .op_cost import HOME

    def one(slot):
        arg, temp = int(static.get(slot, 0)), int(counter.peak[slot])
        return {"argument_bytes": arg, "temp_bytes": temp,
                "total_bytes": arg + temp}

    per = {s: one(s) for s in slots}
    worst = max(per, key=lambda s: per[s]["total_bytes"])
    mem = dict(per[worst], slot=list(worst) if isinstance(worst, tuple)
               else worst)
    mem["slot_fits_hbm"] = mem["total_bytes"] <= hw.HBM_BYTES
    first = next(iter(slots))
    home = {"argument_bytes": int(static.get(first, 0)),
            "temp_bytes": int(counter.peak[HOME])}
    home["total_bytes"] = home["argument_bytes"] + home["temp_bytes"]
    home["fits_hbm"] = home["total_bytes"] <= hw.HBM_BYTES
    mem["fits_hbm"] = mem["slot_fits_hbm"] and home["fits_hbm"]
    mem["home_device"] = home
    return mem


def analyze_step(fn, *args, model_flops_per_device: float = 0.0,
                 executor=None, static: dict | None = None, slots=None,
                 devices: int = 1, plans=()) -> tuple:
    """Run ``fn(*args)`` under ``op_cost.OpCounter`` and take the three
    roofline terms per device (the counterpart of ``analyze_compiled``):
    FLOPs and bytes over `devices`, the `executor`'s collective counts
    (read after the call), ``memory_per_device`` per slot (``static``:
    each slot's placed bytes; ``slots``: the owners to compare, default
    the home device alone). -> ``(terms, fn's result, counter)``."""
    from .op_cost import HOME, OpCounter, module_costs

    with OpCounter() as counter:
        out = fn(*args)
    counts = executor.counts if executor is not None else None
    la = module_costs(counter, counts, plans, devices)
    terms = RooflineTerms(
        flops=la["flops"], bytes_accessed=la["bytes"],
        coll_bytes=la["coll_bytes"],
        coll_breakdown=collective_bytes(counts or {}),
        coll_counts=la["coll_counts"],
        memory_per_device=memory_summary(counter, static or {},
                                         slots or [HOME]),
        model_flops=model_flops_per_device)
    return terms, out, counter
