"""Capture a computation over static buffers as one CUDA graph.

The JAX package compiles a hot step once (``jax.jit``) and calls the
executable; the port's counterpart is a ``torch.cuda.CUDAGraph`` captured
over static input buffers and replayed. A replay enqueues every kernel of
the captured region with one host call, so the host no longer pays one
wrapper call per launch.

``capture(fn, *buffers, device=...)`` runs ``fn(*buffers)`` once eagerly
on a side stream (by then every kernel library is built and loaded and
every ``cudaFuncSetAttribute`` of the launches has run), then captures one
more call into a graph with its own memory pool. It returns a replay
callable: ``replay(*new)`` ``copy_``s the new values into the leading
buffers, replays, and returns the outputs of the captured call. They
live in the graph's pool and are overwritten by the next replay. Writing
into the buffers directly and calling ``replay()`` is the same.

The captured region must not sync with the host (no ``.item()``,
``.cpu()``, ``torch.linalg`` error checks) and must not read host memory
that changes: build everything else (matrices, tables) before capture.
On a CUDA device a failed capture raises; there is no eager fallback. On
a CPU device (only when the caller asks for it) ``replay`` calls ``fn``
eagerly on the buffers, and so it does on the card inside ``with
eager():``, the one switch that runs every captured path of the port op
by op (to hold graph against eager, bit for bit).

``lru`` is the bounded cache the captured paths (and the server's
caches) keep their entries in.

Launch counts (``kernels.build.LAUNCHES``): capturing records launches
without running them, so the counts the wrappers add during capture are
taken back. The graph's own kernel nodes are then counted by their
symbols (the CUDA driver's ``cuGraphGetNodes`` and ``cuFuncGetName`` on
the kept ``cudaGraph_t``) and must equal those counts, or ``capture``
raises; every replay adds the node counts, since each replay launches
each node once. Each node's grid, block and dynamic shared memory must
also equal the launch plan (``kernels/launch.py``) its wrapper launched
through during capture, or ``capture`` raises; ``CAPTURES`` keeps the
last captures' nodes and plans, and the replay callable carries its own
(``nodes``, ``plans``).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import re
from typing import Callable

import torch

__all__ = ["capture", "eager", "eager_mode", "graph_kernel_launches",
           "lru", "wrapper_of_kernel", "CAPTURES"]

_EAGER = False   # True inside ``eager()``
# the last captures (``capture`` appends): the captured function's name,
# its graph's kernel nodes and its launch plans' nodes, each ``(wrapper,
# grid, block, smem)`` (equal as multisets, or ``capture`` raised)
CAPTURES: collections.deque = collections.deque(maxlen=64)


@contextlib.contextmanager
def eager():
    """Within the block ``capture`` returns the eager callable on every
    device, as on the CPU, and the caches of captured paths are bypassed:
    the captured paths' op-by-op twins, for comparisons."""
    global _EAGER
    before, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = before


def eager_mode() -> bool:
    """Whether ``eager()`` is in force."""
    return _EAGER


def lru(cache: dict, key, make: Callable, size: int):
    """``cache[key]``, made by ``make()`` if it is missing, as the most
    recently used entry; the least recently used beyond `size` are
    dropped (a dict keeps insertion order)."""
    value = cache.pop(key, None)
    if value is None:
        value = make()
    cache[key] = value
    while len(cache) > size:
        cache.pop(next(iter(cache)))
    return value

# the kernels' symbols (csrc/*.cu) and the wrapper names they count under;
# the 1-D kernels' second template argument is NOISE (false: ``_nn``). The
# level-0 root's cuSOLVER calls (csrc/dense_eigh.cu) are a library's
# kernels, as cuBLAS's are: no wrapper counts them
_WRAPPER_OF = {
    "refine_1d_stationary_adj_kernel": "refine_stationary_adjoint",
    "refine_1d_charted_adj_kernel": "refine_charted_adjoint",
    "refine_1d_stationary_kernel": "refine_stationary",
    "refine_1d_charted_kernel": "refine_charted",
    "refine_nd_fused_kernel": "refine_nd_fused",
    "refine_pyramid_kernel": "refine_pyramid",
    "sym_eig_thread_kernel": "sym_eig",
    "sym_eig_warp_kernel": "sym_eig",
}
# the wrappers whose kernels take no NOISE argument
_ONE_INSTANCE = ("refine_nd_fused", "refine_pyramid", "sym_eig")
# a mangled symbol: the name, then ``I`` and the template arguments, the
# storage type (``f`` or ``13__nv_bfloat16``) and a bool (``Lb1E``) first
_SYMBOL = re.compile(r"\d(" + "|".join(_WRAPPER_OF)
                     + r")I(?:f|13__nv_bfloat16)(?:Lb([01])E)?")


def wrapper_of_kernel(symbol: str) -> str | None:
    """The ``build.LAUNCHES`` name of a port kernel's mangled symbol, or
    None for any other kernel."""
    m = _SYMBOL.search(symbol)
    if m is None:
        return None
    stem = _WRAPPER_OF[m.group(1)]
    if stem in _ONE_INSTANCE:
        return stem
    if m.group(2) is None:
        raise ValueError(f"no NOISE argument in {symbol!r}")
    return stem + ("" if m.group(2) == "1" else "_nn")


class _KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = ([("func", ctypes.c_void_p)]
                + [(k, ctypes.c_uint) for k in ("gx", "gy", "gz", "bx", "by",
                                                "bz", "smem")]
                + [(k, ctypes.c_void_p) for k in ("params", "extra", "kern",
                                                   "ctx")])


def graph_kernel_launches(graph) -> list:
    """The port's kernel nodes of a captured ``torch.cuda.CUDAGraph`` made
    with ``keep_graph=True``, in node order: ``(wrapper, grid, block,
    dynamic shared memory)`` each, as ``kernels.launch.LaunchPlan.node``
    gives them."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(res, what):
        if res != 0:
            raise RuntimeError(f"{what} failed with CUresult {res}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = _KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                               ctypes.byref(p)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if p.func:
            check(cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(p.func)), "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(p.kern)),
                  "cuKernelGetName")
        wrapper = wrapper_of_kernel(name.value.decode())
        if wrapper is not None:
            out.append((wrapper, (p.gx, p.gy, p.gz), (p.bx, p.by, p.bz),
                        p.smem))
    return out


def capture(fn: Callable, *buffers, device) -> Callable:
    """One CUDA graph of ``fn(*buffers)``, as a replay callable (see the
    module docstring); the buffers are tensors. The callable has
    ``graph`` (the ``torch.cuda.CUDAGraph``, None on the CPU) and
    ``launches`` (the port's kernel nodes of the graph, by wrapper: the
    launches one replay makes)."""
    device = torch.device(device)

    def copy_in(new):
        if len(new) > len(buffers):
            raise ValueError(f"{len(new)} inputs for {len(buffers)} buffers")
        for buf, value in zip(buffers, new):
            buf.copy_(value)

    if device.type != "cuda" or _EAGER:
        def run(*new):
            copy_in(new)
            return fn(*buffers)

        run.graph, run.launches = None, collections.Counter()
        run.nodes, run.plans = None, []
        return run

    from repro_torch.kernels import build, launch

    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn(*buffers)
    current.wait_stream(side)
    torch.cuda.synchronize(device)

    graph = torch.cuda.CUDAGraph(keep_graph=True)  # its nodes are read
    before = collections.Counter(build.LAUNCHES)
    try:
        with torch.cuda.device(device), torch.cuda.graph(graph), \
                launch.recording() as plans:
            out = fn(*buffers)
    finally:  # recorded, not launched, whether or not the capture held
        captured = collections.Counter(build.LAUNCHES)
        captured.subtract(before)
        captured = +captured
        build.LAUNCHES.subtract(captured)
    graph.instantiate()
    nodes = graph_kernel_launches(graph)
    launches = collections.Counter(w for w, *_ in nodes)
    if launches != captured:
        raise RuntimeError(
            f"the graph's kernel nodes {dict(launches)} differ from the "
            f"launches its wrappers made {dict(captured)}")
    # each node's grid, block and shared memory are its launch plan's
    planned = collections.Counter(p.node for p in plans)
    if collections.Counter(nodes) != planned:
        raise RuntimeError(
            "the graph's kernel nodes differ from their launch plans: "
            f"{dict(collections.Counter(nodes) - planned)} not planned, "
            f"{dict(planned - collections.Counter(nodes))} not captured")
    CAPTURES.append({"fn": getattr(fn, "__qualname__", repr(fn)),
                     "nodes": nodes, "planned": [p.node for p in plans]})

    def replay(*new):
        copy_in(new)
        graph.replay()
        build.LAUNCHES.update(launches)
        return out

    replay.graph, replay.launches = graph, launches
    replay.nodes, replay.plans = nodes, list(plans)
    return replay
