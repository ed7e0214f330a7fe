"""Launch plans: one record per CUDA launch of the port's kernels.

The counterpart of the JAX package's ``kernels/launch.py``. A
:class:`LaunchPlan` describes one launch of a ``csrc/*.cu`` kernel:

* the library, its C entry and the ``build.LAUNCHES`` name it counts
  under (``kernel``);
* the template instance: storage dtype, ``NOISE``, ``CHARTED``, the
  stencil ``(n_fsz, n_csz)``, families per thread and rows per thread;
* grid, block and dynamic shared memory;
* every operand with its shape and dtype (its bytes follow);
* the ownership maps (a tuple of :class:`Group`, built on demand): for every
  unit of work (a thread of the streaming 1-D kernels, a tile of #9 and
  #10) the box of each output it writes, the box of each input it reads
  and the box of each input its families need by the refinement's
  definition (a family ``t`` reads the coarse window ``[t·s, t·s +
  n_csz)``; an adjoint output gathers from the families whose windows
  reach it). The maps follow the index math of ``csrc/*.cu``, as
  vectorised numpy arrays of box corners.

The wrappers build their plan from the geometry they already compute
(``icr_refine.stream_shape_1d`` / ``charted_shape_1d``,
``nd_fused.nd_tile``, the pyramid's table) and launch through
:func:`run_plan`, which checks every tensor against the plan's operands
and hands the plan's grid and shared memory to the C entry; the C entry
derives both itself and returns :data:`PLAN_MISMATCH` where they differ.
So a proof about a plan (``analysis/kernel_verify.py``) is a proof about
the launch, and ``dispatch.level_launch_plans`` / ``chart_launch_plans``
rebuild the same records from geometry alone, without a tensor.

``recording()`` collects the plans of the launches made inside it;
``core/graphs.capture`` holds a captured graph's kernel nodes (grid,
block, shared memory) against them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import types
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from . import build

__all__ = ["Operand", "Boxes", "Group", "LaunchPlan",
           "PLAN_MISMATCH", "PlanMismatchError", "run_plan", "recording",
           "THREADS", "SMEM_BLOCK_LIMIT", "dtype_name"]

THREADS = 256                   # threads per block of every kernel
SMEM_BLOCK_LIMIT = 227 * 1024   # shared memory one H100 block may take
PLAN_MISMATCH = build.PLAN_MISMATCH
PlanMismatchError = build.PlanMismatchError

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float64": 8}
_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float64": torch.float64}


def dtype_name(dtype) -> str:
    """``"float32"`` / ``"bfloat16"`` of a torch dtype or a name."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Operand:
    """One tensor of a launch; ``out`` marks what the kernel writes."""

    name: str
    shape: tuple
    dtype: str
    out: bool = False

    @property
    def itemsize(self) -> int:
        return _ITEMSIZE[self.dtype]

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.itemsize


@dataclasses.dataclass(frozen=True)
class Boxes:
    """Half-open boxes ``[lo, hi)`` in an operand's index space, one per
    unit of work: ``lo``/``hi`` are ``(units, ndim)`` int64 arrays. A box
    with ``lo == hi`` on some axis is empty (the unit does not touch the
    operand)."""

    lo: np.ndarray
    hi: np.ndarray

    @classmethod
    def of(cls, *axes) -> "Boxes":
        """Boxes from one ``(lo, hi)`` pair of per-unit arrays (or ints)
        per axis; with ints only, one box that every unit shares."""
        n = max(np.size(v) for lo_hi in axes for v in lo_hi)
        lo = np.stack([np.broadcast_to(np.asarray(a[0], np.int64), (n,))
                       for a in axes], axis=1)
        hi = np.stack([np.broadcast_to(np.asarray(a[1], np.int64), (n,))
                       for a in axes], axis=1)
        return cls(lo, hi)

    def empty(self) -> np.ndarray:
        return (self.hi <= self.lo).any(axis=1)

    def masked(self, keep: np.ndarray) -> "Boxes":
        """The same boxes with the units outside `keep` made empty (a box
        every unit shares stays as it is)."""
        if len(self.lo) == 1 or keep.all():
            return self
        keep = keep[:, None]
        return Boxes(np.where(keep, self.lo, 0), np.where(keep, self.hi, 0))


@dataclasses.dataclass(frozen=True)
class Group:
    """The units of one pass of a launch: one group per launch, or one per
    level of the pyramid. ``spaces`` gives the index space (shape) of each
    name the maps use: an operand, or a view of one (the N-D output on its
    4-axis form; a level's padded input); ``buffers`` names the operand a
    view is stored in, where it is not an operand itself; ``reflect`` maps
    an input read in padded coordinates to its stored extents and reflect
    padding per axis."""

    label: str
    spaces: Mapping
    writes: Mapping
    reads: Mapping
    needs: Mapping
    buffers: Mapping = dataclasses.field(default_factory=dict)
    reflect: Mapping = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """A statically analysable record of one CUDA launch (module
    docstring). ``smem_budget`` is what the tile chooser budgeted (#9,
    #10: ``nd_fused._smem_floats`` of the tile), beside ``smem``, the C
    entry's own formula transcribed."""

    kernel: str
    library: str
    entry: str
    instance: Mapping
    grid: tuple
    block: tuple
    smem: int
    operands: tuple
    smem_budget: Optional[int] = None
    # () -> the groups of what each unit writes, reads and needs
    ownership: Optional[Callable[[], tuple]] = dataclasses.field(
        default=None, compare=False, repr=False)
    # name -> (shape, torch dtype): what ``run_plan`` holds each tensor to
    expect: Mapping = dataclasses.field(init=False, compare=False,
                                        repr=False)

    def __post_init__(self):
        # plans are cached: every caller of one geometry shares one record
        object.__setattr__(self, "instance",
                           types.MappingProxyType(dict(self.instance)))
        object.__setattr__(self, "expect", types.MappingProxyType(
            {op.name: (tuple(op.shape), _TORCH_DTYPE[op.dtype])
             for op in self.operands}))

    @property
    def storage(self) -> str:
        return self.instance["dtype"]

    @property
    def node(self) -> tuple:
        """(kernel, grid, block, smem): what a captured graph's kernel node
        of this launch carries."""
        return (self.kernel, tuple(self.grid), tuple(self.block),
                int(self.smem))

    def hbm_bytes(self) -> int:
        """Bytes the launch must move: each operand once, the pyramid's
        scratch buffers (resident in the L2) not counted."""
        return sum(self.dtype_census().values())

    def dtype_census(self) -> dict:
        """Bytes crossing device memory by dtype, as ``hbm_bytes``."""
        out: dict = {}
        for op in self.operands:
            if not op.name.startswith("scratch"):
                out[op.dtype] = out.get(op.dtype, 0) + op.nbytes
        return out

    def describe(self) -> dict:
        """JSON-safe form for fingerprints and the CLI."""
        return {"kernel": self.kernel, "entry": self.entry,
                "instance": dict(self.instance), "grid": list(self.grid),
                "block": list(self.block), "smem": int(self.smem),
                "operands": [[op.name, list(op.shape), op.dtype,
                              "out" if op.out else "in"]
                             for op in self.operands]}


_RECORDS: list = []   # the lists of the active ``recording()`` blocks


@contextlib.contextmanager
def recording():
    """Collect the plans of the launches made inside the block (a list,
    in launch order); blocks nest, each collecting its own."""
    plans: list = []
    _RECORDS.append(plans)
    try:
        yield plans
    finally:
        _RECORDS.pop()   # the blocks nest: the last one is this one


def run_plan(plan: LaunchPlan, tensors: Mapping, *args) -> None:
    """Launch ``plan``: check every tensor named by an operand of the plan
    (shape, dtype, a contiguous tensor on one CUDA device), then call the
    C entry with ``args`` followed by the plan's grid (x, y) and dynamic
    shared memory, which the entry compares with its own derivation.
    Counts the launch in ``build.LAUNCHES`` and records the plan."""
    device = None
    for name, t in tensors.items():
        if t is None:
            continue
        shape, dtype = plan.expect[name]
        if t.shape != shape or t.dtype != dtype:
            raise PlanMismatchError(
                f"{plan.kernel}: {name} is {tuple(t.shape)} "
                f"{dtype_name(t.dtype)}, the plan says {shape} "
                f"{dtype_name(dtype)}")
        if not t.is_cuda:
            raise ValueError(f"{plan.kernel}: {name} is on {t.device}, "
                             "expected cuda")
        if not t.is_contiguous():
            raise ValueError(f"{plan.kernel}: {name} is not contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{plan.kernel}: operands on {device} and "
                             f"{t.device}")
    if device is None:
        raise ValueError(f"{plan.kernel}: no operand given")
    build.launch(plan.library, plan.entry, device, *args,
                 int(plan.grid[0]), int(plan.grid[1]), int(plan.smem))
    build.LAUNCHES[plan.kernel] += 1
    for plans in _RECORDS:
        plans.append(plan)
