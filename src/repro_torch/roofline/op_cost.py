"""The dry run's cost model over the aten ops a step issues.

The counterpart of the JAX package's ``roofline/hlo_cost.py``, which
parses a compiled module's HLO. The port compiles nothing: it runs the
step eagerly, on ``meta`` tensors (the card's program, with nothing
computed or allocated; ``layers._low_on_card`` takes the card's branch
there) or on the card, under :class:`OpCounter`, a ``TorchDispatchMode``
that sees every aten op, the autograd engine's backward and the
checkpoints' recomputes included. ``module_costs`` returns the keys of
the JAX package's ``module_costs``:

* ``flops``: matmul, bmm, convolution and attention FLOPs, by the
  formulas of ``torch.utils.flop_counter`` (what ``FlopCounterMode``
  counts); ``flops_by_op`` splits them by op.
* ``bytes``: each op's tensor operands plus its outputs. Eager ops are
  not fused, so every op reads and writes device memory; views and the
  allocation of empty tensors move nothing.
* ``coll_bytes``, ``coll_by_kind``, ``coll_counts``: the executor's
  counts (``distributed/executor.py``) in the per-device terms of
  ``analysis.collective_bytes``: an all-gather's output, a
  reduce-scatter's output times its group, twice an all-reduce's output.
* ``custom_calls``: the port's CUDA kernels by name (the launch plans of
  the work, ``kernels/launch.py``), their count and their plans'
  ``hbm_bytes``.

The JAX module walks its while loops and multiplies each body by its
trip count, because XLA's cost analysis visits a loop body once. An
eager loop issues every iteration's ops, so there is no trip-count
correction to port.

Each op is attributed to its owner (``shard_ctx.owner``): the slot whose
body issued it (a line's activations: its slot (d, 0)), or the home
device; an op of the autograd engine's
backward to the owner of its inputs (a slot's saved tensors or
gradients). An owner's weight counts its ops that many times, and so
does ``shard_ctx.times()`` (the executor's representative-row mode). Memory is tracked per owner as if
each were its own device: every storage an op allocates belongs to the
owner that made it until the storage dies; ``peak`` is each owner's most
live bytes.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.models.shard_ctx import _CTX
from repro_torch.roofline.analysis import (collective_bytes,
                                           collective_counts)

__all__ = ["HOME", "JAX_KIND", "OpCounter", "module_costs"]

HOME = "home"
# the executor's collective kinds -> the JAX package's HLO names
JAX_KIND = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
            "all_reduce": "all-reduce"}
# ops that move no bytes: allocation without a write, metadata
_FREE = {"empty", "empty_strided", "empty_like", "lift_fresh", "detach",
         "_local_scalar_dense", "alias", "set_", "resize_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(items) -> list:
    """The tensors among `items` and the lists and tuples in them."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


class OpCounter(TorchDispatchMode):
    """Counts a step's ops (see the module docstring): ``flops``,
    ``bytes`` (weighted totals), ``flops_by_op``, ``bytes_by_op``,
    ``ops``; per owner
    ``by_owner[owner] = {"flops", "bytes"}`` and ``peak[owner]`` (bytes).
    Owners are ``HOME`` or a slot ``(d, m)``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.flops_by_op: collections.Counter = collections.Counter()
        self.bytes_by_op: collections.Counter = collections.Counter()
        self.by_owner: dict = collections.defaultdict(
            lambda: {"flops": 0.0, "bytes": 0.0})
        self.live: collections.Counter = collections.Counter()
        self.peak: collections.Counter = collections.Counter()
        self._tags = WeakIdKeyDictionary()
        self._storages: dict = {}
        self._last = (HOME, 1)

    # -- owners ----------------------------------------------------------------
    def _owner(self, tensors) -> tuple:
        who = _CTX["owner"]
        if who is not None:
            return who
        if not tensors:
            # a factory in the backward: the owner of the op before it
            return self._last
        found = None
        for t in tensors:
            tag = self._tags.get(t)
            if tag is not None:
                if tag[0] != HOME:
                    return tag
                found = found or tag
        return found or (HOME, 1)

    # -- memory ----------------------------------------------------------------
    def _free(self, key) -> None:
        who, n = self._storages.pop(key)
        self.live[who] -= n

    def _allocate(self, t: torch.Tensor, who, seen: set) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in seen or key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = (who, n)
        self.live[who] += n
        self.peak[who] = max(self.peak[who], self.live[who])
        weakref.finalize(st, self._free, key)

    # -- the mode --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + (_tensors(kwargs.values()) if kwargs else [])
        outs = _tensors((out,))
        who = self._last = self._owner(ins)
        slot, w = who
        w *= _CTX["times"]
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            f = w * flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.flops_by_op[packet.__name__] += f
            self.by_owner[slot]["flops"] += f
        if not func.is_view and packet.__name__ not in _FREE:
            b = w * (sum(_nbytes(t) for t in ins)
                     + sum(_nbytes(t) for t in outs))
            self.bytes += b
            self.bytes_by_op[packet.__name__] += b
            self.by_owner[slot]["bytes"] += b
        if not func.is_view:
            seen = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                self._allocate(t, slot, seen)
        for t in outs:
            self._tags[t] = who
        return out


def module_costs(counter: OpCounter, counts: dict | None = None,
                 plans=(), devices: int = 1) -> dict:
    """The JAX package's ``module_costs`` keys, per device: the counter's
    totals over `devices` (the per-device program of a mesh whose slots
    share the work), the executor's collective ``counts`` per device,
    and the launch ``plans``' kernels."""
    coll = collective_bytes(counts or {})
    calls = collective_counts(counts or {})
    custom = collections.defaultdict(
        lambda: {"count": 0, "bytes": 0.0, "pallas": False})
    for p in plans:
        custom[p.kernel]["count"] += 1
        custom[p.kernel]["bytes"] += float(p.hbm_bytes())
    return {"flops": counter.flops / devices,
            "bytes": counter.bytes / devices,
            "coll_bytes": coll.pop("total"),
            "coll_by_kind": {k: v for k, v in coll.items() if v},
            "coll_counts": {k: v for k, v in calls.items() if v},
            "custom_calls": dict(custom),
            "flops_by_op": {k: v / devices for k, v in
                            counter.flops_by_op.items()}}
