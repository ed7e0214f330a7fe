"""Logical activation-sharding context for model code.

Model code calls ``constrain(x, ("data", None, "model", None))`` with
*logical* axis roles and ``gather_fsdp(tree)`` on a layer group's
parameters, as in the JAX package's ``repro.models.shard_ctx``. With no
mesh bound both are the identity and ``model_size()`` is 1: the model
runs its one-slot path.

``set_axes(mesh, data_axes, model_axes)`` binds a mesh: it builds the
port's sharded executor (``distributed/executor.py``), whose hooks these
calls then are. ``gather_fsdp`` all-gathers each leaf's FSDP blocks into
its model-axis blocks; the tensor-parallel branches of ``attention``,
``layers``, ``moe`` and ``ssm`` run each model slot at its local sizes through
``executor()``; ``columns`` and ``rows`` are a product with a weight's
column or row blocks per model slot; ``replicate`` gathers the model
blocks of a leaf that computes replicated. ``constrain`` stays the
identity: the executor places every activation itself, each line's
rows on its own slots (GSPMD's batch over the data axes), so a
constraint has nothing left to move. ``clear()`` unbinds.

``line_stats(fn, *args)`` is the loss's cross-line reduction: with no
mesh ``fn(*args)``; on a mesh whose lines hold the batch's rows, ``fn``
runs once per line and the lines' sums and means come back reduced over
the global batch (``Executor.line_stats``).

``owner()`` names who runs the ops being issued, for the dry run's op
counter (``roofline/op_cost.py``): ``("home", w)`` or ``((d, m), w)``,
``w`` the times each op counts (the representative-row mode runs one
data index for all), or None where the counter reads it off the ops'
inputs (the autograd engine's backward). ``owning`` sets it; ``remat``
(``layers``) takes a ``snapshot`` of the owner and the running line and
recomputes ``restored`` to it. ``times()`` multiplies every op and
collective counted (``repeating``: one microbatch standing for all of an
accumulation).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

_CTX: dict = {"executor": None, "owner": None, "times": 1}


def owner():
    """Who runs the ops issued now (see the module docstring)."""
    return _CTX["owner"]


def times() -> int:
    """How many times each op and collective counts now."""
    return _CTX["times"]


@contextlib.contextmanager
def repeating(n: int):
    """Count the block's ops and collectives `n` times."""
    prev = _CTX["times"]
    _CTX["times"] = prev * n
    try:
        yield
    finally:
        _CTX["times"] = prev


@contextlib.contextmanager
def owning(who):
    """Issue the ops of the block as `who` (None: read off the inputs)."""
    prev, _CTX["owner"] = _CTX["owner"], who
    try:
        yield
    finally:
        _CTX["owner"] = prev


def snapshot() -> tuple:
    """The owner and the bound executor's running line, for a
    recompute."""
    ex = _CTX["executor"]
    return _CTX["owner"], None if ex is None else ex.line


@contextlib.contextmanager
def restored(snap: tuple):
    """Issue the block as the ``snapshot`` was taken: its owner, and its
    line on the bound executor."""
    who, line = snap
    ex = _CTX["executor"]
    prev = None if ex is None else ex.line
    if ex is not None:
        ex.line = line
    try:
        with owning(who):
            yield
    finally:
        if ex is not None:
            ex.line = prev


def set_axes(mesh, data_axes, model_axes):
    """Bind `mesh` (data axes, then one model axis); returns the
    executor."""
    from repro_torch.distributed.executor import Executor

    return bind(Executor(mesh, tuple(data_axes), tuple(model_axes)))


def bind(executor):
    """Bind an executor (None unbinds); returns it."""
    _CTX["executor"] = executor
    return executor


def clear() -> None:
    _CTX["executor"] = None


def executor():
    """The bound executor, or None."""
    return _CTX["executor"]


def model_size() -> int:
    ex = _CTX["executor"]
    return ex.M if ex is not None else 1


def gather_fsdp(param_tree):
    """The FSDP all-gather at use site: each leaf's model-axis blocks,
    rebuilt from its data-axis blocks (the identity with no mesh)."""
    ex = _CTX["executor"]
    return param_tree if ex is None else ex.gather_tree(param_tree)


def replicate(param_tree):
    """A gathered tree with its model blocks joined: for layer kinds that
    compute replicated over the model axis (the identity with no mesh)."""
    ex = _CTX["executor"]
    return param_tree if ex is None else ex.replicate_tree(param_tree)


def columns(fn, x, w):
    """``fn(x, w)`` for an `fn` acting on w's columns one by one (``x @
    w``, ``w[idx]``): column-parallel on a bound mesh where the model axis
    splits them, the column blocks all-gathered (``Executor.columns``)."""
    ex = _CTX["executor"]
    return fn(x, w) if ex is None else ex.columns(fn, x, w)


def rows(x, w):
    """``layers.matmul(x, w)``: row-parallel on a bound mesh where the
    model axis splits w's rows (``Executor.rows``)."""
    ex = _CTX["executor"]
    if ex is None:
        from .layers import matmul

        return matmul(x, w)
    return ex.rows(x, w)


def line_stats(fn, *args):
    """``fn(*args) -> (sums, means)`` over the global batch: with no mesh
    fn's result; on a mesh, fn once per line on the line's rows, the
    sums summed and the means averaged over the lines (all-reduces)."""
    ex = _CTX["executor"]
    return fn(*args) if ex is None else ex.line_stats(fn, *args)


def constrain(x, roles: Sequence[Optional[str]]):
    """Constrain x's sharding by logical roles; the identity (with no
    mesh, and under the executor, which places every activation on its
    line's slots itself)."""
    return x
