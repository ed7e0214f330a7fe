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
``layers`` and ``moe`` run each model slot at its local sizes through
``executor()``; ``replicate`` gathers the model blocks of a layer kind
that computes replicated; ``constrain`` is the identity (the executor
lays activations out explicitly at those branches). ``clear()`` unbinds.

``owner()`` names who runs the ops being issued, for the dry run's op
counter (``roofline/op_cost.py``): ``("home", w)`` or ``((d, m), w)``,
``w`` the times each op counts (the representative-row mode runs one
data index for all), or None where the counter reads it off the ops'
inputs (the autograd engine's backward). ``owning`` sets it; ``remat``
(``layers``) restores its caller's owner when it recomputes. ``times()``
multiplies every op and collective counted (``repeating``: one
microbatch standing for all of an accumulation).
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


def constrain(x, roles: Sequence[Optional[str]]):
    """Constrain x's sharding by logical roles; the identity (with no
    mesh, and under the executor, which places activations itself)."""
    return x
