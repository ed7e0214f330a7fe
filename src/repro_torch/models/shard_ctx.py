"""Logical activation-sharding context for model code.

Model code calls ``constrain(x, ("data", None, "model", None))`` with
*logical* axis roles, as in the JAX package's ``repro.models.shard_ctx``.
The port binds no mesh to the model yet, so both calls are the identity,
as the JAX package's are with no mesh set; binding one (``set_axes``,
``clear``, ``model_size``) comes with the port of
``distributed/sharding.py``.
"""
from __future__ import annotations

from typing import Optional, Sequence


def gather_fsdp(param_tree):
    """The FSDP all-gather at use site; the identity with no mesh."""
    return param_tree


def constrain(x, roles: Sequence[Optional[str]]):
    """Constrain x's sharding by logical roles; the identity with no
    mesh."""
    return x
