"""Storage/accumulation dtype policy of the refinement stack.

Refinement is memory-bound: a level reads the coarse field and ξ once and
writes the fine field once. So the policy splits each array's life in two:

``storage_dtype``
    what lives in device memory between levels: fields, ξ, matrices.
    bfloat16 halves the bytes of every level.
``accum_dtype``
    what the kernels accumulate in. Always float32 for bf16 storage:
    refinement is a long chain of small contractions.

``DtypePolicy()`` is the mixed policy (bf16 storage, f32 accumulation);
``FP32`` is the all-float32 opt-out. ``resolve(None)`` is ``FP32``, so a
model is float32 unless it asks for mixed precision, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dtypes import as_dtype


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Storage/accumulation dtype pair; hashable, any dtype spelling."""

    storage_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "storage_dtype", as_dtype(self.storage_dtype))
        object.__setattr__(self, "accum_dtype", as_dtype(self.accum_dtype))

    def cast_storage(self, tree):
        """Cast every tensor of a nested list/tuple/dict to the storage
        dtype; ``None`` leaves pass through."""
        return cast_tree(tree, self.storage_dtype)


def cast_tree(tree, dtype: torch.dtype):
    """Cast every tensor of a nested list/tuple/dict to `dtype`."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype)
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    raise TypeError(f"cannot cast {type(tree)}")


def tree_leaves(tree) -> list:
    """The tensors of a nested list/tuple/dict, dicts in sorted key order
    (the JAX package's pytree order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [leaf for sub in tree for leaf in tree_leaves(sub)]


BF16 = DtypePolicy()                                   # the mixed policy
FP32 = DtypePolicy(torch.float32, torch.float32)       # the opt-out

_ALIASES = {
    "bf16": BF16, "bfloat16": BF16, "mixed": BF16, "default": BF16,
    "fp32": FP32, "float32": FP32, "f32": FP32,
}


def resolve(policy) -> DtypePolicy:
    """Coerce ``None`` / an alias string / a DtypePolicy to a DtypePolicy
    (``None`` is ``FP32``)."""
    if policy is None:
        return FP32
    if isinstance(policy, DtypePolicy):
        return policy
    if isinstance(policy, str):
        try:
            return _ALIASES[policy.lower()]
        except KeyError:
            raise ValueError(
                f"unknown dtype policy {policy!r}; expected one of "
                f"{sorted(_ALIASES)} or a DtypePolicy") from None
    raise TypeError(f"cannot resolve dtype policy from {type(policy)}")
