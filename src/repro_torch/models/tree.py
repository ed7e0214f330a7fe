"""Nested dicts, lists and tuples of tensors: the parameter and cache
trees of the LM port. ``tree_leaves`` is the port's own
(``kernels.policy``): dicts in sorted key order, the JAX package's pytree
order."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.policy import tree_leaves

__all__ = ["tree_index", "tree_leaves", "tree_map", "tree_stack",
           "tree_store", "tree_unflatten"]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` leaf by leaf over `tree` and any `rest` trees of its
    structure (``jax.tree.map``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_stack(trees: list):
    """Trees of one structure -> one tree, each leaf stacked on a new
    leading axis (the JAX package's ``jax.vmap`` over groups)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def tree_index(tree, i: int):
    """Row `i` of every leaf: views, so writes land in the stacked leaf."""
    return tree_map(lambda x: x[i], tree)


def tree_store(dst, src) -> None:
    """Copy `src` into `dst` leaf by leaf, in place (a leaf that is
    already the same tensor is left alone)."""
    if isinstance(dst, torch.Tensor):
        if dst is not src:
            dst.copy_(src)
        return
    if isinstance(dst, dict):
        for k in dst:
            tree_store(dst[k], src[k])
        return
    for d, s in zip(dst, src):
        tree_store(d, s)


def tree_unflatten(like, leaves):
    """`like`'s structure with its leaves, in ``tree_leaves`` order,
    replaced by `leaves` (``jax.tree_util.tree_unflatten``)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)
