"""Carry the JAX package's arrays across to the port.

The JAX package's matrices dict (``sqrt0``; ``R``/``sqrtD`` per level;
``Rax``/``sqrtDax`` per level and axis) and its ξ lists reach the port as
numpy arrays (``np.asarray`` of each leaf) and become tensors here, with
the nesting kept. bfloat16 arrays (numpy's ml_dtypes extension type) go
through float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dtypes import as_dtype

__all__ = ["to_torch", "matrices_to_torch", "xi_to_torch"]


def to_torch(tree, *, device="cpu", dtype=None):
    """Numpy arrays of a nested dict/list/tuple -> tensors on `device`, in
    `dtype` (default: each array's own dtype)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device=device, dtype=dtype)
                          for v in tree)
    a = np.asarray(tree)
    src = as_dtype(a.dtype.name)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    t = torch.tensor(a).to(src)
    return t.to(device=device, dtype=as_dtype(dtype) if dtype else src)


def matrices_to_torch(mats: dict, *, device="cpu", dtype=None) -> dict:
    """The JAX package's ``ICR.matrices()`` dict as the port's."""
    return to_torch(dict(mats), device=device, dtype=dtype)


def xi_to_torch(xi, *, device="cpu", dtype=None) -> list:
    """A ξ list (one array per level) as the port's."""
    return list(to_torch(list(xi), device=device, dtype=dtype))
