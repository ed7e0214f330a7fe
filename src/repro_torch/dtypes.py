"""Dtype names for the port.

The JAX package spells dtypes as numpy/ml_dtypes names (``"float32"``,
``"bfloat16"``) and as HLO short names (``"f32"``, ``"bf16"``). The port
accepts both spellings and resolves them to ``torch.dtype`` here, in one
place, for the dtype policy and for arrays carried across (``convert``).
"""
from __future__ import annotations

import torch

__all__ = ["as_dtype"]

_NAMES = {
    "float32": torch.float32, "f32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "f16": torch.float16,
    "float64": torch.float64, "f64": torch.float64,
}


def as_dtype(dtype) -> torch.dtype:
    """``torch.dtype`` for a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", dtype)
    if isinstance(dtype, type):  # numpy scalar types: np.float32, ...
        name = dtype.__name__
    try:
        return _NAMES[str(name)]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype!r}") from None

