"""Carry the JAX package's arrays across to the port.

The JAX package's matrices dict (``sqrt0``; ``R``/``sqrtD`` per level;
``Rax``/``sqrtDax`` per level and axis) and its ξ lists reach the port as
numpy arrays (``np.asarray`` of each leaf) and become tensors here, with
the nesting kept. bfloat16 arrays (numpy's ml_dtypes extension type) go
through float32, which holds every bfloat16 value exactly.

A fit carries across the same way: ``posterior_to_torch`` turns a JAX
``Posterior``'s ``mean``/``log_std`` lists and θ dict, as numpy arrays,
into the port's ``Posterior``.

The LM port's trees carry across leaf for leaf: ``lm_params_to_torch``
takes the JAX package's ``Model.init_params`` tree and
``lm_cache_to_torch`` its ``init_cache`` / ``serve_step`` cache tree (as
numpy arrays) to the port's, keeping the nesting: dicts, the head and
tail lists, the groups stacked on their leading axis, the recurrent
states' tuples. ``lm_opt_state_to_torch`` carries an optimizer state
(``OptState(step, inner)``: AdamW's ``m``/``v``, Adafactor's per-leaf
``v`` or ``vr``/``vc``, SGD's velocity or None) to the port's
``optim.OptState``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dtypes import as_dtype

__all__ = ["to_torch", "matrices_to_torch", "xi_to_torch",
           "posterior_to_torch", "lm_params_to_torch", "lm_cache_to_torch",
           "lm_opt_state_to_torch"]


def to_torch(tree, *, device="cuda", dtype=None):
    """Numpy arrays of a nested dict/list/tuple -> tensors on `device` (the
    card by default, as ``ICR``), in `dtype` (default: each array's own
    dtype)."""
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


def matrices_to_torch(mats: dict, *, device="cuda", dtype=None) -> dict:
    """The JAX package's ``ICR.matrices()`` dict as the port's."""
    return to_torch(dict(mats), device=device, dtype=dtype)


def xi_to_torch(xi, *, device="cuda", dtype=None) -> list:
    """A ξ list (one array per level) as the port's."""
    return list(to_torch(list(xi), device=device, dtype=dtype))


def posterior_to_torch(icr, mean, log_std=None, theta=None, *, dtype=None):
    """A JAX fit as the port's ``Posterior`` over `icr`: ``mean`` and
    ``log_std`` are ξ-shaped lists of numpy arrays (``log_std`` None for a
    MAP fit), ``theta`` a dict of numpy scalars or None. Tensors land on
    ``icr.device``; ``dtype`` defaults to the policy's storage dtype for ξ,
    and θ stays float32."""
    from repro_torch.core.vi import Posterior

    dtype = icr.policy.storage_dtype if dtype is None else dtype
    kw = dict(device=icr.device, dtype=dtype)
    return Posterior(
        icr=icr, mean=xi_to_torch(mean, **kw),
        log_std=None if log_std is None else xi_to_torch(log_std, **kw),
        theta=None if theta is None else to_torch(
            dict(theta), device=icr.device, dtype=torch.float32))


def lm_params_to_torch(params, *, device="cuda"):
    """The JAX package's LM parameter tree, as numpy arrays, as the
    port's (each leaf in its own dtype)."""
    return to_torch(params, device=device)


def lm_cache_to_torch(cache, *, device="cuda"):
    """The JAX package's LM decode cache, as numpy arrays, as the port's
    (each leaf in its own dtype)."""
    return to_torch(cache, device=device)


def lm_opt_state_to_torch(state, *, device="cuda"):
    """The JAX package's ``OptState`` (its leaves as numpy arrays) as the
    port's: the step an int32 0-d tensor, ``inner`` leaf for leaf in its
    own dtype (None stays None)."""
    from repro_torch.optim import OptState

    return OptState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        inner=to_torch(state.inner, device=device))
