"""Gradient compression for the data-parallel all-reduce.

The JAX package's ``repro.distributed.compression``: int8 quantization
with error feedback (EF-SGD style). Each step quantizes (grad + carried
error) to int8 with a per-tensor scale shared by the slots (the max over
them), sums the int8 payloads as int32 (4x less traffic than float32),
dequantizes, and carries each slot's quantization residual into the next
step, so the compression error telescopes instead of accumulating.

The JAX package runs the sum inside ``shard_map`` over the data axes; the
port's executor drives every slot from one process, so
``compressed_psum`` takes the slots' unreduced gradients as a list of
trees, one per data slot, and their carries likewise. Like the JAX
package's train loop, the port's does not wire it in.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.models.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["compressed_psum", "make_error_feedback_state"]

PyTree = Any


def make_error_feedback_state(params: PyTree) -> PyTree:
    """Per-parameter carried quantization residual (float32)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(x: torch.Tensor):
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _psum_one(gs: Sequence[torch.Tensor], errs: Sequence[torch.Tensor]):
    """One leaf over the slots: quantize(g + err) with the max scale ->
    int32 sum -> dequantize; returns (mean_g, [err' per slot])."""
    n = len(gs)
    home = gs[0].device
    xs = [g.float() + e for g, e in zip(gs, errs)]
    # the scale must be identical on every slot for the int8 sum to be
    # meaningful -> the max scale over the slots
    scale = torch.stack([_quantize(x)[1].to(home) for x in xs]).max()
    qs = [torch.clamp(torch.round(x / scale.to(x.device)), -127,
                      127).to(torch.int8) for x in xs]
    summed = sum(q.to(home, torch.int32) for q in qs)
    mean = summed.float() * (scale / n)
    errs_new = [x - q.float() * scale.to(x.device) for x, q in zip(xs, qs)]
    return mean.to(gs[0].dtype), errs_new


def compressed_psum(grads: Sequence[PyTree], err: Sequence[PyTree],
                    mesh=None, data_axes=("data",)) -> tuple:
    """Mean-all-reduce the data slots' `grads` with int8 + error feedback.

    `grads` and `err` are lists of trees, one per data slot (as many as
    the data axes of `mesh` hold, when it is given). Returns (mean_grads,
    new_error_states): the mean on the first slot's devices, and each
    slot's carry."""
    n = len(grads)
    if mesh is not None:
        want = int(np.prod([mesh.shape[a] for a in data_axes]))
        if n != want:
            raise ValueError(f"{n} gradient trees for {want} data slots")
    if len(err) != n:
        raise ValueError(f"{len(err)} error states for {n} gradient trees")
    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(e) for e in err]
    out_g, out_e = [], [[] for _ in range(n)]
    for i in range(len(flat_g[0])):
        mg, ne = _psum_one([f[i] for f in flat_g], [f[i] for f in flat_e])
        out_g.append(mg)
        for slot, e in zip(out_e, ne):
            slot.append(e)
    return (tree_unflatten(grads[0], out_g),
            [tree_unflatten(err[k], out_e[k]) for k in range(n)])
