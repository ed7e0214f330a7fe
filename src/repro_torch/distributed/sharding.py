"""Sharding rules: param/optimizer/activation/cache PartitionSpecs.

The JAX package's ``repro.distributed.sharding`` on the port's trees
(nested dicts, lists, tuples and NamedTuples of tensors; the ``meta``
device gives shapes with nothing allocated) and the port's
``launch.mesh.PartitionSpec``. The rules only read ``mesh.shape``, so a
stand-in with a 16x16 or 2x16x16 ``shape`` dict works for them.

Strategy — FSDP x TP hybrid:
  * column-parallel weights (in -> heads/ff/experts): last dim over
    'model', second-to-last over data axes (the FSDP slice; the executor,
    ``distributed/executor.py``, all-gathers it at use and reduce-scatters
    the gradient);
  * row-parallel weights (wo / down): 'model' on the input dim, data on the
    output dim;
  * MoE expert stacks: experts over 'model' (expert parallelism), FSDP over
    the next dim;
  * embedding (V, D): V over 'model' only; lm_head (D, V): V over 'model',
    so logits are vocab-sharded (the chunked loss combines them);
  * optimizer state inherits its parameter's spec leaf by leaf (moments
    have identical shapes; adafactor's row/col stats drop the factored-away
    axis);
  * KV caches: heads over 'model' when divisible, else the *sequence* dim;
  * every rule degrades gracefully: a dim that does not divide its mesh
    axes is replicated instead.

Multi-pod: pass data_axes=("pod", "data"); batch and FSDP shards then span
pods.

``shardings_for`` is the port's tree of ``NamedSharding``: it places a
tree on a ``launch.mesh.Mesh`` as ``elastic.Placed`` leaves
(``Mesh.shard`` through ``elastic.remesh_report``). ``BatchShardings``
places an input batch by ``batch_spec``: each data index's rows on its
slots' devices and nowhere else (at ``accum`` > 1 in the JAX package's
``micro_spec`` layout), which the sharded executor runs line by line.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np

from repro_torch.launch.mesh import Mesh, P

__all__ = ["BatchShardings", "Shardings", "batch_spec", "cache_specs", "opt_state_specs",
           "param_specs", "shardings_for", "with_batch_constraint"]

PyTree = Any

# leaf-name -> role tables (names come from models/*.py init functions)
_COL = {
    "wq", "wk", "wv", "gate", "up", "w_in", "wqkv", "w_gates", "w_dq",
    "w_uq", "w_dkv", "w_uk", "w_uv", "wo_gate", "wif", "router", "r_gates",
    "lm_head", "frontend", "pos_embed",
}
_ROW = {"wo", "down", "w_out"}
_EMBED = {"table"}
# always replicated (tiny, used every layer; stacked variants included)
_REPLICATE = {"scale", "b_up", "b_down", "bq", "bk", "bv", "bo",
              "a_log", "dt_bias", "d_skip"}


def _axes_size(mesh, axes) -> int:
    if not axes:
        return 1
    axes = (axes,) if isinstance(axes, str) else axes
    return int(np.prod([mesh.shape[a] for a in axes]))


def _fit(mesh, dim: int, axes):
    """Return axes if dim divides their product, else None (replicate)."""
    return axes if axes and dim % _axes_size(mesh, axes) == 0 else None


def _leaf_spec(path_names, shape, mesh, data_axes, model_axes) -> P:
    name = path_names[-1] if path_names else ""
    nd = len(shape)
    spec = [None] * nd
    in_moe = "moe" in path_names
    if nd == 0 or name in _REPLICATE:
        return P()
    if name in _EMBED and nd >= 2:
        # vocab over model ONLY: data-sharding d_model would put the FSDP
        # slice on the unembed contraction dim
        spec[-2] = _fit(mesh, shape[-2], model_axes)   # vocab
        spec[-1] = None
    elif in_moe and name in ("gate", "up") and nd >= 3:
        spec[-3] = _fit(mesh, shape[-3], model_axes)   # experts (EP)
        spec[-2] = _fit(mesh, shape[-2], data_axes)    # FSDP
    elif in_moe and name == "down" and nd >= 3:
        spec[-3] = _fit(mesh, shape[-3], model_axes)
        spec[-1] = _fit(mesh, shape[-1], data_axes)
    elif name in _ROW and nd >= 2:
        spec[-2] = _fit(mesh, shape[-2], model_axes)
        spec[-1] = _fit(mesh, shape[-1], data_axes)
    elif name in _COL and nd >= 2:
        spec[-2] = _fit(mesh, shape[-2], data_axes)
        spec[-1] = _fit(mesh, shape[-1], model_axes)
    elif nd >= 2:
        # unknown 2D+ leaf: FSDP the last dim only
        spec[-1] = _fit(mesh, shape[-1], data_axes)
    else:
        # 1-D (norm scales, biases): replicate (tiny, used every layer)
        return P()
    return P(*spec)


def map_with_names(fn: Callable, tree: PyTree, names: tuple = ()) -> PyTree:
    """``fn(names, leaf)`` over a tree's leaves, `names` the leaf's key
    path as strings (dict keys, sequence indices: ``steps._leaf_paths``);
    dicts, lists, tuples and NamedTuples keep their type, None stays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        items = [map_with_names(fn, v, names + (str(i),))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(names, tree)


def param_specs(params_shape: PyTree, mesh: Mesh,
                data_axes=("data",), model_axes=("model",)) -> PyTree:
    """PartitionSpec tree matching a params (or ``meta``) tree."""
    return map_with_names(
        lambda names, leaf: _leaf_spec(names, tuple(leaf.shape), mesh,
                                       data_axes, model_axes),
        params_shape)


def opt_state_specs(opt_state_shape: PyTree, mesh: Mesh,
                    data_axes=("data",), model_axes=("model",)) -> PyTree:
    """Optimizer state: same rules (moments mirror params; factored stats
    match by name so vr/vc get the surviving parameter dims' specs)."""
    def one(names, leaf):
        shape = tuple(leaf.shape)
        # strip the optimizer-state wrapper names (m/v/vr/vc/inner)
        core = tuple(n for n in names if n not in
                     ("m", "v", "vr", "vc", "inner"))
        if names and names[-1] in ("vr", "vc"):
            # factored stats lost one dim; FSDP the last dim if it fits
            spec = [None] * len(shape)
            if len(shape) >= 1:
                spec[-1] = _fit(mesh, shape[-1], data_axes)
            return P(*spec)
        return _leaf_spec(core, shape, mesh, data_axes, model_axes)

    return map_with_names(one, opt_state_shape)


def batch_spec(batch_shape: PyTree, mesh: Mesh,
               data_axes=("data",)) -> PyTree:
    """Input batches: leading (batch) dim over the data axes."""
    def one(_names, leaf):
        spec = [None] * len(leaf.shape)
        if len(leaf.shape) >= 1:
            spec[0] = _fit(mesh, leaf.shape[0], data_axes)
        return P(*spec)

    return map_with_names(one, batch_shape)


def cache_specs(cache_shape: PyTree, mesh: Mesh,
                data_axes=("data",), model_axes=("model",)) -> PyTree:
    """Decode caches. Leaves look like:
      attention k/v:     (B, S, Hkv, Dh)   [stacked: (G, B, S, Hkv, Dh)]
      MLA latent:        (B, S, R)
      mamba state:       (B, H, P, N)
      mlstm C/n/m:       (B, H, Dh[, Dh])
    Batch over data; heads over model when divisible, else sequence over
    model."""
    def one(_names, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        # the batch dim: the first dim (past a stacked group dim) that
        # divides the data axes and is at least their size
        dsz = _axes_size(mesh, data_axes)
        bdim = None
        for i, s in enumerate(shape[: max(nd - 2, 1)]):
            if s % dsz == 0 and s >= dsz:
                bdim = i
                break
        if bdim is not None:
            spec[bdim] = data_axes
        start = (bdim + 1) if bdim is not None else 0
        if bdim is None:
            # batch too small (B=1): put the data axes on the largest
            # divisible dim instead (the sequence for KV caches)
            cand_d = [i for i in range(nd - 1)
                      if shape[i] % dsz == 0 and shape[i] >= dsz]
            if cand_d:
                best_d = max(cand_d, key=lambda i: shape[i])
                spec[best_d] = data_axes
        # model axis: prefer a heads-like dim (not the last), else the
        # largest remaining divisible dim (sequence)
        msz = _axes_size(mesh, model_axes)
        cand = [i for i in range(start, nd)
                if spec[i] is None and shape[i] % msz == 0
                and shape[i] >= msz]
        if cand:
            best = max(cand, key=lambda i: (i == nd - 2, shape[i]))
            spec[best] = model_axes
        return P(*spec)

    return map_with_names(one, cache_shape)


class Shardings:
    """A spec tree bound to a mesh (the port's tree of
    ``NamedSharding``): ``place(tree)`` puts `tree` on the mesh as
    ``elastic.Placed`` leaves and raises on a spec the mesh cannot honour
    (specs built for this mesh always can)."""

    def __init__(self, spec_tree: PyTree, mesh: Mesh):
        self.spec_tree, self.mesh = spec_tree, mesh

    def place(self, tree: PyTree) -> PyTree:
        from . import elastic

        placed, report = elastic.remesh_report(tree, self.mesh,
                                               self.spec_tree)
        if report:
            raise ValueError("specs the mesh cannot honour: "
                             + "; ".join(str(d) for d in report))
        return placed


def shardings_for(spec_tree: PyTree, mesh: Mesh) -> Shardings:
    return Shardings(spec_tree, mesh)


class BatchShardings(Shardings):
    """An input batch's placement (the ``batch_sh`` of the JAX package's
    ``jit_for``): ``batch_spec`` over `batch_tree`'s shapes, leading dim
    over the data axes where it divides, else replicated.

    At ``accum`` > 1 each leaf is placed as ``(accum, B / accum, ...)``
    with the data axes on dim 1, the layout of the JAX package's
    ``micro_spec``: data index d holds its rows of every microbatch, so
    no microbatch crosses data indices. ``place`` copies to each distinct
    (device, data index) only that data index's rows (slots sharing both
    share the tensor); ``pin``: each block staged in pinned host memory
    and copied without blocking (the caller orders the copies)."""

    def __init__(self, batch_tree: PyTree, mesh: Mesh, data_axes=("data",),
                 accum: int = 1):
        import torch

        self.accum, self.data_axes = accum, tuple(data_axes)

        def micro(names, leaf):
            shape = tuple(leaf.shape)
            if accum > 1:
                if shape[0] % accum:
                    raise ValueError(f"batch {shape[0]} does not split "
                                     f"into {accum} microbatches")
                shape = (accum, shape[0] // accum) + shape[1:]
            return torch.empty(shape, device="meta")

        shapes = map_with_names(micro, batch_tree)
        specs = batch_spec(
            map_with_names(lambda _n, x: x[0] if accum > 1 else x, shapes),
            mesh, data_axes)
        if accum > 1:
            specs = map_with_names(lambda _n, sp: P(None, *sp), specs)
        super().__init__(specs, mesh)

    def place(self, tree: PyTree, *, pin: bool = False) -> PyTree:
        from .elastic import Placed

        mesh, accum = self.mesh, self.accum

        def one(_names, x, spec):
            if accum > 1:
                x = x.reshape((accum, x.shape[0] // accum) + x.shape[1:])
            dim = next((i for i, e in enumerate(spec) if e is not None),
                       None)
            made, blocks = {}, []
            for flat, slot in enumerate(mesh.slots):
                k, n = (mesh.block_index(flat, self.data_axes)
                        if dim is not None else (0, 1))
                key = (slot.device, k)
                if key not in made:
                    rows = x.shape[dim] // n if dim is not None else 0
                    blk = (x.narrow(dim, k * rows, rows) if dim is not None
                           else x)
                    if pin:
                        blk = blk.contiguous().pin_memory()
                    made[key] = blk.to(slot.device, non_blocking=pin)
                blocks.append(made[key])
            return Placed(blocks, spec, mesh, x.shape)

        return _map_pair(one, tree, self.spec_tree)


def _map_pair(fn: Callable, tree: PyTree, specs: PyTree,
              names: tuple = ()) -> PyTree:
    """``fn(names, leaf, spec)`` over a batch tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _map_pair(fn, v, specs[k], names + (str(k),))
                for k, v in tree.items()}
    return fn(names, tree, specs)


def with_batch_constraint(x, data_axes=("data",)):
    """Constrain an activation's leading dim onto the data axes (the
    bound executor's ``constrain``; the identity with no mesh)."""
    from repro_torch.models.shard_ctx import constrain

    del data_axes      # the bound mesh's data axes
    return constrain(x, ("data",) + (None,) * (x.ndim - 1))
