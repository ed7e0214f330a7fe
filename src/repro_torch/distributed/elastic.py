"""Elastic re-meshing: place a tree of tensors on a (new) mesh.

The counterpart of the JAX package's ``distributed/elastic.py``, on the
port's ``launch.mesh.Mesh`` and ``PartitionSpec``. When slots are lost
the server builds the surviving mesh with :func:`shrink_mesh` and
re-places its cached matrices through :func:`remesh_report`. A spec the
new mesh cannot honour (an axis it does not have, or a dim the axes'
product does not divide) is applied as replication on that dim **and**
reported as a :class:`Degradation` (leaf path, requested spec, what was
applied, why); it is never dropped silently.

A placed leaf is a :class:`Placed` list of its per-slot blocks, in the
mesh's flat slot order (``Mesh.shard``), which also knows its spec, its
mesh and its whole shape: :func:`logical_blocks` lists its distinct
blocks (each with the copies that hold it, one per device) and
:func:`gather` rebuilds the whole tensor; :func:`slot_view` takes one
slot's tree out of a placed tree.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from repro_torch.launch.mesh import Mesh, P, Slot

Tree = Any

logger = logging.getLogger(__name__)

__all__ = ["Degradation", "Placed", "gather", "logical_blocks",
           "placed_leaves", "remesh", "remesh_report", "replicated",
           "shrink_mesh", "slot_view", "surviving_devices",
           "tree_map_with_path"]


class Placed(list):
    """One leaf placed on a mesh: its blocks, one per slot (slots that
    share a device and a block share one tensor). ``spec``, ``mesh`` and
    ``shape`` (the whole leaf's) say how the blocks tile the leaf."""

    def __init__(self, blocks=(), spec=None, mesh=None, shape=None):
        super().__init__(blocks)
        self.spec, self.mesh = spec, mesh
        self.shape = None if shape is None else tuple(shape)

    def like(self, blocks) -> "Placed":
        """Other blocks laid out as these."""
        return Placed(blocks, self.spec, self.mesh, self.shape)


def logical_blocks(placed: Placed) -> list:
    """``[(slices, copies), ...]``: each distinct block of the leaf, its
    index into the whole leaf and the distinct tensors that hold it (one
    per device holding it), in the order of the first slot holding
    it."""
    dims = tuple(placed.spec) + (None,) * (len(placed.shape)
                                           - len(placed.spec))
    found: dict = {}
    for flat, t in enumerate(placed):
        key, sl = [], []
        for dim, axes in enumerate(dims):
            if axes is None:
                sl.append(slice(None))
                continue
            k, n = placed.mesh.block_index(
                flat, (axes,) if isinstance(axes, str) else tuple(axes))
            m = placed.shape[dim] // n
            sl.append(slice(k * m, (k + 1) * m))
            key.append((dim, k))
        entry = found.setdefault(tuple(key), (tuple(sl), {}))
        entry[1].setdefault(id(t), t)
    return [(sl, list(ts.values())) for sl, ts in found.values()]


def placed_leaves(tree) -> list:
    """The Placed leaves of a tree, dicts in sorted key order."""
    if isinstance(tree, Placed):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in placed_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in placed_leaves(v)]
    return []


def gather(placed: Placed, device=None):
    """The whole tensor of a placed leaf, on `device` (default: its
    first block's)."""
    import torch

    device = placed[0].device if device is None else device
    out = torch.empty(placed.shape, dtype=placed[0].dtype, device=device)
    for sl, copies in logical_blocks(placed):
        out[sl] = copies[0].to(device)
    return out


def slot_view(tree: Tree, i: int) -> Tree:
    """Slot `i`'s tree of a placed tree: each ``Placed`` leaf's i-th
    block."""
    if isinstance(tree, Placed):
        return tree[i]
    if isinstance(tree, dict):
        return {k: slot_view(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(slot_view(v, i) for v in tree)
    return tree


def replicated(tree: Tree) -> Tree:
    """The spec tree that replicates every leaf of `tree`."""
    return tree_map_with_path(lambda _path, _leaf: P(), tree)


@dataclasses.dataclass(frozen=True)
class Degradation:
    """One leaf whose requested spec could not be honoured.

    ``path`` is the leaf's path in the tree (``"w"``, ``"R/1"``, ...),
    ``requested`` / ``applied`` the printable specs, ``reason`` which dim
    degraded and why.
    """

    path: str
    requested: str
    applied: str
    reason: str

    def __str__(self) -> str:
        return (f"{self.path}: {self.requested} -> {self.applied} "
                f"({self.reason})")


def tree_map_with_path(fn: Callable, tree: Tree, *rest: Tree,
                       path: tuple = ()) -> Tree:
    """``fn(path, leaf, *rest_leaves)`` over the leaves of nested dicts,
    lists, tuples and NamedTuples (`rest` mirror `tree`); a
    PartitionSpec and a ``Placed`` are leaves, None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, (P, Placed)):
        items = [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                    path=path + (i,))
                 for i, v in enumerate(tree)]
        # a NamedTuple (an optimizer's OptState) takes its fields apart
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    if tree is None:
        return None
    return fn(path, tree, *rest)


def _path_str(path) -> str:
    return "/".join(str(e) for e in path) or "<root>"


def _fit_spec(spec, leaf, new_mesh: Mesh) -> Tuple[P, List[str]]:
    """Per-dim fit of `spec` onto `new_mesh`: the applied spec and the
    degradation reasons (none when honoured exactly)."""
    dims, reasons = [], []
    for i, axes in enumerate(tuple(spec) + (None,) * (leaf.ndim - len(spec))):
        if axes is None:
            dims.append(None)
            continue
        ax = (axes,) if isinstance(axes, str) else tuple(axes)
        missing = [a for a in ax if a not in new_mesh.shape]
        if missing:
            dims.append(None)
            reasons.append(f"dim {i}: mesh axis {missing[0]!r} not on the "
                           f"new mesh (axes {tuple(new_mesh.shape)})")
            continue
        size = 1
        for a in ax:
            size *= new_mesh.shape[a]
        if leaf.shape[i] % size != 0:
            dims.append(None)
            reasons.append(f"dim {i}: size {leaf.shape[i]} not divisible "
                           f"by mesh axes {ax} (= {size})")
        else:
            dims.append(axes)
    return P(*dims), reasons


def remesh_report(tree: Tree, new_mesh: Mesh,
                  spec_tree: Tree) -> Tuple[Tree, List[Degradation]]:
    """Place `tree` on `new_mesh` by `spec_tree`; returns ``(placed,
    degradations)``, each placed leaf a ``Placed`` list of its per-slot
    blocks.
    A spec whose axes do not exist or do not divide degrades to
    replication on that dim, with a :class:`Degradation` record."""
    report: List[Degradation] = []

    def one(path, leaf, spec):
        applied, reasons = _fit_spec(spec, leaf, new_mesh)
        if reasons:
            report.append(Degradation(
                path=_path_str(path), requested=str(spec),
                applied=str(applied), reason="; ".join(reasons)))
        return Placed(new_mesh.shard(leaf, applied), applied, new_mesh,
                      leaf.shape)

    return tree_map_with_path(one, tree, spec_tree), report


def remesh(tree: Tree, new_mesh: Mesh, spec_tree: Tree, *,
           on_degrade: Optional[Callable[[Degradation], None]] = None
           ) -> Tree:
    """:func:`remesh_report` that logs every degradation (and hands it to
    ``on_degrade`` when given) and returns the placed tree."""
    out, report = remesh_report(tree, new_mesh, spec_tree)
    for d in report:
        logger.warning("remesh degradation: %s", d)
        if on_degrade is not None:
            on_degrade(d)
    return out


def surviving_devices(mesh: Mesh, dead_ids) -> list:
    """The slots of `mesh` whose id is not in `dead_ids`, in mesh order."""
    dead = set(int(i) for i in dead_ids)
    return [s for s in mesh.slots if s.id not in dead]


def shrink_mesh(mesh: Mesh, dead_ids, *,
                axis_name: str | None = None) -> Optional[Mesh]:
    """The surviving mesh after losing the slots `dead_ids`: a 1-axis
    mesh over the remaining slots, ids kept (the ring or data axis simply
    shrinks; per-slot work grows, the program re-plans and resumes).

    Returns None when one slot (or fewer) survives: the caller drops to
    the single-device path. Raises when no slot survives at all.
    """
    live: List[Slot] = surviving_devices(mesh, dead_ids)
    if not live:
        raise RuntimeError(
            f"no devices survive (mesh had {mesh.size}, all in dead set)")
    if len(live) < 2:
        return None
    devs = np.empty(len(live), dtype=object)
    devs[:] = [s.device for s in live]
    return Mesh(devs, (axis_name or mesh.axis_names[0],),
                ids=np.asarray([s.id for s in live]))
