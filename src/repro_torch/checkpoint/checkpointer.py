"""Crash-safe checkpoints of nested tensors, for one process.

The counterpart of the JAX package's ``checkpoint/checkpointer.py``:

  * **atomic publish**: a save writes ``step_N.tmp/`` and renames it to
    ``step_N/`` only after every leaf and the manifest are fsync'd, so a
    crash mid-save never corrupts the latest checkpoint;
  * **async**: ``save`` snapshots the tensors to the host (waiting only on
    that copy) and writes them in a background thread; ``wait`` joins it
    and re-raises what it raised;
  * **retention**: the newest ``keep`` checkpoints are kept;
  * ``latest_step`` and ``restore`` find and load the newest one.

Format: one ``.npy`` per leaf (named by its path in the tree) and a JSON
manifest with each leaf's kind, dtype and shape. A tree is a tensor, a
numpy array or a Python number, or a dict, list, tuple or NamedTuple of
trees; None is an empty subtree.
bfloat16 tensors are stored as float32 (numpy has no bfloat16) and cast
back on restore.

Sharded trees: a leaf placed on a mesh (``elastic.Placed``) is gathered
whole on save, and each leaf's PartitionSpec is recorded in the manifest
in the JAX package's JSON form (from ``spec_tree``, or the placed leaf's
own). ``load_pytree(..., mesh=)`` places the leaves back by their
recorded specs on the current mesh, which may have another shape; a spec
it cannot honour degrades to replication on that dim
(``elastic.remesh_report``, logged).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.elastic import Placed, gather, remesh
from repro_torch.launch.mesh import P

Tree = Any
_STEP_RE = re.compile(r"^step_(\d+)$")



def _leaves(tree, path=()):
    """(path, leaf) pairs in a fixed order (dicts by sorted key); None is
    an empty subtree, as in a JAX pytree; a placed leaf and a
    PartitionSpec are leaves."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, (Placed,
                                                                  P)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _name(path) -> str:
    return "__".join(path) or "leaf"


def _rebuild(like, values, path=()):
    """`like`'s structure with each leaf replaced by ``values[name]``."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], values, path + (str(k),))
                for k in like}
    if isinstance(like, (list, tuple)) and not isinstance(like, Placed):
        items = [_rebuild(v, values, path + (str(i),))
                 for i, v in enumerate(like)]
        # a NamedTuple (an optimizer's OptState) takes its fields apart
        return type(like)(*items) if hasattr(like, "_fields") \
            else type(like)(items)
    if like is None:
        return None
    return values[_name(path)]


def _spec_to_json(spec) -> list:
    if spec is None:
        return []
    out = []
    for axes in spec:
        if axes is None:
            out.append(None)
        elif isinstance(axes, str):
            out.append(axes)
        else:
            out.append(list(axes))
    return out


def _spec_from_json(lst) -> P:
    dims = []
    for axes in lst:
        if axes is None:
            dims.append(None)
        elif isinstance(axes, str):
            dims.append(axes)
        else:
            dims.append(tuple(axes))
    return P(*dims)


def _host(leaf) -> tuple:
    """(numpy array, manifest entry) of one leaf, copied to the host (a
    placed leaf gathered whole)."""
    if isinstance(leaf, Placed):
        leaf = gather(leaf, "cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.float()
        # a copy: the caller may update the tensor in place (an optimizer
        # step) while the snapshot is being written
        return t.to("cpu", copy=True).numpy(), {"kind": "tensor",
                                                 "dtype": dtype}
    if isinstance(leaf, np.ndarray):
        return leaf.copy(), {"kind": "ndarray", "dtype": str(leaf.dtype)}
    if isinstance(leaf, (bool, int, float)):
        return np.asarray(leaf), {"kind": type(leaf).__name__,
                                  "dtype": str(np.asarray(leaf).dtype)}
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf)}")


def _write(path: str, write):
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _snapshot(tree, spec_tree=None) -> list:
    """``[(name, array, manifest entry), ...]``: the tree on the host,
    each entry with its leaf's spec (from `spec_tree`, else a placed
    leaf's own, else none)."""
    specs = ({_name(p): s for p, s in _leaves(spec_tree)}
             if spec_tree is not None else {})
    out = []
    for p, leaf in _leaves(tree):
        arr, entry = _host(leaf)
        spec = specs.get(_name(p), getattr(leaf, "spec", None))
        out.append((_name(p), arr, {**entry,
                                    "spec": _spec_to_json(spec)}))
    return out


def save_pytree(tree: Tree, directory: str, spec_tree: Tree = None):
    """Blocking single-shot save (the manager's thread runs the same
    write on a snapshot)."""
    _save_host(_snapshot(tree, spec_tree), directory)


def _save_host(host: list, directory: str):
    """Write a snapshot to `directory`, published atomically."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"leaves": []}
    for name, arr, entry in host:
        _write(os.path.join(tmp, name + ".npy"),
               lambda f, arr=arr: np.save(f, arr))
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), **entry})
    _write(os.path.join(tmp, "manifest.json"),
           lambda f: f.write(json.dumps(manifest).encode()))
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)  # atomic publish


def load_pytree(directory: str, like: Tree, device=None,
                mesh=None) -> Tree:
    """Restore into the structure of `like` (its values are ignored).
    Tensors land on `device`, or on the device of `like`'s leaf; with
    `mesh`, a leaf with a recorded spec is placed on it by that spec."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    values = {}
    like_leaves = dict((_name(p), v) for p, v in _leaves(like))
    for meta in manifest["leaves"]:
        arr = np.load(os.path.join(directory, meta["name"] + ".npy"))
        kind = meta["kind"]
        if kind == "tensor":
            ref = like_leaves.get(meta["name"])
            # with a mesh: a leaf with a spec, or placed in `like` (a
            # replicated one records P() as []), is placed on it
            place = mesh is not None and (bool(meta.get("spec"))
                                          or isinstance(ref, Placed))
            if isinstance(ref, Placed):
                ref = ref[0]
            dev = "cpu" if place else device if device is not None else (
                ref.device if isinstance(ref, torch.Tensor) else "cpu")
            t = torch.from_numpy(arr).to(device=dev,
                                         dtype=getattr(torch, meta["dtype"]))
            if place:
                t = remesh(t, mesh, _spec_from_json(meta.get("spec", [])))
            values[meta["name"]] = t
        elif kind == "ndarray":
            values[meta["name"]] = arr.astype(meta["dtype"])
        else:
            values[meta["name"]] = {"bool": bool, "int": int,
                                    "float": float}[kind](arr)
    return _rebuild(like, values)


class CheckpointManager:
    """Async checkpoints under `root` with retention and latest-step
    discovery."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- write ----------------------------------------------------------------
    def save(self, step: int, tree: Tree, blocking: bool = False,
             spec_tree: Tree = None):
        self.wait()  # one save in flight at a time
        host = _snapshot(tree, spec_tree)
        target = os.path.join(self.root, f"step_{step}")

        def work():
            try:
                _save_host(host, target)
                self._gc()
            except BaseException as exc:  # noqa: BLE001 — re-raised by wait
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- read -----------------------------------------------------------------
    def steps(self) -> list:
        out = []
        for d in os.listdir(self.root):
            m = _STEP_RE.match(d)
            if m and os.path.exists(
                    os.path.join(self.root, d, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Tree, step: Optional[int] = None,
                device=None, mesh=None) -> tuple:
        """``(step, tree)`` of checkpoint `step` (default: the latest);
        with `mesh`, the leaves placed on it by their recorded specs."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return step, load_pytree(os.path.join(self.root, f"step_{step}"),
                                 like, device, mesh)

    # -- retention --------------------------------------------------------------
    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)
