"""The sharded executor of the LM port: FSDP x TP on a mesh of slots.

The JAX package hands its LM step to GSPMD, which partitions it by the
specs of ``distributed/sharding.py``. The port has no partitioner: this
executor runs the same layout from one process and one thread, op by op
and deterministically, over a ``launch.mesh.Mesh`` of (data..., model)
slots (a device may repeat, so a mesh of 8 slots can live on one card or
on ``cpu``). The data axes are flattened in order (``D`` data indices),
the model axis is the last (``M`` model indices); slot ``(d, m)`` is flat
slot ``d·M + m``.

* **State.** Every parameter and optimizer leaf is an ``elastic.Placed``
  list of its blocks under ``param_specs`` / ``opt_state_specs``: one
  tensor per (device, block), as ``Mesh.shard`` places it.
* **FSDP.** The model sees each leaf as a :class:`ShardLeaf` (its blocks
  by (data index, model index)); ``shard_ctx.gather_fsdp`` turns a layer
  group's leaves into their model-axis blocks (:class:`TPLeaf`), each
  rebuilt from its data-axis blocks by a concatenation: an all-gather,
  differentiable, whose backward hands each data-axis block the sum over
  the data slots of its gradient (the reduce-scatter). Inside a group's
  ``remat`` the gathered leaves live only while the group runs.
* **Tensor parallel.** The batch and the activations between the
  tensor-parallel points are whole-batch tensors held once, on the first
  slot's device (the home device). At each
  point (``per_slot``, ``row_parallel``) slot ``(d, m)`` takes its data
  block's rows and its model block of the weights, on its own device, and
  runs the single-slot function at local sizes; row-parallel partial
  outputs are float32, summed over the model slots and cast once.
* **Counting.** ``counts`` holds the calls and bytes of each collective
  kind (``all_gather``, ``reduce_scatter``, ``all_reduce``) that a mesh of
  separate devices runs for the work done since ``reset``. Bytes are the
  collective's output summed over the slots taking part: an all-gather's
  gathered tensor, a reduce-scatter's block, an all-reduce's full tensor.

On a mesh of several cards every slot computes on its own card, but the
residual stream and the gathered weights pass through the first slot's
card: the executor is exact there, not fast (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .elastic import (Placed, logical_blocks, placed_leaves,
                      tree_map_with_path)

__all__ = ["COLLECTIVES", "Executor", "ShardLeaf", "TPLeaf"]

COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce")


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


class ShardLeaf:
    """One leaf as the model sees it on a mesh: ``grid[d][m]`` the block
    slot (d, m) holds, ``ddim`` / ``mdim`` the dims split over the data /
    model axes (None: replicated), ``shape`` the whole leaf's."""

    __slots__ = ("grid", "ddim", "mdim", "shape", "dtype")

    def __init__(self, grid, ddim, mdim, shape, dtype):
        self.grid, self.ddim, self.mdim = grid, ddim, mdim
        self.shape, self.dtype = tuple(shape), dtype

    def __getitem__(self, i: int) -> "ShardLeaf":
        """Row `i` of a stacked leaf (a layer group's): every block's row,
        blocks shared by slots staying shared. Where the rows themselves
        are split (the rules split a stacked MoE shared expert's group dim
        over the model axis when it divides), every slot reads row `i`
        from the block holding it."""
        grid = self.grid
        if self.mdim == 0:
            size = self.shape[0] // len(grid[0])
            k, i = divmod(i, size)
            grid = [[line[k]] * len(line) for line in grid]
        elif self.ddim == 0:
            size = self.shape[0] // len(grid)
            k, i = divmod(i, size)
            grid = [grid[k]] * len(grid)
        rows: dict = {}

        def row(t):
            if id(t) not in rows:
                rows[id(t)] = t[i]
            return rows[id(t)]

        def drop(dim):
            return None if dim is None or dim == 0 else dim - 1

        return ShardLeaf([[row(t) for t in line] for line in grid],
                         drop(self.ddim), drop(self.mdim), self.shape[1:],
                         self.dtype)


class TPLeaf:
    """A leaf gathered over the data axes: ``blocks[m]`` its model block m
    (on the executor's home device), split on dim ``mdim``."""

    __slots__ = ("blocks", "mdim", "shape", "dtype")

    def __init__(self, blocks, mdim, shape):
        self.blocks, self.mdim = list(blocks), mdim
        self.shape, self.dtype = tuple(shape), blocks[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def t(self) -> "TPLeaf":
        """The transpose of a 2-D leaf."""
        return TPLeaf([b.t() for b in self.blocks], 1 - self.mdim,
                      self.shape[::-1])


class _Mark(torch.autograd.Function):
    """The identity, counting a collective in the backward: the one a
    mesh runs on the gradient of a tensor where this marks it."""

    @staticmethod
    def forward(ctx, ex, kind, nbytes, calls, x):
        ctx.ex, ctx.kind, ctx.nbytes, ctx.calls = ex, kind, nbytes, calls
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.ex.count(ctx.kind, ctx.nbytes, ctx.calls)
        return None, None, None, None, g


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Executor:
    """The executor of one mesh (see the module docstring)."""

    def __init__(self, mesh, data_axes: Sequence[str] = ("data",),
                 model_axes: Sequence[str] = ("model",)):
        data_axes, model_axes = tuple(data_axes), tuple(model_axes)
        if mesh.axis_names != data_axes + model_axes or len(model_axes) != 1:
            raise ValueError(
                f"the executor runs (data..., model) meshes; mesh axes "
                f"{mesh.axis_names}, data {data_axes}, model {model_axes}")
        self.mesh, self.data_axes, self.model_axes = mesh, data_axes, \
            model_axes
        self.M = mesh.shape[model_axes[0]]
        self.D = mesh.size // self.M
        self.S = mesh.size
        devs = list(mesh.devices.flat)
        self.devs = [devs[d * self.M:(d + 1) * self.M] for d in range(self.D)]
        self.home = devs[0]
        self.counts: dict = {}
        self.reset()

    # -- counting -------------------------------------------------------------
    def reset(self) -> None:
        """Zero the collective counts."""
        self.counts = {k: {"calls": 0, "bytes": 0} for k in COLLECTIVES}

    def count(self, kind: str, nbytes: int, calls: int = 1,
              over: int = 2) -> None:
        """Count a collective over `over` slots (over one slot a mesh
        runs none)."""
        if over > 1:
            self.counts[kind]["calls"] += calls
            self.counts[kind]["bytes"] += int(nbytes)

    def _mark(self, kind, nbytes, x, calls=1, over=2):
        if over < 2 or not (torch.is_grad_enabled() and x.requires_grad):
            return x
        return _Mark.apply(self, kind, int(nbytes), calls, x)

    # -- state ----------------------------------------------------------------
    def _dims(self, placed: Placed) -> tuple:
        """(data dim, model dim) of a placed leaf's spec."""
        ddim = mdim = None
        for dim, entry in enumerate(placed.spec):
            if entry is None:
                continue
            if _axes(entry) == self.data_axes:
                ddim = dim
            elif _axes(entry) == self.model_axes:
                mdim = dim
            else:
                raise ValueError(f"spec {placed.spec}: axes {entry!r} are "
                                 "neither the data nor the model axes")
        return ddim, mdim

    def shard_leaf(self, placed: Placed, subst=None) -> ShardLeaf:
        """The model's view of a placed leaf; `subst` maps a block's id to
        the tensor to use in its place (the step's gradient leaves)."""
        ddim, mdim = self._dims(placed)
        pick = (lambda t: t) if subst is None else (lambda t: subst[id(t)])
        grid = [[pick(placed[d * self.M + m]) for m in range(self.M)]
                for d in range(self.D)]
        return ShardLeaf(grid, ddim, mdim, placed.shape, placed[0].dtype)

    # -- FSDP -----------------------------------------------------------------
    def gather(self, leaf: ShardLeaf):
        """A leaf's model blocks on the home device, gathered over the
        data axes: a TPLeaf, or a tensor where the model axis does not
        split it."""
        nm = self.M if leaf.mdim is not None else 1
        if leaf.ddim is None:
            blocks = [leaf.grid[0][m].to(self.home) for m in range(nm)]
        else:
            blocks = [torch.cat([leaf.grid[d][m].to(self.home)
                                 for d in range(self.D)], dim=leaf.ddim)
                      if self.D > 1 else leaf.grid[0][m].to(self.home)
                      for m in range(nm)]
            numel = sum(b.numel() for b in blocks)
            isz = blocks[0].element_size()
            per_slot = numel // nm * isz
            self.count("all_gather", self.S * per_slot, over=self.D)
            rs = self.S * per_slot // self.D
            blocks = [self._mark("reduce_scatter", rs if m == 0 else 0, b,
                                 calls=1 if m == 0 else 0, over=self.D)
                      for m, b in enumerate(blocks)]
        if leaf.mdim is None:
            return blocks[0]
        return TPLeaf(blocks, leaf.mdim, leaf.shape)

    def gather_tree(self, tree):
        """``gather`` over a tree's ShardLeaf leaves; other leaves pass."""
        if isinstance(tree, ShardLeaf):
            return self.gather(tree)
        if isinstance(tree, dict):
            return {k: self.gather_tree(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.gather_tree(v) for v in tree)
        return tree

    # -- the model axis -----------------------------------------------------------
    def full(self, x):
        """A TPLeaf's whole tensor (an all-gather over the model axis;
        its backward a reduce-scatter); a tensor as it is."""
        if not isinstance(x, TPLeaf):
            return x
        out = torch.cat(x.blocks, dim=x.mdim)
        per_slot = _nbytes(out)
        self.count("all_gather", self.S * per_slot, over=self.M)
        return self._mark("reduce_scatter", self.S * per_slot // self.M, out,
                          over=self.M)

    def replicate_tree(self, tree):
        """``full`` over a gathered tree's leaves."""
        if isinstance(tree, TPLeaf):
            return self.full(tree)
        if isinstance(tree, dict):
            return {k: self.replicate_tree(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.replicate_tree(v) for v in tree)
        return tree

    def narrow(self, x, dim: int, start: int, length: int, device):
        """``x.narrow(dim, start, length)`` on `device`: from the one model
        block holding the range where there is one, else from the whole
        (gathered) leaf."""
        if isinstance(x, TPLeaf):
            if x.mdim == dim:
                size = x.shape[dim] // self.M
                k = start // size
                if start + length <= (k + 1) * size:
                    return x.blocks[k].narrow(dim, start - k * size,
                                              length).to(device)
            x = self.full(x)
        return x.narrow(dim, start, length).to(device)

    def part(self, x, dim: int, m: int, device):
        """Part m of M equal parts of `x` along `dim` (model slot m's)."""
        size = x.shape[dim] // self.M
        return self.narrow(x, dim, m * size, size, device)

    # -- tensor-parallel points -------------------------------------------------
    def rows(self, n: int, d: int) -> slice:
        if n % self.D:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.D} data slots")
        return slice(d * n // self.D, (d + 1) * n // self.D)

    def per_slot(self, fn: Callable, xs: Sequence[torch.Tensor]) -> list:
        """``fn(m, device, *rows)`` for every slot (d, m): `rows` the
        slot's data block of each whole-batch tensor of `xs` on the
        slot's device. Returns ``[[result of (d, m) for m] for d]``,
        tensors (or tuples of them) on the home device. A float input's
        gradient is the sum over the model slots (an all-reduce)."""
        xs = [self._mark("all_reduce", self.M * _nbytes(x), x, over=self.M)
              if x.is_floating_point() else x for x in xs]
        out = []
        for d in range(self.D):
            line = []
            for m in range(self.M):
                dev = self.devs[d][m]
                r = fn(m, dev, *(x[self.rows(x.shape[0], d)].to(dev)
                                 for x in xs))
                line.append(tuple(t.to(self.home) for t in r)
                            if isinstance(r, tuple) else r.to(self.home))
            out.append(line)
        return out

    def row_parallel(self, fn: Callable, xs: Sequence[torch.Tensor],
                     out_dtype) -> torch.Tensor:
        """Σ over the model slots of ``fn(m, device, *rows)`` (float32
        partials, summed in float32), per data block, joined over the
        batch and cast once to `out_dtype`."""
        sums = []
        for line in self.per_slot(fn, xs):
            acc = line[0]
            for p in line[1:]:
                acc = acc + p
            sums.append(acc)
        out = self.join(sums)
        self.count("all_reduce", self.M * _nbytes(out), over=self.M)
        return out.to(out_dtype)

    def join(self, parts: list) -> torch.Tensor:
        """Per-data-block results joined over the batch."""
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    # -- the step ---------------------------------------------------------------
    def grads(self, loss_fn: Callable, params, batch: dict,
              accum: int = 1) -> tuple:
        """``(loss, metrics, grads)`` of ``loss_fn(params, batch)`` on the
        mesh, `params` a tree of Placed leaves: the gradients a tree of
        Placed leaves laid out as the parameters' (each logical block's
        gradient the sum over the devices holding it). At ``accum`` > 1
        the batch is cut into ``accum`` microbatches of consecutive rows,
        each split over the data slots (the JAX package's ``micro_spec``),
        and the gradients are float32 sums divided by ``accum``."""
        from repro_torch.models import shard_ctx

        leaves = placed_leaves(params)
        subst: dict = {}
        for pl in leaves:
            for t in pl:
                if id(t) not in subst:
                    subst[id(t)] = t.detach().requires_grad_(True)
        inputs = list(subst.values())
        view = tree_map_with_path(
            lambda _path, pl: self.shard_leaf(pl, subst), params)
        batch = {k: v.to(self.home) for k, v in batch.items()}
        prev = shard_ctx.executor()
        shard_ctx.bind(self)
        try:
            if accum == 1:
                loss, metrics = loss_fn(view, batch)
                gs = torch.autograd.grad(loss, inputs, allow_unused=True,
                                         materialize_grads=True)
                loss = loss.detach()
                metrics = {k: v.detach() for k, v in metrics.items()}
            else:
                gs = [torch.zeros_like(t, dtype=torch.float32)
                      for t in inputs]
                loss = torch.zeros((), dtype=torch.float32, device=self.home)
                n = next(iter(batch.values())).shape[0] // accum
                for i in range(accum):
                    li, _ = loss_fn(view, {k: v[i * n:(i + 1) * n]
                                           for k, v in batch.items()})
                    gi = torch.autograd.grad(li, inputs, allow_unused=True,
                                             materialize_grads=True)
                    for a, b in zip(gs, gi):
                        a.add_(b.float())
                    loss = loss + li.detach()
                    del gi
                for g in gs:
                    g.div_(accum)
                loss = loss / accum
                metrics = {"nll": loss, "aux": torch.zeros_like(loss)}
        finally:
            shard_ctx.bind(prev)
        grad_of = {i: g for i, g in zip(subst, gs)}
        for pl in leaves:
            self._sum_copies(pl, grad_of)
            if self._dims(pl)[0] is None:
                # a leaf replicated over the data axes: its gradient is
                # all-reduced over them
                self.count("all_reduce", self.S * _nbytes(pl[0]) * accum,
                           calls=accum, over=self.D)
        grads = tree_map_with_path(
            lambda _path, pl: pl.like([grad_of[id(t)] for t in pl]), params)
        return loss, metrics, grads

    @staticmethod
    def _sum_copies(pl: Placed, grad_of: dict) -> None:
        """Each logical block's gradient summed over the devices holding a
        copy of it, and handed to every copy."""
        for _sl, copies in logical_blocks(pl):
            if len(copies) < 2:
                continue
            dev = copies[0].device
            total = sum(grad_of[id(c)].to(dev) for c in copies)
            for c in copies:
                grad_of[id(c)] = total.to(c.device)
