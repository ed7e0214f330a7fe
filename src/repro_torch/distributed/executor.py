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

* **Forward and decode.** ``forward`` runs a function of placed trees
  without gradients: the parameters (the prefill), or the parameters and
  the cache placed by ``cache_specs`` (a decode step). In a decode step
  each slot decodes against its own cache block and writes the new
  position into the block holding it (``attention``'s decode branches);
  where the sequence is split, the
  slots' partial softmax statistics combine as an online softmax
  (``merge_partials``); a leaf of another layout, and the recurrent
  states of the replicated mixers, are gathered whole (``gather_leaf``)
  and written back into their blocks (``store_tree``). A batch that
  does not divide the data axes (B = 1) is replicated over them: every
  data index runs the whole batch, as a mesh with a replicated batch
  does.
* **Owners.** Every op is issued under an owner (``shard_ctx.owning``):
  the slot whose body runs it, or the home device; the dry run's op
  counter (``roofline/op_cost.py``) attributes time and memory by it.
* **The representative-row mode** (``repr_rows``, ``meta`` tensors
  only): every data index computes the same shapes, so only data index
  0's slots run, each of their ops counting ``D`` times, and the other
  data indices' results are data index 0's; likewise one microbatch of
  an accumulation stands for all (``shard_ctx.repeating``). The counts,
  the collective counts and each slot's memory equal those of the full
  run; the values are not the step's.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.models.shard_ctx import owning

from .elastic import (Placed, logical_blocks, placed_leaves,
                      tree_map_with_path)

__all__ = ["COLLECTIVES", "Executor", "ShardLeaf", "TPLeaf",
           "merge_partials"]

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
    def forward(ctx, ex, kind, nbytes, calls, over, x):
        ctx.ex, ctx.kind, ctx.nbytes, ctx.calls = ex, kind, nbytes, calls
        ctx.over = over
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.ex.count(ctx.kind, ctx.nbytes, ctx.calls, over=ctx.over)
        return None, None, None, None, None, g


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Split(torch.autograd.Function):
    """A whole-batch tensor cut into `n` row blocks (the data slots');
    the backward is one concatenation of the blocks' gradients (a block
    without one, in the representative-row mode, stands in by another's
    shape: the values are not read there)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.set_materialize_grads(False)
        return x.chunk(n)

    @staticmethod
    def backward(ctx, *gs):
        like = next(g for g in gs if g is not None)
        with owning(("home", 1)):
            return torch.cat([like if g is None else g for g in gs]), None


class _Fan(torch.autograd.Function):
    """One tensor handed to the `n` data indices (aliases); the backward
    sums their gradients, one add each, on the home device (a data index
    without one, in the representative-row mode, stands in by another's:
    the values are not read there)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        like = next(g for g in gs if g is not None)
        with owning(("home", 1)):
            total = like if gs[0] is None else gs[0]
            for g in gs[1:]:
                total = total + (like if g is None else g)
        return total, None


def _fan(x, n: int):
    """``_Fan`` where autograd records through `x`, else `n` references."""
    if n > 1 and torch.is_grad_enabled() and x.requires_grad:
        return _Fan.apply(x, n)
    return [x] * n


class _Join(torch.autograd.Function):
    """Per-data-block results joined over the batch; in the
    representative-row mode the one block computed stands for all
    ``reps``. The backward hands each block its rows (views), issued at
    weight `w`."""

    @staticmethod
    def forward(ctx, reps, w, *parts):
        ctx.sizes, ctx.w = [p.shape[0] for p in parts], w
        return torch.cat(list(parts) * reps)

    @staticmethod
    def backward(ctx, g):
        with owning(("home", ctx.w)):
            out, start = [], 0
            for n in ctx.sizes:
                out.append(g.narrow(0, start, n))
                start += n
        return (None, None, *out)


def masked_write(t: torch.Tensor, vals: torch.Tensor,
                 local: torch.Tensor) -> None:
    """``t[b, local[b]] = vals[b]`` in place for the rows whose position
    lies in ``[0, t.shape[1])``; the others keep what they hold. Nothing
    is read on the host."""
    rows = torch.arange(t.shape[0], device=t.device)
    inside = (local >= 0) & (local < t.shape[1])
    at = local.long().clamp(0, t.shape[1] - 1)
    keep = inside.reshape((-1,) + (1,) * (vals.ndim - 1))
    t[rows, at] = torch.where(keep, vals.to(t.dtype), t[rows, at])


def merge_partials(parts: list, heads_dim: int | None = None) -> tuple:
    """Partial softmax statistics ``(mx, l, acc)`` (float32; ``mx``, ``l``
    ``(..., 1)``) combined: over blocks of the keys (an online softmax:
    ``heads_dim`` None) or concatenated along ``heads_dim`` (blocks of the
    heads)."""
    if len(parts) == 1:
        return parts[0]
    if heads_dim is not None:
        return tuple(torch.cat(z, dim=heads_dim) for z in zip(*parts))
    top = torch.stack([mx for mx, _, _ in parts]).amax(0)
    den, num = 0.0, 0.0
    for mx, l, acc in parts:
        w = torch.exp(mx - top)
        den = den + w * l
        num = num + w * acc
    return top, den, num


class Executor:
    """The executor of one mesh (see the module docstring)."""

    def __init__(self, mesh, data_axes: Sequence[str] = ("data",),
                 model_axes: Sequence[str] = ("model",), *,
                 repr_rows: bool = False):
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
        if repr_rows and any(d.type != "meta" for d in devs):
            raise ValueError("the representative-row mode runs on meta "
                             "tensors only: its values are not the step's")
        self.repr_rows = repr_rows
        self.at = (0, 0)       # the slot whose body runs (``per_slot``)
        self._fans = None      # per_slot's weights taken, per data index
        self.counts: dict = {}
        self.reset()

    # -- counting -------------------------------------------------------------
    def reset(self) -> None:
        """Zero the collective counts."""
        self.counts = {k: {"calls": 0, "bytes": 0, "device_bytes": 0.0}
                       for k in COLLECTIVES}

    def count(self, kind: str, nbytes: int, calls: int = 1,
              over: int = 2) -> None:
        """Count a collective over groups of `over` slots (over one slot a
        mesh runs none). ``device_bytes`` is its traffic per device in
        the JAX package's terms (``roofline.analysis.collective_bytes``):
        an all-gather's output, a reduce-scatter's output times the group,
        twice an all-reduce's output."""
        if over > 1:
            from repro_torch.models.shard_ctx import times

            n = times()
            c = self.counts[kind]
            c["calls"] += calls * n
            c["bytes"] += int(nbytes) * n
            per = nbytes * n / self.S
            c["device_bytes"] += per * {"all_gather": 1, "all_reduce": 2,
                                        "reduce_scatter": over}[kind]

    def _mark(self, kind, nbytes, x, calls=1, over=2):
        if over < 2 or not (torch.is_grad_enabled() and x.requires_grad):
            return x
        return _Mark.apply(self, kind, int(nbytes), calls, over, x)

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
        (gathered) leaf. Inside ``per_slot`` the data indices of one
        device share one such tensor (``_Fan``: their gradients summed
        once on the home device)."""
        if self._fans is None:
            return self._narrow(x, dim, start, length, device)
        key = (id(x), dim, start, length, torch.device(device))
        if key not in self._fans:
            with owning(("home", 1)):
                self._fans[key] = _fan(
                    self._narrow(x, dim, start, length, device), self.D)
        return self._fans[key][self.at[0]]

    def _narrow(self, x, dim: int, start: int, length: int, device):
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
    def lines(self) -> list:
        """The data indices that run: all, or 0 in the representative-row
        mode."""
        return [0] if self.repr_rows else list(range(self.D))

    def per_slot(self, fn: Callable, xs: Sequence[torch.Tensor],
                 combine: Callable, across: Callable | None = None):
        """``fn(m, device, *rows)`` for every slot (d, m) (``self.at`` is
        (d, m) while it runs): `rows` the slot's data block of each
        whole-batch tensor of `xs` on the slot's device, or the whole
        batch where it does not divide the data axes (replicated over
        them). ``combine`` (on the home device) takes each data index's
        M results, in model order, to one result (a tensor or a tuple);
        the data indices' results are joined over the batch, or, where
        the batch is replicated, data index 0's is taken (``across``, if
        given, combines them instead). A float input's gradient is the
        sum over the model slots (an all-reduce)."""
        xs = [self._mark("all_reduce", self.M * _nbytes(x), x, over=self.M)
              if x.is_floating_point() else x for x in xs]
        split = xs[0].shape[0] % self.D == 0
        if split and self.D > 1:
            parts = [_Split.apply(x, self.D) for x in xs]
        else:
            parts = [_fan(x, self.D) for x in xs]
        w = self.D if self.repr_rows else 1
        out = []
        fans, self._fans = self._fans, {}
        for d in self.lines():
            res = []
            for m in range(self.M):
                dev = self.devs[d][m]
                self.at = (d, m)
                with owning(((d, m), w)):
                    r = fn(m, dev, *(p[d].to(dev) for p in parts))
                    res.append(tuple(t.to(self.home) for t in r)
                               if isinstance(r, tuple) else r.to(self.home))
            with owning(("home", w)):
                out.append(combine(res))
        self.at, self._fans = (0, 0), fans
        if self.repr_rows:
            out = out * self.D
        with owning(("home", 1)):
            if across is not None:
                return across(out)
            if not split:
                return out[0]
            if isinstance(out[0], tuple):
                return tuple(self.join([o[i] for o in out])
                             for i in range(len(out[0])))
            return self.join(out)

    def row_parallel(self, fn: Callable, xs: Sequence[torch.Tensor],
                     out_dtype) -> torch.Tensor:
        """Σ over the model slots of ``fn(m, device, *rows)`` (float32
        partials, summed in float32), per data block, joined over the
        batch and cast once to `out_dtype`."""
        def total(line):
            acc = line[0]
            for p in line[1:]:
                acc = acc + p
            return acc

        out = self.per_slot(fn, xs, total)
        self.count("all_reduce", self.M * _nbytes(out), over=self.M)
        return out.to(out_dtype)

    def join(self, parts: list) -> torch.Tensor:
        """Per-data-block results joined over the batch (in the
        representative-row mode, data index 0's standing for all)."""
        if len(parts) == 1:
            return parts[0]
        if self.repr_rows:
            return _Join.apply(len(parts), len(parts), parts[0])
        return _Join.apply(1, 1, *parts)

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
        view = self.view(params, subst)
        batch = {k: v.to(self.home) for k, v in batch.items()}
        prev = shard_ctx.executor()
        shard_ctx.bind(self)
        try:
            if accum == 1:
                with owning(("home", 1)):
                    loss, metrics = loss_fn(view, batch)
                with owning(None):
                    gs = torch.autograd.grad(loss, inputs, allow_unused=True,
                                             materialize_grads=True)
                loss = loss.detach()
                metrics = {k: v.detach() for k, v in metrics.items()}
            else:
                gs = [torch.zeros_like(t, dtype=torch.float32)
                      for t in inputs]
                loss = torch.zeros((), dtype=torch.float32, device=self.home)
                n = next(iter(batch.values())).shape[0] // accum
                # the representative-row mode runs one microbatch for all:
                # every microbatch issues the same ops
                reps = [0] if self.repr_rows else range(accum)
                for i in reps:
                    with shard_ctx.repeating(accum // len(reps)):
                        with owning(("home", 1)):
                            li = loss_fn(view, {k: v[i * n:(i + 1) * n]
                                                for k, v in batch.items()})[0]
                        with owning(None):
                            gi = torch.autograd.grad(li, inputs,
                                                     allow_unused=True,
                                                     materialize_grads=True)
                        for a, b in zip(gs, gi):
                            a.add_(b.float())
                        loss = loss + li.detach()
                        del gi, li
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

    def view(self, placed_tree, subst=None):
        """The model's view of a placed tree (ShardLeaf leaves; `subst`
        as ``shard_leaf`` takes it)."""
        return tree_map_with_path(lambda _path, pl: self.shard_leaf(pl, subst),
                                  placed_tree)

    def forward(self, fn: Callable, trees: Sequence, *args):
        """``fn(*views of trees, *args)`` on the mesh without gradients:
        `trees` trees of Placed leaves (the parameters for the prefill;
        the parameters and the cache laid out by ``cache_specs`` for a
        decode step, written in place block by block), tensor `args` on
        the home device."""
        from repro_torch.models import shard_ctx

        args = [a.to(self.home) if isinstance(a, torch.Tensor) else a
                for a in args]
        prev = shard_ctx.executor()
        shard_ctx.bind(self)
        try:
            with torch.no_grad(), owning(("home", 1)):
                return fn(*(self.view(t) for t in trees), *args)
        finally:
            shard_ctx.bind(prev)

    # -- cache blocks -------------------------------------------------------------
    def block_region(self, leaf: ShardLeaf, d: int, m: int) -> list:
        """The slices of the whole leaf that slot (d, m)'s block holds."""
        region = [slice(None)] * len(leaf.shape)
        for dim, k, n in ((leaf.ddim, d, self.D), (leaf.mdim, m, self.M)):
            if dim is not None:
                size = leaf.shape[dim] // n
                region[dim] = slice(k * size, (k + 1) * size)
        return region

    def distinct_blocks(self, leaf: ShardLeaf) -> list:
        """``[(region, tensor)]``: every distinct block tensor of a leaf."""
        seen: dict = {}
        for d in range(self.D):
            for m in range(self.M):
                t = leaf.grid[d][m]
                if id(t) not in seen:
                    seen[id(t)] = (self.block_region(leaf, d, m), t)
        return list(seen.values())

    def gather_leaf(self, leaf):
        """A cache leaf's whole tensor on the home device (an all-gather
        where it is split); a tensor as it is."""
        if not isinstance(leaf, ShardLeaf):
            return leaf
        whole = torch.empty(leaf.shape, dtype=leaf.dtype, device=self.home)
        for region, t in self.distinct_blocks(leaf):
            whole[tuple(region)] = t.to(self.home)
        if leaf.ddim is not None or leaf.mdim is not None:
            self.count("all_gather", self.S * _nbytes(whole))
        return whole

    def store_tree(self, dst, src) -> None:
        """`src` (whole tensors) written into the blocks of `dst`'s
        ShardLeaf leaves; a leaf that is the same object is left alone."""
        if dst is src:
            return
        if isinstance(dst, ShardLeaf):
            for region, t in self.distinct_blocks(dst):
                t.copy_(src[tuple(region)].to(t.device))
        elif isinstance(dst, torch.Tensor):
            dst.copy_(src)
        elif isinstance(dst, dict):
            for k in dst:
                self.store_tree(dst[k], src[k])
        else:
            for a, b in zip(dst, src):
                self.store_tree(a, b)

    def write_rows(self, leaf: ShardLeaf, vals: torch.Tensor,
                   idx: torch.Tensor) -> None:
        """``leaf[b, idx[b]] = vals[b]`` for every batch row, into every
        block holding the position (dims 0 and 1: batch and sequence)."""
        for region, t in self.distinct_blocks(leaf):
            v = vals[region[0]]
            for dim in range(2, len(region)):
                sl = region[dim]
                if sl != slice(None):
                    v = v.narrow(dim - 1, sl.start, sl.stop - sl.start)
            start = region[1].start or 0
            masked_write(t, v.to(t.device), idx[region[0]].to(t.device)
                         - start)

    def cache_partials(self, leaves: Sequence[ShardLeaf],
                       xs: Sequence[torch.Tensor], fn: Callable,
                       heads_dim: int | None) -> tuple:
        """Per-slot partial softmax statistics over the cache blocks,
        combined: ``fn(m, device, blocks, start, *rows)`` runs on every
        slot with its blocks of `leaves` (all laid out alike: batch dim 0,
        sequence dim 1) narrowed to its rows of the batch, ``start`` the
        first sequence position its blocks hold, and its rows of `xs`;
        it returns ``(mx, l, acc)``. The model slots' partials combine
        along ``heads_dim`` where the model axis splits the heads, as an
        online softmax where it splits the sequence, and are taken once
        where it splits neither; the data indices' are joined over the
        batch, or combined as an online softmax where the data axes split
        the sequence."""
        first = leaves[0]
        ddim, mdim = first.ddim, first.mdim
        B = xs[0].shape[0]
        split = B % self.D == 0

        def slot(m, dev, *rows):
            d = self.at[0]
            blocks = []
            for leaf in leaves:
                t = leaf.grid[d][m]
                if ddim != 0 and split and t.shape[0] == B and self.D > 1:
                    t = t.narrow(0, d * (B // self.D), B // self.D)
                blocks.append(t)
            start = self.block_region(first, d, m)[1].start or 0
            return fn(m, dev, blocks, start, *rows)

        def combine(line):
            if mdim == 1:
                return merge_partials(line)
            if mdim is not None:
                return merge_partials(line, heads_dim)
            return line[0]

        across = merge_partials if ddim == 1 else None
        out = self.per_slot(slot, xs, combine, across)
        if mdim == 1 or ddim == 1:
            # the max, the sum-exp and the partials, float32, over the
            # slots splitting the keys
            over = self.M if mdim == 1 else self.D
            self.count("all_reduce", (self.M if split else self.S)
                       * sum(_nbytes(t) for t in out), over=over)
        return out

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
