"""The sharded executor of the LM port: FSDP x TP on a mesh of slots.

The JAX package hands its LM step to GSPMD, which partitions it by the
specs of ``distributed/sharding.py``. The port has no partitioner: this
executor runs the same layout from one process and one thread, op by op
and deterministically, over a ``launch.mesh.Mesh`` of (data..., model)
slots (a device may repeat, so a mesh of 8 slots can live on one card or
on ``cpu``). The data axes are flattened in order (``D`` data indices),
the model axis is the last (``M`` model indices); slot ``(d, m)`` is flat
slot ``d·M + m``. A *line* is data index ``d`` with its slots ``(d, 0) …
(d, M-1)``.

* **State.** Every parameter and optimizer leaf is an ``elastic.Placed``
  list of its blocks under ``param_specs`` / ``opt_state_specs``: one
  tensor per (device, block), as ``Mesh.shard`` places it.
* **The batch over the lines.** The batch comes placed by
  ``sharding.BatchShardings`` (or whole, and is placed so once): line d
  holds its rows, ``d·B/D … (d+1)·B/D``, on its own devices, and at
  ``accum`` > 1 its rows of every microbatch (the JAX package's
  ``micro_spec``). The model's function runs once per line on that
  line's rows (``shard_ctx.line_stats`` for the loss, ``forward`` for
  the prefill and the decode step); every activation of the line lives
  on the device of slot ``(d, 0)`` and is issued under that slot's
  owner, GSPMD's layout (the batch over the data axes, replicated over
  the model axis) with one model slot standing for the line's copies.
  The loss's statistics over the global batch (the masked mean's sums
  and counts, the MoE load balance's means) are all-reduced over the
  lines before they combine (``line_stats``); the home device (the first
  slot's) holds only those scalars.
* **FSDP.** The model sees each leaf as a :class:`ShardLeaf` (its blocks
  by (data index, model index)); ``shard_ctx.gather_fsdp`` turns a layer
  group's leaves into their model-axis blocks (:class:`TPLeaf`): each
  line builds slot ``(d, m)``'s block on that slot's own device from the
  data-axis blocks by a concatenation, as each data shard gathers for
  itself under GSPMD: an all-gather, differentiable, whose backward hands
  each data-axis block the sum over the lines of its gradient (the
  reduce-scatter). Inside a group's ``remat`` the gathered leaves live
  only while the group runs.
* **Tensor parallel.** At each point (``per_slot``, ``row_parallel``)
  model slot m of the running line takes the line's rows and its model
  block of the weights, on its own device, and runs the single-slot
  function at local sizes; row-parallel partial outputs are float32,
  summed over the line's model slots on the line's device and cast once.
* **Counting.** ``counts`` holds the calls and bytes of each collective
  kind (``all_gather``, ``reduce_scatter``, ``all_reduce``) that a mesh of
  separate devices runs for the work done since ``reset``. Bytes are the
  collective's output summed over the slots taking part: an all-gather's
  gathered tensor, a reduce-scatter's block, an all-reduce's full tensor.
  The lines issue the same collectives one after another; the first
  line's run counts each once, for the whole mesh.
* **Forward and decode.** ``forward`` runs a function of placed trees
  without gradients: the parameters (the prefill), or the parameters and
  the cache placed by ``cache_specs`` (a decode step), once per line on
  its rows, tokens, positions and cache blocks; the result comes back as
  a Placed leaf over the data axes. In a decode step each slot decodes
  against its own cache block and writes the new position into the block
  holding it (``attention``'s decode branches); where the sequence is
  split, the slots' partial softmax statistics combine as an online
  softmax (``merge_partials``); a leaf of another layout, and the
  recurrent states of the replicated mixers, are gathered whole over the
  line's rows (``gather_leaf``) and written back into their blocks
  (``store_tree``). A batch that does not divide the data axes (B = 1)
  is replicated over them: the function runs once on the home device,
  every data index computing the whole batch at each tensor-parallel
  point, as a mesh with a replicated batch does.
* **Owners.** Every op is issued under an owner (``shard_ctx.owning``):
  the slot whose body runs it (a line's activations: slot (d, 0)), or
  the home device; the dry run's op counter (``roofline/op_cost.py``)
  attributes time and memory by it.
* **The representative-row mode** (``repr_rows``, ``meta`` tensors
  only): every line computes the same shapes, so only line 0 runs, each
  of its ops counting ``D`` times, and the other lines' results are line
  0's; likewise one microbatch of an accumulation stands for all
  (``shard_ctx.repeating``). The counts, the collective counts and each
  slot's memory equal those of the full run; the values are not the
  step's.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.launch.mesh import P
from repro_torch.models.shard_ctx import owning
from repro_torch.models.tree import tree_map

from .elastic import (Placed, logical_blocks, placed_leaves,
                      tree_map_with_path)

__all__ = ["COLLECTIVES", "Executor", "Lines", "ShardLeaf", "TPLeaf",
           "merge_partials"]

COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce")


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Lines(list):
    """One value per line, in data order: a batch's rows as the model's
    function takes them line by line (``shard_ctx.line_stats``)."""


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
    (on slot (d, m)'s device for the line d that gathered it; on the home
    device in the replicated mode), split on dim ``mdim``."""

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
        ctx.ex._tally(ctx.kind, ctx.nbytes, ctx.calls, ctx.over)
        return None, None, None, None, None, g


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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


def _uncounted():
    """A block whose ops no dispatch mode sees: the op counter's
    (``roofline/op_cost.py``) included."""
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()


class _LineFan(torch.autograd.Function):
    """A parameter block handed to the `n` lines (aliases); the backward
    sums the lines' gradients: the reduction of the reduce-scatter or
    all-reduce over the data axes, a collective's work (counted as one),
    issued unseen by the op counter. In the representative-row mode the
    lines after the first give none (the values are not the step's)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        gs = [g for g in gs if g is not None]
        with _uncounted():
            total = gs[0]
            for g in gs[1:]:
                total = total + g
        return total, None


def _fan(x, n: int):
    """``_Fan`` where autograd records through `x`, else `n` references."""
    if n > 1 and torch.is_grad_enabled() and x.requires_grad:
        return _Fan.apply(x, n)
    return [x] * n


def _dict_map(fn: Callable, tree):
    """``fn`` over the leaves of nested dicts (a Placed is a leaf)."""
    if isinstance(tree, dict):
        return {k: _dict_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _dict_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _dict_leaves(v)]
    return [tree]


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
        self.w = self.D if repr_rows else 1   # the times a line's op counts
        self.line = None       # the line running, None in the replicated mode
        self.at = (0, 0)       # the slot whose body runs (``per_slot``)
        self._fans = None      # per_slot's weights taken (per data index)
        self.counts: dict = {}
        self.reset()

    # -- counting -------------------------------------------------------------
    def reset(self) -> None:
        """Zero the collective counts."""
        self.counts = {k: {"calls": 0, "bytes": 0, "device_bytes": 0.0}
                       for k in COLLECTIVES}

    def count(self, kind: str, nbytes: int, calls: int = 1,
              over: int = 2, per_line: bool = False) -> None:
        """Count a collective over groups of `over` slots (over one slot a
        mesh runs none). While the lines run one by one, each issues the
        same collectives and the first line's run counts the mesh's:
        ``per_line`` says `nbytes` are over the running line's rows (the
        mesh's are D times as many). ``device_bytes`` is its traffic per
        device in the JAX package's terms
        (``roofline.analysis.collective_bytes``): an all-gather's output,
        a reduce-scatter's output times the group, twice an all-reduce's
        output."""
        if self.line not in (None, 0):
            return
        if per_line and self.line is not None:
            nbytes *= self.D
        self._tally(kind, nbytes, calls, over)

    def _tally(self, kind, nbytes, calls, over) -> None:
        if over > 1:
            from repro_torch.models.shard_ctx import times

            n = times()
            c = self.counts[kind]
            c["calls"] += calls * n
            c["bytes"] += int(nbytes) * n
            per = nbytes * n / self.S
            c["device_bytes"] += per * {"all_gather": 1, "all_reduce": 2,
                                        "reduce_scatter": over}[kind]

    def _mark(self, kind, nbytes, x, calls=1, over=2, per_line=False):
        """`x` marked to count a collective on its gradient (``count``'s
        rules; a line after the first marks nothing)."""
        if over < 2 or self.line not in (None, 0) \
                or not (torch.is_grad_enabled() and x.requires_grad):
            return x
        if per_line and self.line is not None:
            nbytes *= self.D
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

    def line_device(self) -> torch.device:
        """Where the running line's activations live: slot (d, 0)'s device
        (the home device in the replicated mode)."""
        return self.home if self.line is None else self.devs[self.line][0]

    # -- the batch ------------------------------------------------------------
    def batch_rows(self, batch, accum: int = 1) -> list:
        """A batch (a dict, nested dicts allowed) as the model's function
        takes it, one entry per microbatch: a :class:`Lines` of each
        line's rows (on slot (d, 0)'s device), or, where the data axes do
        not divide a microbatch, the whole microbatch on the home device
        (the replicated mode). `batch` holds Placed leaves
        (``sharding.BatchShardings`` for this `accum`) or whole tensors,
        placed so here once."""
        from .sharding import BatchShardings

        if not any(isinstance(x, Placed) for x in _dict_leaves(batch)):
            batch = BatchShardings(batch, self.mesh, self.data_axes,
                                   accum).place(batch)
        split = {self._batch_dim(pl, accum) is not None
                 for pl in _dict_leaves(batch)}
        if len(split) != 1:
            raise ValueError("a batch whose leaves are split over the data "
                             "axes and replicated over them at once")
        micro = (lambda t, i: t[i]) if accum > 1 else (lambda t, i: t)
        if split.pop():
            return [Lines(_dict_map(lambda pl: micro(pl[d * self.M], i),
                                    batch) for d in range(self.D))
                    for i in range(accum)]
        return [_dict_map(lambda pl: micro(pl[0], i).to(self.home), batch)
                for i in range(accum)]

    def _batch_dim(self, pl, accum: int):
        """The dim of a placed batch leaf split over the data axes (0, or
        1 in the microbatch layout), or None."""
        dims = ([i for i, e in enumerate(pl.spec) if e is not None]
                if isinstance(pl, Placed) else None)
        want = 1 if accum > 1 else 0
        if (dims not in ([], [want]) or (accum > 1 and pl.shape[0] != accum)
                or any(_axes(pl.spec[i]) != self.data_axes for i in dims)):
            raise ValueError(
                f"a batch leaf placed as {getattr(pl, 'spec', None)} for "
                f"accum {accum}: place the batch with "
                f"BatchShardings(accum={accum})")
        return dims[0] if dims else None

    def _rows_placed(self, outs: list, split: bool):
        """A function's results, one per line (split) or one for the
        replicated batch, as Placed leaves: over the data axes (each
        line's rows shared by its slots) or replicated."""
        if not split:
            return tree_map(lambda t: Placed([t] * self.S, P(), self.mesh,
                                             t.shape), outs[0])
        if self.repr_rows:
            outs = outs * self.D

        def one(*ts):
            shape = (sum(t.shape[0] for t in ts),) + tuple(ts[0].shape[1:])
            return Placed([ts[d] for d in range(self.D)
                           for _ in range(self.M)],
                          P(self.data_axes), self.mesh, shape)

        return tree_map(one, *outs)

    def line_stats(self, fn: Callable, *args):
        """``shard_ctx.line_stats`` on the mesh: ``fn(*args)`` once per
        line, a :class:`Lines` argument replaced by the line's value, its
        ops under slot (d, 0)'s owner; fn returns ``(sums, means)`` of the
        line's rows (trees of tensors), and the lines' sums are summed and
        their means averaged (equal-size lines: the global mean), each
        leaf an all-reduce over the data axes, on the home device, with
        its gradient handed back to every line. With no Lines argument
        (the replicated mode) ``fn(*args)`` as it is."""
        if not any(isinstance(a, Lines) for a in args):
            return fn(*args)
        res = []
        for d in self.lines():
            self.line = d
            try:
                with owning(((d, 0), self.w)):
                    res.append(fn(*(a[d] if isinstance(a, Lines) else a
                                    for a in args)))
            finally:
                self.line = None
        if self.repr_rows:
            # line 0 stands for the others, which take no gradient
            res += [tree_map(torch.Tensor.detach, res[0])] * (self.D - 1)
        with owning(("home", 1)):
            return (self._all_reduce([r[0] for r in res], 1),
                    self._all_reduce([r[1] for r in res], self.D))

    def _all_reduce(self, trees: list, div: int):
        """The lines' trees summed leaf by leaf on the home device (over
        `div`)."""
        def one(*leaves):
            total = leaves[0].to(self.home)
            for t in leaves[1:]:
                total = total + t.to(self.home)
            self.count("all_reduce", self.S * _nbytes(total), over=self.D)
            return total / div if div > 1 else total

        return tree_map(one, *trees)

    # -- FSDP -----------------------------------------------------------------
    def gather(self, leaf: ShardLeaf):
        """A leaf's model blocks gathered over the data axes: a TPLeaf, or
        a tensor where the model axis does not split it. The running line
        d builds model block m on slot (d, m)'s device, under that slot's
        owner; the replicated mode on the home device."""
        d = self.line
        nm = self.M if leaf.mdim is not None else 1
        blocks = []
        for m in range(nm):
            dev = self.home if d is None else self.devs[d][m]
            with owning(("home", 1) if d is None else ((d, m), self.w)):
                if leaf.ddim is None or self.D == 1:
                    blocks.append(leaf.grid[d or 0][m].to(dev))
                else:
                    blocks.append(torch.cat(
                        [leaf.grid[k][m].to(dev) for k in range(self.D)],
                        dim=leaf.ddim))
        if leaf.ddim is not None:
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
        """A TPLeaf's whole tensor on the line's device (an all-gather
        over the model axis; its backward a reduce-scatter); a tensor as
        it is."""
        if not isinstance(x, TPLeaf):
            return x
        dev = self.line_device()
        out = torch.cat([b.to(dev) for b in x.blocks], dim=x.mdim)
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
        (gathered) leaf. Inside ``per_slot`` the slots of one device share
        one such tensor (one all-gather where the range spans blocks); in
        the replicated mode so do the data indices (``_Fan``: their
        gradients summed once on the home device)."""
        if self._fans is None:
            return self._narrow(x, dim, start, length, device)
        key = (id(x), dim, start, length, torch.device(device))
        if key not in self._fans:
            if self.line is not None:
                self._fans[key] = self._narrow(x, dim, start, length, device)
            else:
                with owning(("home", 1)):
                    self._fans[key] = _fan(
                        self._narrow(x, dim, start, length, device), self.D)
        got = self._fans[key]
        return got if self.line is not None else got[self.at[0]]

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
        """The lines that run: all, or 0 in the representative-row mode."""
        return [0] if self.repr_rows else list(range(self.D))

    def per_slot(self, fn: Callable, xs: Sequence[torch.Tensor],
                 combine: Callable, across: Callable | None = None):
        """``fn(m, device, *rows)`` for every model slot m of the running
        line d (``self.at`` is (d, m) while it runs): `rows` the line's
        tensors `xs` on the slot's device. ``combine`` takes the M
        results, in model order, to one result (a tensor or a tuple) on
        the line's device, under slot (d, 0)'s owner. In the replicated
        mode every slot (d, m) runs on the whole batch, each data index's
        results combine on the home device, and data index 0's is taken
        (``across``, if given, combines them instead). A float input's
        gradient is the sum over the model slots (an all-reduce)."""
        xs = [self._mark("all_reduce", self.M * _nbytes(x), x, over=self.M,
                         per_line=True)
              if x.is_floating_point() else x for x in xs]
        if self.line is None:
            return self._per_slot_replicated(fn, xs, combine, across)
        d, at = self.line, self.at
        home = self.devs[d][0]
        res = []
        fans, self._fans = self._fans, {}
        for m in range(self.M):
            dev = self.devs[d][m]
            self.at = (d, m)
            with owning(((d, m), self.w)):
                r = fn(m, dev, *(x.to(dev) for x in xs))
                res.append(tuple(t.to(home) for t in r)
                           if isinstance(r, tuple) else r.to(home))
        self.at, self._fans = at, fans
        with owning(((d, 0), self.w)):
            return combine(res)

    def _per_slot_replicated(self, fn, xs, combine, across):
        parts = [_fan(x, self.D) for x in xs]
        out = []
        fans, self._fans = self._fans, {}
        for d in self.lines():
            res = []
            for m in range(self.M):
                dev = self.devs[d][m]
                self.at = (d, m)
                with owning(((d, m), self.w)):
                    r = fn(m, dev, *(p[d].to(dev) for p in parts))
                    res.append(tuple(t.to(self.home) for t in r)
                               if isinstance(r, tuple) else r.to(self.home))
            with owning(("home", self.w)):
                out.append(combine(res))
        self.at, self._fans = (0, 0), fans
        if self.repr_rows:
            out = out * self.D
        with owning(("home", 1)):
            return across(out) if across is not None else out[0]

    def row_parallel(self, fn: Callable, xs: Sequence[torch.Tensor],
                     out_dtype) -> torch.Tensor:
        """Σ over the model slots of ``fn(m, device, *rows)`` (float32
        partials, summed in float32 on the line's device) cast once to
        `out_dtype`."""
        def total(line):
            acc = line[0]
            for p in line[1:]:
                acc = acc + p
            return acc

        out = self.per_slot(fn, xs, total)
        self.count("all_reduce", self.M * _nbytes(out), over=self.M,
                   per_line=True)
        return out.to(out_dtype)

    # -- the step ---------------------------------------------------------------
    def grads(self, loss_fn: Callable, params, batch: dict,
              accum: int = 1) -> tuple:
        """``(loss, metrics, grads)`` of ``loss_fn(params, batch)`` on the
        mesh, `params` a tree of Placed leaves: the gradients a tree of
        Placed leaves laid out as the parameters' (each logical block's
        gradient the sum over the devices holding it). `batch` as
        ``batch_rows`` takes it; ``loss_fn`` gets each microbatch's rows
        as ``batch_rows`` gives them (``Model.loss_fn`` runs its lines
        through ``shard_ctx.line_stats``). At ``accum`` > 1 the
        microbatches are consecutive rows of the batch, each split over
        the lines (the JAX package's ``micro_spec``), and the gradients
        are float32 sums divided by ``accum``."""
        from repro_torch.models import shard_ctx

        leaves = placed_leaves(params)
        subst: dict = {}
        slot_of: dict = {}
        for pl in leaves:
            for flat, t in enumerate(pl):
                if id(t) not in subst:
                    subst[id(t)] = t.detach().requires_grad_(True)
                    slot_of[id(t)] = divmod(flat, self.M)
        inputs = list(subst.values())
        micro = self.batch_rows(batch, accum)

        def view():
            """The parameters as the model takes them: one view, or per
            line a view of each block's alias for the line."""
            if not isinstance(micro[0], Lines):
                return self.view(params, subst)
            with _uncounted():
                fans = {i: _LineFan.apply(t, self.D)
                        for i, t in subst.items()}
            return Lines(self.view(params, {i: f[d] for i, f in
                                            fans.items()})
                         for d in range(self.D))

        prev = shard_ctx.executor()
        shard_ctx.bind(self)
        try:
            if accum == 1:
                with owning(("home", 1)):
                    loss, metrics = loss_fn(view(), micro[0])
                with owning(None):
                    gs = torch.autograd.grad(loss, inputs, allow_unused=True,
                                             materialize_grads=True)
                loss = loss.detach()
                metrics = {k: v.detach() for k, v in metrics.items()}
            else:
                # each block's float32 sums are its slot's
                slots = [(slot_of[i], 1) for i in subst]
                gs = []
                for t, who in zip(inputs, slots):
                    with owning(who):
                        gs.append(torch.zeros_like(t, dtype=torch.float32))
                loss = torch.zeros((), dtype=torch.float32, device=self.home)
                # the representative-row mode runs one microbatch for all:
                # every microbatch issues the same ops
                reps = [0] if self.repr_rows else range(accum)
                for i in reps:
                    with shard_ctx.repeating(accum // len(reps)):
                        with owning(("home", 1)):
                            li = loss_fn(view(), micro[i])[0]
                        with owning(None):
                            gi = torch.autograd.grad(li, inputs,
                                                     allow_unused=True,
                                                     materialize_grads=True)
                        for a, b, who in zip(gs, gi, slots):
                            with owning(who):
                                a.add_(b.float())
                        loss = loss + li.detach()
                        del gi, li
                for g, who in zip(gs, slots):
                    with owning(who):
                        g.div_(accum)
                loss = loss / accum
                metrics = {"nll": loss, "aux": torch.zeros_like(loss)}
        finally:
            shard_ctx.bind(prev)
            self.line = None
        grad_of = {}
        for i, g in zip(subst, gs):
            # the optimizer's work on a block is its slot's
            with owning((slot_of[i], 1)):
                grad_of[i] = g.view_as(g)
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
        decode step, written in place block by block), `args` the batch's
        tensors (or dicts of them), whole or placed by
        ``sharding.BatchShardings``. fn runs once per line on the line's
        rows and its result comes back as Placed leaves over the data
        axes; in the replicated mode it runs once on the home device and
        its result is replicated."""
        from repro_torch.models import shard_ctx

        packed = {str(i): a for i, a in enumerate(args)}
        rows = self.batch_rows(packed)[0]
        split = isinstance(rows, Lines)
        prev = shard_ctx.executor()
        shard_ctx.bind(self)
        try:
            with torch.no_grad():
                if not split:
                    with owning(("home", 1)):
                        outs = [fn(*(self.view(t) for t in trees),
                                   *(rows[k] for k in packed))]
                else:
                    outs = []
                    for d in self.lines():
                        self.line = d
                        with owning(((d, 0), self.w)):
                            outs.append(fn(*(self.view(t) for t in trees),
                                           *(rows[d][k] for k in packed)))
        finally:
            shard_ctx.bind(prev)
            self.line = None
        return self._rows_placed(outs, split)

    # -- cache blocks -------------------------------------------------------------
    def block_region(self, leaf: ShardLeaf, d: int, m: int) -> list:
        """The slices of the whole leaf that slot (d, m)'s block holds."""
        region = [slice(None)] * len(leaf.shape)
        for dim, k, n in ((leaf.ddim, d, self.D), (leaf.mdim, m, self.M)):
            if dim is not None:
                size = leaf.shape[dim] // n
                region[dim] = slice(k * size, (k + 1) * size)
        return region

    def _line_view(self, leaf: ShardLeaf, d: int, m: int):
        """``(region, tensor)`` of slot (d, m)'s block of a cache leaf
        (batch dim 0): in the replicated mode the block and its region of
        the whole leaf; while line d runs, the block's rows that are the
        line's (a view) and their region of the line's rows, or None
        where it holds none of them."""
        t = leaf.grid[d][m]
        region = self.block_region(leaf, d, m)
        if self.line is None:
            return region, t
        if leaf.ddim not in (None, 0):
            raise ValueError(f"a cache leaf with the data axes on dim "
                             f"{leaf.ddim} under a batch split over them")
        rows = leaf.shape[0] // self.D
        first = region[0].start or 0
        lo, hi = max(first, d * rows), min(first + t.shape[0],
                                          (d + 1) * rows)
        if lo >= hi:
            return None
        region[0] = slice(lo - d * rows, hi - d * rows)
        return region, t.narrow(0, lo - first, hi - lo)

    def blocks_of(self, leaf: ShardLeaf) -> list:
        """``[(region, tensor)]``: every distinct block tensor of a leaf;
        while a line runs, the line's rows of its blocks, the regions
        indexing the line's rows."""
        seen: dict = {}
        for d in (range(self.D) if self.line is None else [self.line]):
            for m in range(self.M):
                t = leaf.grid[d][m]
                if id(t) not in seen:
                    seen[id(t)] = self._line_view(leaf, d, m)
        return [v for v in seen.values() if v is not None]

    def gather_leaf(self, leaf):
        """A cache leaf's whole tensor (the running line's rows of it) on
        the line's device (an all-gather where it is split); a tensor as
        it is."""
        if not isinstance(leaf, ShardLeaf):
            return leaf
        dev = self.line_device()
        rows = leaf.shape[0] // (1 if self.line is None else self.D)
        whole = torch.empty((rows,) + leaf.shape[1:], dtype=leaf.dtype,
                            device=dev)
        for region, t in self.blocks_of(leaf):
            whole[tuple(region)] = t.to(dev)
        if leaf.ddim is not None or leaf.mdim is not None:
            self.count("all_gather", self.S * _nbytes(whole), per_line=True)
        return whole

    def store_tree(self, dst, src) -> None:
        """`src` (whole tensors: the running line's rows) written into the
        blocks of `dst`'s ShardLeaf leaves; a leaf that is the same object
        is left alone."""
        if dst is src:
            return
        if isinstance(dst, ShardLeaf):
            for region, t in self.blocks_of(dst):
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
        """``leaf[b, idx[b]] = vals[b]`` for every batch row (the running
        line's), into every block holding the position (dims 0 and 1:
        batch and sequence)."""
        for region, t in self.blocks_of(leaf):
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
        sequence dim 1) restricted to the running line's rows, ``start``
        the first sequence position its blocks hold, and its rows of
        `xs`; it returns ``(mx, l, acc)``. The model slots' partials
        combine along ``heads_dim`` where the model axis splits the heads,
        as an online softmax where it splits the sequence, and are taken
        once where it splits neither. In the replicated mode the data
        indices' are combined as an online softmax where the data axes
        split the sequence."""
        first = leaves[0]
        ddim, mdim = first.ddim, first.mdim

        def slot(m, dev, *rows):
            d = self.at[0]
            blocks = [self._line_view(leaf, d, m)[1] for leaf in leaves]
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
            self.count("all_reduce", (self.S if self.line is None
                                      else self.M)
                       * sum(_nbytes(t) for t in out), over=over,
                       per_line=True)
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
