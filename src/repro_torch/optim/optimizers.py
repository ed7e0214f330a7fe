"""Optimizers over trees of tensors, as the JAX package's
``repro.optim.optimizers``, and the fits' in-place AdamW.

``sgd``, ``adamw`` and ``adafactor`` return an ``Optimizer``: ``init(params)``
gives an ``OptState(step, inner)`` whose leaves mirror the parameters'
(``adafactor``'s factored leaves hold row and column statistics), and
``update(grads, state, params)`` gives ``(params, state)``. The rules are
the JAX package's, op for op, dtype promotions included: a Python
constant takes the tensor's dtype, the schedule's rate is a float32
tensor, and ``sgd`` therefore returns float32 parameters from bfloat16
ones, as the JAX package's does. ``adamw`` and ``adafactor`` write the new
parameters and their state into the given tensors IN PLACE and return
them: no second copy of the parameter or gradient tree is made (the JAX
package's ``clip_by_global_norm`` copies the gradients; here the clip's
scale is folded into each leaf's update). The step count and the rate
stay on the device.

On a mesh (``launch/steps.py``) the trees' leaves are ``elastic.Placed``
blocks, and the same code runs on them, a plain tensor being a leaf of
one block: each distinct block is updated once (a replicated leaf shared
by slots on one device is not stepped twice), the clip's global norm sums
each logical block once across all slots, and Adafactor's row and column
statistics and its RMS-1 clip reduce over every block of the dims they
reduce.

``AdamW`` is the fits' optimizer (``core/vi.py``): the same AdamW rule
over a list of tensors, applied in place, its moments and step count on
the object, so that a captured CUDA graph of one update advances the
count, the learning rate and the corrections on every replay. The first
update uses ``lr(0)``, which is 0 after a warm-up.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.distributed.elastic import Placed, gather, logical_blocks
from repro_torch.models.tree import tree_leaves, tree_map

__all__ = ["OptState", "Optimizer", "AdamW", "global_norm",
           "clip_by_global_norm", "sgd", "adamw", "adafactor"]

Tree = Any


class OptState(NamedTuple):
    step: torch.Tensor      # int32, 0-d, on the parameters' device
    inner: Tree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], OptState]
    update: Callable[[Tree, OptState, Tree], tuple]  # -> (params, state)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the summed squares of every leaf, in float32 (a placed
    leaf's each logical block once, on its first leaf's device)."""
    leaves = _leaves(tree)
    home = _first(leaves[0]).device
    return torch.sqrt(sum(torch.sum(torch.square(copies[0].float())).to(home)
                          for leaf in leaves for _, copies in _blocks(leaf)))


def _widened(t: torch.Tensor) -> torch.Tensor:
    """`t` promoted with float32, as jnp promotes it against a float32
    array (bfloat16 -> float32)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _clip_scale(grads: Tree, max_norm: float) -> tuple:
    norm = global_norm(grads)
    return torch.clamp(max_norm / (norm + 1e-12), max=1.0), norm


def clip_by_global_norm(tree: Tree, max_norm: float) -> tuple:
    """(tree scaled to global norm <= max_norm, its norm before)."""
    scale, norm = _clip_scale(tree, max_norm)
    return tree_map(lambda g: _widened(g) * scale, tree), norm


def _scaled_f32(g: torch.Tensor, scale) -> torch.Tensor:
    """A gradient tensor in float32, times the clip's scale (None: 1),
    on the gradient's device."""
    g32 = g.float()
    return g32 if scale is None else g32 * scale.to(g.device)


def _step0(params: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _subtrees(tree: Tree, like: Tree) -> list:
    """The subtrees of `tree` at the places of `like`'s leaves (the JAX
    package's ``treedef.flatten_up_to``); a Placed leaf is a leaf."""
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in _subtrees(tree[k], like[k])]
    if isinstance(like, (list, tuple)) and not isinstance(like, Placed):
        return [s for t, l in zip(tree, like) for s in _subtrees(t, l)]
    return [tree]


# -- leaves: a tensor, or a Placed leaf's blocks (the sharded executor's) -----
def _leaves(tree: Tree) -> list:
    """The leaves of a tree in ``tree_leaves`` order, a Placed leaf as
    one."""
    if isinstance(tree, (torch.Tensor, Placed)):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if tree is None:
        return []
    return [x for sub in tree for x in _leaves(sub)]


def _first(x):
    """A tensor, or a Placed leaf's first block."""
    return x[0] if isinstance(x, Placed) else x


def _blocks(leaf) -> list:
    """``[(slices, copies), ...]``: a Placed leaf's logical blocks
    (``elastic.logical_blocks``); a tensor is one block, held by
    itself."""
    if isinstance(leaf, Placed):
        return logical_blocks(leaf)
    return [((slice(None),) * leaf.ndim, [leaf])]


def _distinct(*leaves) -> list:
    """The distinct tensors of the first of leaves laid out alike, each
    with the same slot's tensors of the others: a tensor once, a Placed
    leaf's distinct blocks once each (a block that slots on one device
    share is one tensor, stepped once)."""
    if not isinstance(leaves[0], Placed):
        return [leaves]
    seen, out = set(), []
    for i, t in enumerate(leaves[0]):
        if id(t) not in seen:
            seen.add(id(t))
            out.append((t,) + tuple(leaf[i] for leaf in leaves[1:]))
    return out


def _map_distinct(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the distinct tensors of a tree's leaves (and the same
    slots' tensors of `rest`): a new tree, blocks that slots share staying
    shared."""
    if isinstance(tree, Placed):
        out: dict = {}
        for i, t in enumerate(tree):
            if id(t) not in out:
                out[id(t)] = fn(t, *(r[i] for r in rest))
        return tree.like([out[id(t)] for t in tree])
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_distinct(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map_distinct(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


def _whole(leaf, device) -> torch.Tensor:
    """A Placed leaf's whole tensor on `device`; a tensor itself."""
    return gather(leaf, device) if isinstance(leaf, Placed) else leaf


def _scatter(full: torch.Tensor, leaf) -> None:
    """Write a whole tensor back into a Placed leaf's blocks, in place (a
    tensor is already `full`)."""
    if not isinstance(leaf, Placed):
        return
    for sl, copies in logical_blocks(leaf):
        for c in copies:
            c.copy_(full[sl].to(c.device))


def _adamw_leaf(p, g32, m, v, lr, c1, c2, b1, b2, eps, weight_decay):
    """One AdamW update of one tensor, in place: the moments from the
    float32 gradient `g32`, then the parameter (``AdamW`` and ``adamw``
    share it, so that they agree bit for bit)."""
    m.mul_(b1).add_(g32, alpha=1 - b1)
    v.mul_(b2).add_(torch.square(g32), alpha=1 - b2)
    u = (m / c1).div_(torch.sqrt(v / c2).add_(eps))
    if weight_decay:
        u.add_(weight_decay * p.float())
    p.copy_(p.float() - u.mul_(lr))


def sgd(lr_schedule, momentum: float = 0.0) -> Optimizer:
    """SGD, with heavy-ball momentum when ``momentum`` is nonzero (the
    velocity in the parameters' dtype, as ``jnp.zeros_like``)."""

    def init(params):
        inner = tree_map(torch.zeros_like, params) if momentum else None
        return OptState(_step0(params), inner)

    @torch.no_grad()
    def update(grads, state, params):
        lr = lr_schedule(_first(state.step))
        vel = None
        if momentum:
            vel = _map_distinct(
                lambda v, g: v * torch.tensor(momentum, dtype=v.dtype) + g,
                state.inner, grads)
            grads = vel
        new = _map_distinct(lambda p, g: p - _widened(g) * lr.to(p.device),
                            params, grads)
        return new, OptState(_map_distinct(lambda t: t + 1, state.step),
                             vel)

    return Optimizer(init, update)


def adamw(lr_schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: float | None = 1.0
          ) -> Optimizer:
    """AdamW with float32 moments mirroring the parameters' shapes;
    parameters and moments are updated in place."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return OptState(_step0(params), {"m": tree_map(zeros, params),
                                         "v": tree_map(zeros, params)})

    @torch.no_grad()
    def update(grads, state, params):
        scale = (None if clip_norm is None
                 else _clip_scale(grads, clip_norm)[0])
        lr = lr_schedule(_first(state.step))
        step = _first(state.step) + 1
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()
        for leaves in zip(_leaves(params), _leaves(grads),
                          _leaves(state.inner["m"]),
                          _leaves(state.inner["v"])):
            for p, g, m, v in _distinct(*leaves):
                on = p.device
                _adamw_leaf(p, _scaled_f32(g, scale), m, v, lr.to(on),
                            c1.to(on), c2.to(on), b1, b2, eps, weight_decay)
        return params, OptState(_map_distinct(lambda t: t + 1, state.step),
                                state.inner)

    return Optimizer(init, update)


def adafactor(lr_schedule, eps: float = 1e-30, clip_norm: float | None = 1.0,
              min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8) -> Optimizer:
    """Adafactor: a factored second moment (row and column statistics) for
    leaves whose two trailing dims are both >= ``min_dim_size_to_factor``,
    a full one otherwise; no momentum; updates clipped to RMS 1.
    Parameters and statistics are updated in place. On a Placed leaf the
    row and column statistics and the RMS of the update reduce over every
    block of the dims they reduce (a tensor is one block)."""

    def _factored(shape):
        return len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor and \
            shape[-2] >= min_dim_size_to_factor

    def init(params):
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                          device=p.device)
            if _factored(p.shape):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return OptState(_step0(params), tree_map(one, params))

    @torch.no_grad()
    def update(grads, state, params):
        scale = (None if clip_norm is None
                 else _clip_scale(grads, clip_norm)[0])
        lr = lr_schedule(_first(state.step))
        step = _first(state.step) + 1
        beta = 1.0 - step.float() ** (-decay_rate)   # 0 at the first step
        for p, g, s in zip(_leaves(params), _leaves(grads),
                           _subtrees(state.inner, params)):
            home = _first(p).device
            blocks = [(sl, copies, _scaled_f32(gc[0], scale).to(home))
                      for (sl, copies), (_, gc) in zip(_blocks(p),
                                                       _blocks(g))]
            n = float(np.prod(p.shape))
            if "v" in s:
                pres = []
                for (_, _, g32), (_, vcopies) in zip(blocks, _blocks(s["v"])):
                    g2 = torch.square(g32).add_(eps)
                    v0 = vcopies[0]
                    v0.mul_(beta.to(v0.device)).add_(
                        g2.mul_(1 - beta).to(v0.device))
                    for c in vcopies[1:]:
                        c.copy_(v0.to(c.device))
                    pres.append(torch.rsqrt(v0.to(home) + eps))
                del g2
            else:
                rows, cols = p.shape[-2], p.shape[-1]
                vr, vc = _whole(s["vr"], home), _whole(s["vc"], home)
                rmean = torch.zeros(vr.shape, dtype=torch.float32,
                                    device=home)
                cmean = torch.zeros(vc.shape, dtype=torch.float32,
                                    device=home)
                for sl, _, g32 in blocks:
                    g2 = torch.square(g32).add_(eps)
                    rmean[sl[:-1]] += g2.mean(-1) * (g2.shape[-1] / cols)
                    cmean[sl[:-2] + sl[-1:]] += g2.mean(-2) * (
                        g2.shape[-2] / rows)
                del g2
                vr.mul_(beta).add_(rmean.mul_(1 - beta))
                vc.mul_(beta).add_(cmean.mul_(1 - beta))
                del rmean, cmean
                _scatter(vr, s["vr"])
                _scatter(vc, s["vc"])
                rfac = torch.rsqrt(vr / vr.mean(-1, keepdim=True) + eps)
                cfac = torch.rsqrt(vc + eps)
                pres = [rfac[sl[:-1]][..., None]
                        * cfac[sl[:-2] + sl[-1:]][..., None, :]
                        for sl, _, _ in blocks]
            upds = [g32 * pre for (_, _, g32), pre in zip(blocks, pres)]
            del blocks[:], pres
            # update clipping (Adafactor's RMS-1 rule), over every block
            rms = torch.sqrt(sum(torch.mean(torch.square(u)) * (u.numel() / n)
                                 for u in upds) + eps)
            for (_, copies), u in zip(_blocks(p), upds):
                u.div_(torch.clamp(rms, min=1.0)).mul_(lr.to(home))
                for c in copies:
                    c.copy_(c.float() - u.to(c.device))
        return params, OptState(_map_distinct(lambda t: t + 1, state.step),
                                state.inner)

    return Optimizer(init, update)


class AdamW:
    """AdamW over a list of tensors (see the module docstring).

    ``update(grads, params)`` applies one step in place. ``step`` is the
    number of updates applied, an int32 tensor on the parameters' device
    from the first update on (None before it)."""

    def __init__(self, lr_schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip_norm: float | None = 1.0):
        self.lr_schedule, self.b1, self.b2, self.eps = lr_schedule, b1, b2, eps
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.step = self.m = self.v = None

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor],
               params: Sequence[torch.Tensor]) -> None:
        if self.m is None:
            self.m = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            self.v = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            self.step = torch.zeros((), dtype=torch.int32,
                                    device=params[0].device)
        scale = 1.0
        if self.clip_norm is not None:
            # stays on the device: no host sync per step
            scale = torch.clamp(
                self.clip_norm / (global_norm(grads) + 1e-12), max=1.0)
        lr = self.lr_schedule(self.step)
        self.step.add_(1)
        step = self.step.float()
        c1 = 1.0 - self.b1 ** step
        c2 = 1.0 - self.b2 ** step
        for p, g, m, v in zip(params, grads, self.m, self.v):
            _adamw_leaf(p, g.float() * scale, m, v, lr, c1, c2, self.b1,
                        self.b2, self.eps, self.weight_decay)
