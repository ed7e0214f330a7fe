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

``AdamW`` is the fits' optimizer (``core/vi.py``): the same AdamW rule
over a list of tensors, applied in place, its moments and step count on
the object, so that a captured CUDA graph of one update advances the
count, the learning rate and the corrections on every replay. The first
update uses ``lr(0)``, which is 0 after a warm-up.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import torch

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
    """sqrt of the summed squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree_leaves(tree)))


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
    """A gradient leaf in float32, times the clip's scale (None: 1)."""
    g32 = g.float()
    return g32 if scale is None else g32 * scale


def _step0(params: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _subtrees(tree: Tree, like: Tree) -> list:
    """The subtrees of `tree` at the places of `like`'s leaves (the JAX
    package's ``treedef.flatten_up_to``)."""
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in _subtrees(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [s for t, l in zip(tree, like) for s in _subtrees(t, l)]
    return [tree]


def _adamw_leaf(p, g32, m, v, lr, c1, c2, b1, b2, eps, weight_decay):
    """One AdamW update of one leaf, in place: the moments from the
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
        lr = lr_schedule(state.step)
        if momentum:
            vel = tree_map(lambda v, g: v * torch.tensor(momentum,
                                                         dtype=v.dtype) + g,
                           state.inner, grads)
            new = tree_map(lambda p, v: p - _widened(v) * lr, params, vel)
            return new, OptState(state.step + 1, vel)
        new = tree_map(lambda p, g: p - _widened(g) * lr, params, grads)
        return new, OptState(state.step + 1, None)

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
        step = state.step + 1
        lr = lr_schedule(state.step)
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.inner["m"]),
                              tree_leaves(state.inner["v"])):
            _adamw_leaf(p, _scaled_f32(g, scale), m, v, lr, c1, c2, b1, b2,
                        eps, weight_decay)
        return params, OptState(step, state.inner)

    return Optimizer(init, update)


def adafactor(lr_schedule, eps: float = 1e-30, clip_norm: float | None = 1.0,
              min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8) -> Optimizer:
    """Adafactor: a factored second moment (row and column statistics) for
    leaves whose two trailing dims are both >= ``min_dim_size_to_factor``,
    a full one otherwise; no momentum; updates clipped to RMS 1.
    Parameters and statistics are updated in place."""

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
        step = state.step + 1
        lr = lr_schedule(state.step)
        beta = 1.0 - step.float() ** (-decay_rate)   # 0 at the first step
        for p, g, s in zip(tree_leaves(params), tree_leaves(grads),
                           _subtrees(state.inner, params)):
            g32 = _scaled_f32(g, scale)
            g2 = torch.square(g32).add_(eps)
            if "v" in s:
                s["v"].mul_(beta).add_(g2.mul_(1 - beta))
                pre = torch.rsqrt(s["v"] + eps)
            else:
                s["vr"].mul_(beta).add_(g2.mean(-1).mul_(1 - beta))
                s["vc"].mul_(beta).add_(g2.mean(-2).mul_(1 - beta))
                rfac = torch.rsqrt(
                    s["vr"] / s["vr"].mean(-1, keepdim=True) + eps)
                cfac = torch.rsqrt(s["vc"] + eps)
                pre = rfac[..., None] * cfac[..., None, :]
            del g2
            upd = g32 * pre
            del g32, pre
            # update clipping (Adafactor's RMS-1 rule)
            rms = torch.sqrt(torch.mean(torch.square(upd)) + eps)
            upd.div_(torch.clamp(rms, min=1.0))
            p.copy_(p.float() - upd.mul_(lr))
        return params, OptState(step, state.inner)

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
