"""The optimizer and learning-rate schedule of the fits (``core/vi.py``).

A copy of the JAX package's ``adamw`` and ``linear_warmup_cosine``
(``repro/optim``) for lists of tensors: the same update rule, step for
step. AdamW keeps float32 moments, clips the gradients to a global norm
of 1.0 first, and takes the schedule at the step count before the update,
so the first update uses ``lr(0)``, which is 0 after a warm-up.

Unlike the JAX package's pure pytree transform, ``AdamW.update`` writes
the new parameters into the given tensors in place, and keeps its moments
on the object: no second copy of ξ is made per step.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

__all__ = ["AdamW", "adamw", "linear_warmup_cosine", "cosine_decay",
           "global_norm"]


def cosine_decay(lr: float, total_steps: int,
                 final_frac: float = 0.1) -> Callable[[int], float]:
    def fn(step: int) -> float:
        t = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return lr * (final_frac
                     + (1.0 - final_frac) * 0.5 * (1.0 + math.cos(math.pi * t)))

    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1) -> Callable[[int], float]:
    """Linear warm-up from 0 over ``warmup_steps``, then a cosine decay to
    ``final_frac · lr`` at ``total_steps``."""
    cos = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step: int) -> float:
        if step < warmup_steps:
            return lr * step / max(warmup_steps, 1)
        return cos(step - warmup_steps)

    return fn


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the summed squares of every tensor, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


class AdamW:
    """AdamW over a list of tensors (see the module docstring).

    ``update(grads, params)`` applies one step in place."""

    def __init__(self, lr_schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip_norm: float | None = 1.0):
        self.lr_schedule, self.b1, self.b2, self.eps = lr_schedule, b1, b2, eps
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.step = 0
        self.m = self.v = None

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor],
               params: Sequence[torch.Tensor]) -> None:
        if self.m is None:
            self.m = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            self.v = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        scale = 1.0
        if self.clip_norm is not None:
            # stays on the device: no host sync per step
            scale = torch.clamp(
                self.clip_norm / (global_norm(grads) + 1e-12), max=1.0)
        lr = self.lr_schedule(self.step)
        self.step += 1
        c1 = 1.0 - self.b1 ** self.step
        c2 = 1.0 - self.b2 ** self.step
        for p, g, m, v in zip(params, grads, self.m, self.v):
            g32 = g.float() * scale
            m.mul_(self.b1).add_(g32, alpha=1 - self.b1)
            v.mul_(self.b2).add_(torch.square(g32), alpha=1 - self.b2)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            p.copy_(p.float() - lr * u)


def adamw(lr_schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: float | None = 1.0) -> AdamW:
    """AdamW with float32 moments and global-norm clipping, as the JAX
    package's ``repro.optim.adamw``."""
    return AdamW(lr_schedule, b1, b2, eps, weight_decay, clip_norm)
