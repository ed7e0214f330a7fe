"""Learning-rate schedules: functions of the step count, as the JAX
package's ``repro.optim.schedules``.

Each takes the step as an int tensor on the device (or a Python number,
which becomes a 0-d tensor) and returns a float32 tensor computed there
with torch ops, as the JAX package's compute with jnp: an optimizer
update that reads its schedule never syncs with the host, and a captured
CUDA graph of one advances the rate on every replay.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

Step = Union[int, torch.Tensor]
Schedule = Callable[[Step], torch.Tensor]

__all__ = ["constant", "cosine_decay", "linear_warmup_cosine"]


def constant(lr: float) -> Schedule:
    def fn(step):
        step = torch.as_tensor(step)
        return torch.full((), lr, dtype=torch.float32, device=step.device)

    return fn


def cosine_decay(lr: float, total_steps: int,
                 final_frac: float = 0.1) -> Schedule:
    def fn(step):
        t = torch.clamp(torch.as_tensor(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1.0 - final_frac) * cos)

    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1) -> Schedule:
    """Linear warm-up from 0 over ``warmup_steps``, then a cosine decay to
    ``final_frac · lr`` at ``total_steps``."""
    cos = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        step = torch.as_tensor(step)
        return torch.where(step < warmup_steps,
                           lr * step / max(warmup_steps, 1),
                           cos(step - warmup_steps))

    return fn
