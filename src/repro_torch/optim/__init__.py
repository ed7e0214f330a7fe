"""Optimizers and learning-rate schedules of the port (the JAX package's
``repro.optim``): ``optimizers`` (``sgd``, ``adamw``, ``adafactor`` over
trees of tensors, ``clip_by_global_norm``, ``global_norm``; the fits'
in-place ``AdamW``) and ``schedules``."""
from .optimizers import (AdamW, OptState, Optimizer, adafactor,
                         clip_by_global_norm, global_norm, sgd)
from .schedules import constant, cosine_decay, linear_warmup_cosine

# the fits' AdamW (core/vi.py): ``adamw(schedule)`` is the in-place AdamW
# over a list of tensors; the JAX package's tree transform, an
# ``Optimizer``, is ``optimizers.adamw`` (the LM train step's)
adamw = AdamW

__all__ = ["OptState", "Optimizer", "AdamW", "adamw", "adafactor", "sgd",
           "clip_by_global_norm", "global_norm", "constant", "cosine_decay",
           "linear_warmup_cosine"]
