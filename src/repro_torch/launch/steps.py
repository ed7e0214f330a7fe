"""The train step of the LM port, as the JAX package's
``repro.launch.steps`` builds it for any architecture.

The JAX package jits one step and shards it over a device mesh; the port
runs it op by op: autograd over the parameter tree (``Model.loss_fn``,
with the model's checkpoints), then an optimizer update in place. On a
one-slot mesh the tree is plain tensors on the slot's device. On a mesh of
more than one slot the parameters and the optimizer state are placed by
``param_specs`` / ``opt_state_specs`` (``TrainStep.params_sh`` /
``opt_sh``, ``elastic.Placed`` leaves) and the step runs through the
sharded executor (``distributed/executor.py``): FSDP gathers at use,
tensor parallelism over the model axis, the optimizer on the blocks; the
executor's ``counts`` hold the step's collective calls and bytes.

The optimizer follows the JAX package's rule: AdamW under 100 B
parameters, Adafactor above (its factored state keeps the 236 B and 400 B
MoE configs within one pod), with a warm-up capped by the run's length.
``choose_accum`` is the JAX package's gradient-accumulation rule, computed
from the shapes alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.models.transformer import layer_plan
from repro_torch.models.tree import tree_leaves, tree_unflatten
from repro_torch.optim import linear_warmup_cosine
from repro_torch.optim.optimizers import adafactor, adamw

__all__ = ["ADAFACTOR_THRESHOLD", "TrainStep", "active_param_count",
           "choose_accum", "data_model_axes", "make_train_step",
           "select_optimizer"]

ADAFACTOR_THRESHOLD = 100e9


def data_model_axes(mesh: Mesh):
    """(data axes, model axes) of a mesh: ("pod", "data") where it has a
    pod axis."""
    data = ("pod", "data") if "pod" in mesh.shape else ("data",)
    return data, ("model",)


def _leaf_paths(tree, path=()):
    """(key path, leaf) of every leaf, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, path + (str(i),))
    else:
        yield path, tree


def active_param_count(model) -> int:
    """Active-per-token parameters (MoE: top_k/E of the routed experts'
    leaves, the shared experts' included, as the JAX package counts them),
    counted on the ``meta`` device."""
    cfg = model.cfg
    total = 0.0
    for names, leaf in _leaf_paths(model.params_spec()):
        n = float(np.prod(leaf.shape))
        if cfg.moe and "moe" in names and names[-1] in ("gate", "up",
                                                        "down"):
            n *= cfg.moe.top_k / cfg.moe.n_experts
        total += n
    return int(total)


def select_optimizer(model, total_steps: int = 10_000):
    """(optimizer, name): AdamW (weight decay 0.1) under
    ``ADAFACTOR_THRESHOLD`` parameters, Adafactor above; peak rate 3e-4
    after a linear warm-up of min(200, total_steps // 10) steps (at least
    1), then a cosine decay."""
    n = model.param_count()
    # cap warmup by the run length: a short run (tests, smoke examples) must
    # reach a useful lr, not spend every step inside a 200-step ramp
    warmup = min(200, max(1, total_steps // 10))
    sched = linear_warmup_cosine(3e-4, warmup, total_steps)
    if n > ADAFACTOR_THRESHOLD:
        return adafactor(sched), "adafactor"
    return adamw(sched, weight_decay=0.1), "adamw"


@dataclasses.dataclass
class TrainStep:
    fn: Callable        # (params, opt_state, batch) -> (params, opt_state,
    #                     {"loss", "nll", "aux"})
    opt_name: str
    model: Any
    optimizer: Any
    device: torch.device
    params_sh: Any = None    # on a mesh: the placements (sharding.Shardings)
    opt_sh: Any = None
    executor: Any = None     # on a mesh: the sharded executor

    def init_state(self, generator: torch.Generator):
        """(params, opt_state) drawn from `generator` on the step's
        device, placed on the mesh where the step has one."""
        params = self.model.init_params(generator, device=self.device)
        opt_state = self.optimizer.init(params)
        if self.params_sh is None:
            return params, opt_state
        return self.params_sh.place(params), self.opt_sh.place(opt_state)


def choose_accum(model, cell: ShapeCell, mesh: Mesh) -> int:
    """Gradient-accumulation factor targeting ~10 GB per device of
    activation pressure, the JAX package's rule (its peak model was
    calibrated against XLA buffer dumps):

        peak ≈ carries + backward working set
             = n_groups·b_loc·S·D·6B  +  9 f32 copies ·
               layers_per_group·b_loc·S·D·4B

    Both terms scale 1/accum, so accum = ceil(peak / 10 GB) (a power of
    two, at most 16, cut so the microbatch still divides the data
    axes). whisper's peak is its encoder's (B, H, F, F) float32 scores."""
    cfg = model.cfg
    data_axes, _ = data_model_axes(mesh)
    dsz = int(np.prod([mesh.shape[a] for a in data_axes]))
    b_loc = max(cell.global_batch // dsz, 1)
    if cfg.encoder is not None:
        fr = cfg.encoder.n_frames
        peak = 16 * b_loc * cfg.n_heads * fr * fr * 4
    else:
        _, period, n_groups, _ = layer_plan(cfg)
        tok_bytes = b_loc * cell.seq_len * cfg.d_model
        peak = n_groups * tok_bytes * 6 + 9 * len(period) * tok_bytes * 4
    accum = 1
    while peak / accum > 10e9 and accum < 16:
        accum *= 2
    while accum > 1 and (cell.global_batch // accum) % dsz != 0:
        accum //= 2
    return accum


def _grads(model, params, leaves, batch) -> tuple:
    """(loss, metrics, gradient leaves) of one batch; a leaf the loss does
    not reach gets zeros, as ``jax.grad`` gives it."""
    loss, metrics = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), metrics, grads


def make_train_step(cfg: ArchConfig, mesh: Mesh, *, accum: int = 1,
                    total_steps: int = 10_000) -> TrainStep:
    """The train step of `cfg` on `mesh` (see the module docstring for a
    mesh of more than one slot). At ``accum`` 1 the
    gradients come in the parameters' dtype; above, the batch is split
    into ``accum`` microbatches of consecutive rows, the gradients are
    float32 sums divided by ``accum``, and the metrics are ``{"loss",
    "nll": loss, "aux": 0}``, as the JAX package's scan gives them."""
    device = mesh.devices.flat[0]
    model = build_model(cfg)
    opt, opt_name = select_optimizer(model, total_steps=total_steps)
    if mesh.size != 1:
        return _sharded_step(model, mesh, opt, opt_name, accum)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        if accum == 1:
            loss, metrics, grads = _grads(model, params, leaves, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            grads = [torch.zeros_like(t, dtype=torch.float32)
                     for t in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(accum):
                li, _, gi = _grads(model, params, leaves,
                                   {k: v[i] for k, v in micro.items()})
                for a, b in zip(grads, gi):
                    a.add_(b.float())
                loss = loss + li
                del gi
            for g in grads:
                g.div_(accum)
            loss = loss / accum
            metrics = {"nll": loss, "aux": torch.zeros_like(loss)}
        grads = tree_unflatten(params, grads)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **metrics}

    return TrainStep(fn=train_step, opt_name=opt_name, model=model,
                     optimizer=opt, device=device)


def _sharded_step(model, mesh: Mesh, opt, opt_name: str,
                  accum: int) -> TrainStep:
    """The train step on a mesh of more than one slot: parameters and
    optimizer state placed by their specs, the whole batch (on the mesh's
    first device) split over the data slots by rows, microbatches of
    consecutive rows at ``accum`` > 1 as the JAX package's ``micro_spec``
    lays them out."""
    from repro_torch.distributed.executor import Executor
    from repro_torch.distributed.sharding import (opt_state_specs,
                                                  param_specs, shardings_for)

    data_axes, model_axes = data_model_axes(mesh)
    ex = Executor(mesh, data_axes, model_axes)
    p_meta = model.params_spec()
    params_sh = shardings_for(
        param_specs(p_meta, mesh, data_axes, model_axes), mesh)
    opt_sh = shardings_for(
        opt_state_specs(opt.init(p_meta), mesh, data_axes, model_axes), mesh)

    def train_step(params, opt_state, batch):
        ex.reset()
        loss, metrics, grads = ex.grads(model.loss_fn, params, batch, accum)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **metrics}

    return TrainStep(fn=train_step, opt_name=opt_name, model=model,
                     optimizer=opt, device=ex.home, params_sh=params_sh,
                     opt_sh=opt_sh, executor=ex)
