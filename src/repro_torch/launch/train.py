"""Training driver of the LM port: the train loop with fault tolerance,
as the JAX package's ``repro.launch.train``.

  * the deterministic data pipeline (``data.pipeline``), prefetched to the
    device;
  * the train step (``launch.steps``), with gradient accumulation where
    ``choose_accum`` asks for it;
  * async, atomically published checkpoints every ``ckpt_every`` steps
    (``checkpoint.CheckpointManager``), and a resume from the latest one
    with the exact data order;
  * ``FaultSupervisor``: on a failed step, restore the latest checkpoint
    and rebuild the iterator at its step;
  * ``StragglerMonitor``: robust step-time outlier detection;
  * ``fail_at``: one injected failure, the fault drill.

The loop runs on the card unless the caller passes ``device="cpu"``; it
does not fall back. On a mesh of more than one slot the step is the
sharded executor's (``launch/steps.py``), the pipeline places each data
index's rows on its own slots (``make_batch_iterator(shardings=)``, the
step's ``batch_shardings``: the JAX package's ``batch_sh``), checkpoints
record each leaf's spec, and a
restore (the supervisor's, or a resume) places the leaves back by those
specs on the loop's mesh, which may have another shape than the one that
saved them. A mesh whose devices are not there raises; a mesh is never
run as one slot. ``python -m repro_torch.launch.train --arch X --smoke``
trains the reduced config of X (``--mesh 2x2`` on a virtual mesh of
the device).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator
from repro_torch.distributed.fault import FaultSupervisor, StragglerMonitor
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_mesh
from repro_torch.launch.steps import choose_accum, make_train_step
from repro_torch.models import build_model

__all__ = ["TrainLoopResult", "train_loop", "main"]


@dataclasses.dataclass
class TrainLoopResult:
    steps_done: int
    final_loss: float
    losses: list
    restarts: int
    stragglers: int
    step_ms: list = dataclasses.field(default_factory=list)
    enqueue_ms: list = dataclasses.field(default_factory=list)
    state: tuple = None      # the final (params, opt_state)


class _StepClock:
    """Each step's time: CUDA events around it on the card (read once the
    loss is on the host), the host clock on the CPU; and the host time to
    enqueue it."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        self.t0 = time.perf_counter()
        if self.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()

    def enqueued(self) -> float:
        if self.cuda:
            self.ev1.record()
        return (time.perf_counter() - self.t0) * 1e3

    def elapsed(self) -> float:
        """After the step's loss was read (the device is done with it)."""
        if self.cuda:
            return self.ev0.elapsed_time(self.ev1)
        return (time.perf_counter() - self.t0) * 1e3


def train_loop(cfg, mesh: Optional[Mesh] = None, *, steps: int,
               global_batch: int, seq_len: int,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               seed: int = 0, fail_at: Optional[int] = None,
               log_every: int = 10, device="cuda") -> TrainLoopResult:
    """Run `steps` optimizer steps of `cfg` on `mesh` (default: one slot
    on `device`; a mesh of more than one slot runs the sharded step).
    `fail_at` injects one synthetic failure before that step (the fault drill; recovered from only with a checkpoint
    directory)."""
    if mesh is None:
        mesh = make_host_mesh(devices=[torch.device(device)])
    _check_devices(mesh)
    cell = ShapeCell("train", seq_len, global_batch, "train")
    accum = choose_accum(build_model(cfg), cell, mesh)
    ts = make_train_step(cfg, mesh, accum=accum, total_steps=steps)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq_len,
                           global_batch=global_batch, seed=seed)
    spec_tree = on_mesh = None
    if ts.params_sh is not None:
        spec_tree = (ts.params_sh.spec_tree, ts.opt_sh.spec_tree)
        on_mesh = mesh

    batch_sh = ts.batch_shardings({
        k: torch.empty((global_batch, seq_len), dtype=torch.int32,
                       device="meta") for k in ("tokens", "labels")})

    params, opt_state = ts.init_state(
        torch.Generator(device=ts.device).manual_seed(seed))
    start_step = 0
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if ckpt and ckpt.latest_step() is not None:
        start_step, (params, opt_state) = ckpt.restore((params, opt_state),
                                                       mesh=on_mesh)
        print(f"resumed from checkpoint step {start_step}")

    def restore():
        ckpt.wait()   # a save in flight publishes first
        return ckpt.restore((params, opt_state), mesh=on_mesh)

    supervisor = FaultSupervisor(restore_fn=restore) if ckpt else None
    straggler = StragglerMonitor()
    clock = _StepClock(ts.device)
    losses, step_ms, enqueue_ms = [], [], []
    it = make_batch_iterator(data, start_step=start_step, device=ts.device,
                             shardings=batch_sh)
    state = (params, opt_state)
    step = start_step
    injected = False
    try:
        while step < steps:
            batch = next(it)
            clock.start()

            def one(state):
                nonlocal injected
                if fail_at is not None and step == fail_at and not injected:
                    injected = True
                    raise RuntimeError("injected device failure (drill)")
                p, o, metrics = ts.fn(state[0], state[1], batch)
                return (p, o), metrics

            if supervisor is not None:
                out, step_new, failed = supervisor.run(one, state, step)
                if failed:
                    step = step_new
                    state = out
                    it.close()
                    it = make_batch_iterator(data, start_step=step,
                                             device=ts.device,
                                             shardings=batch_sh)
                    continue
                state, metrics = out
                step = step_new
            else:
                state, metrics = one(state)
                step += 1
            enq = clock.enqueued()
            loss = float(metrics["loss"])
            losses.append(loss)
            step_ms.append(clock.elapsed())
            enqueue_ms.append(enq)
            straggler.observe(time.perf_counter() - clock.t0)
            if step % log_every == 0:
                print(f"step {step}: loss={loss:.4f} "
                      f"({step_ms[-1]:.1f} ms/step)", flush=True)
            if ckpt and step % ckpt_every == 0:
                ckpt.save(step, state, spec_tree=spec_tree)
        if ckpt:
            ckpt.save(steps, state, blocking=True, spec_tree=spec_tree)
    finally:
        it.close()
        if ckpt:
            ckpt.wait()
    return TrainLoopResult(
        steps_done=step, final_loss=losses[-1] if losses else float("nan"),
        losses=losses, restarts=supervisor.restarts if supervisor else 0,
        stragglers=straggler.stragglers, step_ms=step_ms,
        enqueue_ms=enqueue_ms, state=state)


def _check_devices(mesh: Mesh) -> None:
    """Raise unless every device of `mesh` is there."""
    for dev in mesh.distinct_devices():
        if dev.type != "cuda":
            continue
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass device='cpu' (or a mesh "
                               "of cpu slots) to train on the CPU")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"the mesh names {dev} but only "
                               f"{torch.cuda.device_count()} cards are "
                               "visible")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL: a virtual mesh of that many slots "
                         "of --device")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    mesh = None
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.split("x"))
        mesh = make_mesh(shape, ("data", "model"),
                         devices=[args.device] * (shape[0] * shape[1]))
    res = train_loop(cfg, mesh, steps=args.steps,
                     global_batch=args.global_batch, seq_len=args.seq_len,
                     ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"done: {res.steps_done} steps, final loss {res.final_loss:.4f}, "
          f"{res.restarts} restarts, {res.stragglers} stragglers")


if __name__ == "__main__":
    main()
