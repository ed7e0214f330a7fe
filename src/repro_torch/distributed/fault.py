"""Fault tolerance and straggler detection: a copy of the JAX package's
``repro/distributed/fault.py``, which is numpy only, kept here so that
the port imports nothing of that package.

The serving policy (``launch/serve_gp.py``): every slab attempt runs
under ``ServingFaultSupervisor.execute``. A transient error retries the
same attempt with backoff (on the card: the same captured graph, replayed
again; no retry falls back to an eager path or to the plain versions);
``DeviceLossError`` is never retried in place: it propagates to the
server's re-plan onto the surviving slots of its mesh (without a mesh
there is nothing to re-plan onto, and it propagates to the caller).
Every attempt's wall time feeds the ``StragglerMonitor`` (median + MAD),
which the chaos suite (``chaos.check_straggler_detection``) holds to
flag a delayed slab.

``FaultSupervisor`` is the training driver's restore-and-retry policy,
kept with the rest of the module for the fits' driver to come.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np


class DeviceLossError(RuntimeError):
    """A device (or its runtime) is gone.

    Unlike a transient collective hiccup this is **not retryable in place**:
    re-running the slab on the same mesh cannot succeed. The serving layer
    catches it and runs the re-plan path (shrink mesh → remesh cached state
    → rewarm executable → replay the in-flight slab); the training driver
    maps it onto restore + elastic re-mesh.
    """

    def __init__(self, device_ids, message: str = ""):
        self.device_ids = tuple(int(i) for i in device_ids)
        super().__init__(
            message or f"lost device(s) {list(self.device_ids)}")


@dataclasses.dataclass
class StragglerMonitor:
    threshold_mads: float = 6.0
    window: int = 64
    min_samples: int = 8
    _times: list = dataclasses.field(default_factory=list)
    stragglers: int = 0

    def observe(self, step_time: float) -> bool:
        """Record a step time; returns True if it was a straggler step."""
        times = self._times
        is_straggler = False
        if len(times) >= self.min_samples:
            med = float(np.median(times))
            mad = float(np.median(np.abs(np.asarray(times) - med))) + 1e-9
            if step_time > med + self.threshold_mads * mad and \
                    step_time > 1.5 * med:
                is_straggler = True
                self.stragglers += 1
        times.append(step_time)
        if len(times) > self.window:
            times.pop(0)
        return is_straggler

    @property
    def median(self) -> float:
        return float(np.median(self._times)) if self._times else 0.0


@dataclasses.dataclass
class FaultSupervisor:
    """Wraps the train step with restore-and-retry semantics."""

    restore_fn: Callable[[], tuple]        # () -> (step, state)
    max_restarts: int = 5
    on_failure: Optional[Callable] = None  # (exc, restart_count) -> None
    restarts: int = 0

    def run(self, step_fn: Callable, state, step: int):
        """Run one step; on failure restore from checkpoint and signal the
        caller to rebuild (returns (state, step, failed=True))."""
        try:
            return step_fn(state), step + 1, False
        except Exception as exc:  # noqa: BLE001 — any device/runtime error
            self.restarts += 1
            if self.on_failure is not None:
                self.on_failure(exc, self.restarts)
            if self.restarts > self.max_restarts:
                raise
            step, state = self.restore_fn()
            return state, step, True


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/timeout/backoff policy for one slab execution.

    ``timeout_s`` is *post-hoc*: work enqueued on the card cannot be
    aborted portably, so an attempt that completes but overruns the deadline is
    counted as a timeout (and feeds the straggler monitor) rather than
    cancelled mid-flight.
    """

    max_retries: int = 2
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    timeout_s: float = 120.0

    def backoff(self, attempt: int) -> float:
        return self.backoff_s * self.backoff_factor ** attempt


@dataclasses.dataclass
class ServingFaultSupervisor:
    """Request-level fault policy for the GP serving layer (DESIGN.md §15).

    Transient slab errors are retried in place with exponential backoff;
    :class:`DeviceLossError` is never retried in place — it propagates to
    the server's detect → remesh → rewarm → replay path. Every attempt's
    wall time feeds the :class:`StragglerMonitor`, so serving step times
    drive the same straggler detection as training steps.
    """

    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    monitor: StragglerMonitor = dataclasses.field(
        default_factory=StragglerMonitor)
    device_losses: int = 0
    transient_retries: int = 0
    timeouts: int = 0

    def execute(self, attempt_fn: Callable[[], "object"]):
        """Run one slab attempt to completion, retrying transient errors."""
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                out = attempt_fn()
            except DeviceLossError:
                self.device_losses += 1
                raise
            except Exception:  # noqa: BLE001 — runtime/collective errors
                if attempt >= self.retry.max_retries:
                    raise
                self.transient_retries += 1
                time.sleep(self.retry.backoff(attempt))
                attempt += 1
                continue
            dt = time.perf_counter() - t0
            if dt > self.retry.timeout_s:
                self.timeouts += 1
            self.monitor.observe(dt)
            return out

    def metrics(self) -> dict:
        return {
            "device_losses": self.device_losses,
            "transient_retries": self.transient_retries,
            "timeouts": self.timeouts,
            "stragglers": self.monitor.stragglers,
            "median_step_s": self.monitor.median,
        }
