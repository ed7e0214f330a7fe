"""Batched, guarded preconditioned conjugate gradients.

The counterpart of the JAX package's ``solvers/pcg.py``. One batched
solve runs every right-hand side of ``A x = b`` (RHS-leading layout
``b: (k, n)``) through one masked iteration after another; the matvec is
``ICR`` on the kernel route, so the RHS batch rides inside the kernels as
a sample batch does. The contract is the JAX package's:

  * **per-RHS masking**: every column carries its own status; converged
    columns freeze (``alpha = beta = 0``: their iterate is bit-identical
    from then on), and NaN/Inf or diverging columns are *quarantined*:
    their iterate is zeroed the moment the status flips, so a poisoned
    column never re-enters the batched matvec;
  * **monitors**: residual tolerance (rtol·‖b‖ ∨ atol), divergence
    (‖r‖ > divergence_factor·‖b‖), stagnation (no relative improvement
    for ``stall_window`` iterations) and curvature/breakdown guards
    (pᵀAp ≤ 0, rᵀz ≤ 0);
  * **fallback ladder** (:func:`solve_guarded`): failed columns are
    re-solved down a rung sequence (ICR-whitened preconditioner →
    unpreconditioned → dense direct solve for small systems), each step
    a :class:`~.reports.FallbackEvent`;
  * **checkpoint/resume** (:func:`pcg_solve`): the carry is saved through
    ``checkpoint.CheckpointManager`` every ``checkpoint_every``
    iterations; a ``DeviceLossError`` raised by ``fault_hook`` calls the
    caller's ``on_device_loss``, restores the latest checkpoint and
    continues.

**Where the loop runs, and what the host waits on.** The JAX package runs
the loop on the device (``lax.while_loop``). Here the carry lives in
static buffers on ``b``'s device, and a segment of ``segment`` masked
iterations is one replay of a captured CUDA graph that writes the new
carry back into them (``_Iterations``; a remainder shorter than a
segment replays a one-iteration graph, so no iteration past the limit
runs). The graphs are cached per (matvec, preconditioner, config, RHS
width) in the caller's ``segment_graphs`` dict (``ConditionSystem.graphs``:
the ladder's rungs and repeated requests re-use them), or per solve. CPU
tensors run the same iterations eagerly, and so does the card inside
``core.graphs.eager()`` (to compare). The host waits on the device only to
read two numbers, the iteration count and whether any column is still
active (``_poll``: one copy of two integers), once every segment, and at
the end of each checkpoint segment, where the carry is copied to the host
and saved. An iteration in which no column is active changes nothing
(every column is frozen, and the count ``it`` only advances when some
column is active), so a segment may run past convergence and the result
is the same for any ``segment``: ``segment=1`` is the JAX package's
loop, iteration for iteration. For the same reason a replayed segment
equals the same iterations run eagerly, bit for bit, wherever the matvec
itself is deterministic (the off-grid interpolation's ``index_add_``
adds colliding indices in an order the card does not fix).

**Convergence is checked against the true residual.** The JAX package
calls a column ``converged`` when its *recursive* residual meets the
tolerance. In float32 that residual drifts from the true ``b − A x`` on
ill-conditioned systems (the unpreconditioned rung of the 1M-point
regular chart at 314,572 observations and σ = 0.05 reported 7e-7 where
the true residual was 6e-2, ``PERF.md``, conditioning). Here, when no
column is active, :func:`_settle` computes ``b − A x`` for the whole
batch and estimates the rounding of ``A x`` itself (three matvecs). A
column stays ``converged`` only if the two together are within ten times
the tolerance; otherwise it restarts from its iterate with the true
residual, while each restart at least halves it, and a column that
stops improving, or whose matvec is rounded above that bar, sits at its
working-precision floor and ends ``stalled`` (retryable: the ladder
moves on). ``relres`` reports the true residual of every column that is
not quarantined. A tolerance under that floor can never be met: with
``CGConfig.floor_cap`` the bar rises to each column's own rounding
(capped), so CG runs down to the floor and ends there ``converged``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.fault import DeviceLossError

from .reports import (ACTIVE, BREAKDOWN, CONVERGED, DENSE, DIVERGED,
                      MAXITER, NONFINITE, QUARANTINED, RETRYABLE, STALLED,
                      STATUS_NAMES, FallbackEvent, ResumeEvent, SolveReport)

_TINY = 1e-30  # rel-residual denominators only — never inside an update
SEGMENT = 4    # iterations between two reads of the statuses on the host
# _settle: a converged column's true residual plus the matvec's rounding at
# its iterate may reach _TRUE_SLACK times the tolerance (the bar the
# residual recomputed at float64 is held to); a restart must halve the
# true residual to earn another
_TRUE_SLACK = 10.0
_RESTART_GAIN = 0.5


@dataclasses.dataclass(frozen=True)
class CGConfig:
    """Solver policy knobs: the JAX package's, field for field, and the
    port's ``floor_cap``. At 0 a column converges at ``rtol`` as in the
    JAX package. Above 0, ``_settle`` raises a column's tolerance to the
    rounding of the float32 matvec at the column's own iterate, at most
    ``floor_cap``·‖b‖: a column CG has brought to its working-precision
    floor (stalled there, or converged on its recursive residual) ends
    ``converged`` when its true residual is within that bar, and an
    iterate far from the solution (x = 0 has no rounding at all) never
    is."""

    rtol: float = 1e-6
    atol: float = 0.0
    max_iters: int = 1000
    divergence_factor: float = 1e4   # ‖r‖ > factor·‖b‖ ⇒ quarantine
    stall_window: int = 30           # iters without improvement ⇒ stalled
    stall_drop: float = 1e-3         # "improvement" = best shrinks by this
    checkpoint_every: int = 0        # iters between carry checkpoints (0: off)
    dense_max: int = 4096            # largest n the dense rung will factor
    floor_cap: float = 0.0           # tolerance up to the matvec's rounding


# -- the masked iteration ----------------------------------------------------------
def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=1)


def _pcg_init(matvec, b: torch.Tensor, precond, cfg: CGConfig,
              x0: Optional[torch.Tensor] = None) -> dict:
    """Build the CG carry. Non-finite RHS columns are quarantined here
    (status NONFINITE, everything zeroed) so not even the first matvec
    sees them; trivially-zero columns converge at iteration 0."""
    finite = torch.isfinite(b).all(dim=1)
    b0 = torch.where(finite[:, None], b, 0.0)
    if x0 is None:
        x = torch.zeros_like(b0)
        r = b0
    else:
        x = torch.where(finite[:, None], x0.to(b0.dtype), 0.0)
        r = b0 - matvec(x)
    bnorm = torch.sqrt(_rowdot(b0, b0))
    tol = torch.clamp_min(cfg.rtol * bnorm, cfg.atol)
    rnorm = torch.sqrt(_rowdot(r, r))
    status = torch.where(~finite, NONFINITE,
                         torch.where(rnorm <= tol, CONVERGED, ACTIVE))
    status = status.to(torch.int32)
    z = precond(r) if precond is not None else r
    rz = _rowdot(r, z)
    active = status == ACTIVE
    # a preconditioner that returns NaN or a non-SPD direction is caught
    # before the first step, not after it has poisoned the iterate
    status = torch.where(active & ~torch.isfinite(rz), NONFINITE, status)
    status = torch.where((status == ACTIVE) & (rz <= 0), BREAKDOWN, status)
    status = status.to(torch.int32)
    quar = (status == NONFINITE)[:, None]
    x = torch.where(quar, 0.0, x)
    r = torch.where(quar, 0.0, r)
    p = torch.where((status == ACTIVE)[:, None], z, 0.0)
    k = b.shape[0]
    zeros = torch.zeros(k, dtype=torch.int32, device=b.device)
    return {
        "x": x, "r": r, "p": p, "rz": rz,
        "bnorm": bnorm, "tol": tol, "rnorm": rnorm,
        "best": rnorm, "since": zeros, "status": status, "iters": zeros,
        "it": torch.zeros((), dtype=torch.int64, device=b.device),
        # the right-hand side, the true residual at the last restart and
        # the matvec's rounding at the iterate, for _settle
        "b": b0, "true": torch.full_like(bnorm, torch.inf),
        "floor": torch.zeros_like(bnorm),
    }


def _pcg_body(matvec, precond, cfg: CGConfig) -> Callable[[dict], dict]:
    """One masked PCG iteration over the whole RHS batch, as a function
    of the carry (the input carry is not modified).

    Frozen columns take exact zero steps (``alpha = beta = 0`` with
    finite directions), so their iterate is bit-identical to a run where
    they were solved alone: the isolation contract the solver tests pin.
    """

    def body(c: dict) -> dict:
        status0 = c["status"]
        active = status0 == ACTIVE
        ap = matvec(c["p"])
        pap = _rowdot(c["p"], ap)
        curv_ok = (pap > 0) & torch.isfinite(pap)
        breakdown = active & ~curv_ok
        step = active & curv_ok
        alpha = torch.where(
            step, c["rz"] / torch.where(pap == 0, 1.0, pap), 0.0)
        x = c["x"] + alpha[:, None] * c["p"]
        r = c["r"] - alpha[:, None] * ap
        rnorm = torch.sqrt(_rowdot(r, r))
        z = precond(r) if precond is not None else r
        rz_new = _rowdot(r, z)

        nonfin = step & (~torch.isfinite(rnorm) | ~torch.isfinite(rz_new))
        conv = step & ~nonfin & (rnorm <= c["tol"])
        div = step & ~nonfin & ~conv & (
            rnorm > cfg.divergence_factor * torch.clamp_min(c["bnorm"],
                                                            _TINY))
        improved = rnorm < c["best"] * (1.0 - cfg.stall_drop)
        best = torch.where(step & ~nonfin & improved, rnorm, c["best"])
        since = torch.where(
            step, torch.where(improved & ~nonfin, 0, c["since"] + 1),
            c["since"]).to(torch.int32)
        stall = step & ~nonfin & ~conv & ~div & (since >= cfg.stall_window)
        pz_bad = step & ~nonfin & ~conv & ~div & ~stall & (rz_new <= 0)

        status = status0
        for mask, code in ((breakdown, BREAKDOWN), (nonfin, NONFINITE),
                           (conv, CONVERGED), (div, DIVERGED),
                           (stall, STALLED), (pz_bad, BREAKDOWN)):
            status = torch.where(mask & (status == ACTIVE), code, status)
        status = status.to(torch.int32)

        still = status == ACTIVE
        beta = torch.where(
            still, rz_new / torch.where(c["rz"] == 0, 1.0, c["rz"]), 0.0)
        p = torch.where(still[:, None], z + beta[:, None] * c["p"], c["p"])
        # quarantine: a poisoned or runaway column is zeroed *now* —
        # 0·NaN = NaN, so masking alone would let it leak back through the
        # batched matvec on the next iteration
        quar = (nonfin | div)[:, None]
        x = torch.where(quar, 0.0, x)
        r = torch.where(quar, 0.0, r)
        p = torch.where(quar, 0.0, p)
        return {
            "x": x, "r": r, "p": p,
            "rz": torch.where(still, rz_new, c["rz"]),
            "bnorm": c["bnorm"], "tol": c["tol"], "b": c["b"],
            "true": c["true"], "floor": c["floor"],
            "rnorm": torch.where(step, rnorm, c["rnorm"]),
            "best": best, "since": since, "status": status,
            "iters": torch.where(active, c["iters"] + 1,
                                 c["iters"]).to(torch.int32),
            # counts iterations in which some column stepped, so an
            # iteration past convergence leaves the count as it is
            "it": c["it"] + active.any(),
        }

    return body


def _poll(c: dict) -> Tuple[int, bool]:
    """(it, any column active): the host's one wait on the device."""
    it, live = torch.stack(
        [c["it"], (c["status"] == ACTIVE).any().to(torch.int64)]).tolist()
    return int(it), bool(live)


def _advance(body, static: dict, n: int) -> Callable[[], None]:
    """n masked iterations on the carry `static`, written back into it."""

    def run():
        c = static
        for _ in range(n):
            c = body(c)
        for key, buf in static.items():
            buf.copy_(c[key])

    return run


# captured segments a cache (``segment_graphs``) keeps: each holds its
# static carry and a graph of up to two lengths with its memory pool
_SEGMENT_ENTRIES = 8


class _Iterations:
    """The masked iterations of one (matvec, preconditioner, config, RHS
    width) over a static carry: ``segment`` of them one replay of a
    captured CUDA graph, a shorter remainder replays of a one-iteration
    graph (see the module docstring). A CPU carry, or ``graphs.eager()``,
    runs the same iterations op by op."""

    def __init__(self, body, carry: dict):
        self.body = body
        self.static = {k: v.detach().clone() for k, v in carry.items()}
        self.device = carry["x"].device
        self.replays: dict = {}

    def load(self, carry: dict) -> dict:
        """Copy `carry` into the static buffers (a key that is already the
        buffer copies nothing) and return them."""
        for key, buf in self.static.items():
            if carry[key] is not buf:
                buf.copy_(carry[key])
        return self.static

    def advance(self, n: int) -> None:
        from repro_torch.core import graphs

        if self.device.type != "cuda" or graphs.eager_mode():
            _advance(self.body, self.static, n)()
            return
        replay = self.replays.get(n)
        if replay is None:
            replay = self.replays[n] = graphs.capture(
                _advance(self.body, self.static, n), device=self.device)
            if replay.graph is not None:
                return  # the capture's warm-up ran these n iterations
        replay()


def _iterations(matvec, precond, cfg: CGConfig, carry: dict,
                cache: dict) -> _Iterations:
    """The ``_Iterations`` of this operator and width in `cache`, least
    recently used first out."""
    from repro_torch.core import graphs

    x = carry["x"]
    key = (matvec, precond, cfg, tuple(x.shape), x.dtype, str(x.device))
    return graphs.lru(
        cache, key,
        lambda: _Iterations(_pcg_body(matvec, precond, cfg), carry),
        _SEGMENT_ENTRIES)


def _run(runner: _Iterations, carry: dict, limit: int,
         segment: int) -> tuple:
    """Iterate until no column is active or ``it`` reaches `limit`,
    reading the statuses every `segment` iterations. Returns
    ``(carry, (it, any active))``, the carry being the runner's static
    buffers."""
    carry = runner.load(carry)
    while True:
        state = _poll(carry)
        it, live = state
        if not live or it >= limit:
            return carry, state
        n = min(int(segment), limit - it)
        if n == segment:
            runner.advance(n)
        else:
            for _ in range(n):
                runner.advance(1)


def matvec_rounding(matvec, x: torch.Tensor,
                    ax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per row, how far a computed ``A x`` lies from the exact one:
    ``‖A(x + e) − A(e) − A(x)‖``, ``e`` a seeded vector of ``x``'s norm
    (A is linear, so what is left is the three applications' rounding).
    `ax` is ``A x`` where the caller has it."""
    ax = matvec(x) if ax is None else ax
    gen = torch.Generator(device=x.device).manual_seed(0)
    e = torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
    e = e * (torch.sqrt(_rowdot(x, x) / _rowdot(e, e)))[:, None]
    noise = matvec(x + e) - matvec(e) - ax
    return torch.sqrt(_rowdot(noise, noise))


def _settle(matvec, precond, c: dict, restart: bool,
            cap: float = 0.0) -> tuple:
    """Hold every finished column to its true residual ``t = ‖b − A x‖``.

    ``A x`` is itself rounded: ``f`` (``matvec_rounding``) estimates how
    far a computed ``A x`` lies from the exact one. A ``converged`` column
    stays so if ``t + f <= _TRUE_SLACK · tol``. With a `cap`
    (``CGConfig.floor_cap``) ``tol`` rises to ``min(f, cap·‖b‖)``, and a
    ``stalled`` column within that bar is ``converged`` too. Otherwise a
    converged column restarts from its
    iterate (r = b − A x, p = M⁻¹r) if iterations are left (`restart`),
    ``t`` is above ``f`` and the restart is its first or its last one
    halved ``t``; if not, it ends ``stalled`` at its floor, or
    ``breakdown`` where M⁻¹r is not a descent direction. Columns that are
    not quarantined report ``t``, and the carry keeps ``f`` (``floor``).
    Three matvecs of the batch; returns ``(carry, whether any column
    restarted)``."""
    status, x = c["status"], c["x"]
    ax = matvec(x)
    floor = matvec_rounding(matvec, x, ax)
    r = c["b"] - ax
    tn = torch.sqrt(_rowdot(r, r))
    tol = c["tol"]
    if cap > 0:
        tol = torch.maximum(tol, torch.minimum(floor, cap * c["bnorm"]))
    held = tn + floor <= _TRUE_SLACK * tol
    if cap > 0:
        status = torch.where((status == STALLED) & held, CONVERGED, status)
    short = (status == CONVERGED) & ~held
    again = (short & (tn > floor) & (tn < _RESTART_GAIN * c["true"])
             & restart)
    z = precond(r) if precond is not None else r
    rz = _rowdot(r, z)
    go = again & torch.isfinite(rz) & (rz > 0)
    status = torch.where(short & ~again, STALLED, status)
    status = torch.where(again & ~go, BREAKDOWN, status)
    status = torch.where(go, ACTIVE, status).to(torch.int32)
    live = (status != NONFINITE) & (status != DIVERGED)
    m = go[:, None]
    c = dict(c)
    c.update(
        r=torch.where(m, r, c["r"]), p=torch.where(m, z, c["p"]),
        rz=torch.where(go, rz, c["rz"]),
        rnorm=torch.where(live, tn, c["rnorm"]),
        best=torch.where(go, tn, c["best"]),
        since=torch.where(go, 0, c["since"]).to(torch.int32),
        true=torch.where(again, tn, c["true"]), floor=floor,
        status=status)
    return c, bool(go.any())


def _finalize(c: dict) -> dict:
    """The carry's final state, copied out of any static buffers."""
    c = {k: v.clone() for k, v in c.items()}
    c["status"] = torch.where(c["status"] == ACTIVE, MAXITER,
                              c["status"]).to(torch.int32)
    return c


def _stats(c: dict) -> dict:
    status = c["status"]
    relres = c["rnorm"] / torch.clamp_min(c["bnorm"], _TINY)
    quarantined = (status == NONFINITE) | (status == DIVERGED)
    relres = torch.where(quarantined, torch.inf, relres)
    return {"status": status, "iters": c["iters"], "relres": relres,
            "it": c["it"],
            "delta": c["floor"] / torch.clamp_min(c["bnorm"], _TINY)}


def pcg_iterate(matvec: Callable[[torch.Tensor], torch.Tensor],
                b: torch.Tensor, *,
                precond: Optional[Callable] = None,
                cfg: CGConfig = CGConfig(),
                x0: Optional[torch.Tensor] = None,
                carry: Optional[dict] = None,
                finalize: bool = True,
                segment: int = SEGMENT,
                segment_graphs=None) -> tuple:
    """The solve: init (unless ``carry`` resumes one), then iterations
    until no column is active or ``cfg.max_iters``. Returns
    ``(x, stats, carry)``, ``stats`` holding per-RHS ``status``/``iters``/
    ``relres`` tensors and the iteration count ``it``, all on ``b``'s
    device. ``segment_graphs`` caches the captured segments (a dict, or
    None for this solve alone; see the module docstring).

    This is what ``KissGP.solve`` and other direct callers use; the
    checkpoint and fallback loops below wrap it with host-side control.
    """
    if carry is None:
        carry = _pcg_init(matvec, b, precond, cfg, x0=x0)
    graphs = {} if segment_graphs is None else segment_graphs
    again = True
    while again:
        runner = _iterations(matvec, precond, cfg, carry, graphs)
        carry, (it, _) = _run(runner, carry, cfg.max_iters, segment)
        carry, again = _settle(matvec, precond, carry, it < cfg.max_iters,
                               cfg.floor_cap)
    carry = (_finalize(carry) if finalize
             else {k: v.clone() for k, v in carry.items()})
    return carry["x"], _stats(carry), carry


# -- carry plumbing (checkpoint/re-pad) ------------------------------------------
_SCALAR_KEYS = ("it",)


def _repad_carry(carry: dict, k_new: int, cfg: CGConfig) -> dict:
    """Resize the RHS axis to ``k_new``. Added columns are zero-RHS
    padding: status CONVERGED, everything zero; they take no steps and
    cost nothing but their share of the batched matvec."""
    k = int(carry["status"].shape[0])
    if k_new == k:
        return carry
    out = {}
    for key, val in carry.items():
        if key in _SCALAR_KEYS:
            out[key] = val
        elif k_new < k:
            out[key] = val[:k_new]
        else:
            pad = torch.zeros((k_new - k,) + tuple(val.shape[1:]),
                              dtype=val.dtype, device=val.device)
            if key == "status":
                pad.fill_(CONVERGED)
            out[key] = torch.cat([val, pad], dim=0)
    return out


def _to(carry: dict, device) -> dict:
    return {k: v.detach().to(device, copy=True) for k, v in carry.items()}


def pcg_solve(matvec, b: torch.Tensor, *,
              precond: Optional[Callable] = None,
              cfg: CGConfig = CGConfig(),
              x0: Optional[torch.Tensor] = None,
              manager=None,
              checkpoint_every: Optional[int] = None,
              fault_hook: Optional[Callable[[int], None]] = None,
              on_device_loss: Optional[Callable] = None,
              executor: Optional[Callable] = None,
              segment: int = SEGMENT,
              segment_graphs=None) -> tuple:
    """Host loop: :func:`pcg_iterate` in checkpoint segments, with
    resume.

    The solve runs in segments of ``checkpoint_every`` iterations; between
    segments the carry is saved through ``manager`` (a
    ``checkpoint.CheckpointManager``). A ``DeviceLossError`` raised by
    ``fault_hook(it)`` (called once per segment attempt) invokes
    ``on_device_loss(exc)``, which returns ``(matvec, precond, k_pad)``
    (``None`` keeps the matvec and the width); the carry is restored from
    the latest checkpoint (or the initial state), re-padded, and the solve
    continues. Without ``on_device_loss`` the error propagates.
    ``executor`` wraps each segment attempt (the server passes
    ``ServingFaultSupervisor.execute`` for transient retries and
    straggler accounting).

    ``segment_graphs`` is :func:`pcg_iterate`'s.

    Returns ``(x, stats, resumes, n_checkpoints)``.
    """
    executor = executor or (lambda fn: fn())
    seg = cfg.checkpoint_every if checkpoint_every is None \
        else checkpoint_every
    device = b.device
    graphs = {} if segment_graphs is None else segment_graphs
    carry = _pcg_init(matvec, b, precond, cfg, x0=x0)
    k_cur = int(b.shape[0])
    resumes: list = []
    n_ckpt = 0
    # host copy of the latest durable state: the restore target after a
    # loss, and the restart point when no checkpoint exists yet
    host = _to(carry, "cpu")
    if manager is not None and seg:
        manager.save(0, carry, blocking=True)
        n_ckpt += 1
    state = _poll(carry)
    again = True
    while again:
        while state[1] and state[0] < cfg.max_iters:
            it = state[0]
            limit = cfg.max_iters if not seg else min(it + seg, cfg.max_iters)

            def attempt(carry=carry, it=it, limit=limit, matvec=matvec,
                        precond=precond):
                if fault_hook is not None:
                    fault_hook(it)
                runner = _iterations(matvec, precond, cfg, carry, graphs)
                return _run(runner, carry, limit, segment)

            try:
                carry, state = executor(attempt)
            except DeviceLossError as exc:
                if on_device_loss is None:
                    raise
                new_mv, new_pc, k_pad = on_device_loss(exc)
                matvec = new_mv if new_mv is not None else matvec
                precond = new_pc
                if manager is not None and manager.latest_step() is not None:
                    step, carry = manager.restore(like=host, device=device)
                else:
                    step, carry = 0, _to(host, device)
                resumes.append(ResumeEvent(
                    at_iter=it, restored_step=int(step),
                    reason=f"device-loss {sorted(exc.device_ids)}"))
                if k_pad is not None:
                    k_cur = int(k_pad)
                carry = _repad_carry(carry, k_cur, cfg)
                state = _poll(carry)
                continue
            if manager is not None and seg:
                manager.save(state[0], carry, blocking=True)
                n_ckpt += 1
                host = _to(carry, "cpu")
        carry, again = _settle(matvec, precond, carry,
                               state[0] < cfg.max_iters, cfg.floor_cap)
        state = _poll(carry)
    carry = _finalize(carry)
    return carry["x"], _stats(carry), resumes, n_ckpt


# -- the fallback ladder ---------------------------------------------------------
def jacobi_precond(diag: torch.Tensor) -> Callable:
    """Diagonal (Jacobi) preconditioner ``z = r / diag``: the middle rung
    when a structured preconditioner misbehaves but scaling still helps.
    ``diag`` must be strictly positive."""
    inv = 1.0 / diag

    def precond(r: torch.Tensor) -> torch.Tensor:
        return r * inv[None, :]

    return precond


def solve_guarded(matvec, b: torch.Tensor, *,
                  preconds: Sequence[tuple] = (("none", None),),
                  cfg: CGConfig = CGConfig(),
                  dense_solve: Optional[Callable] = None,
                  manager=None,
                  checkpoint_every: Optional[int] = None,
                  fault_hook: Optional[Callable] = None,
                  on_device_loss: Optional[Callable] = None,
                  executor: Optional[Callable] = None,
                  n_report: Optional[int] = None,
                  tag: str = "pcg",
                  segment: int = SEGMENT,
                  segment_graphs=None) -> tuple:
    """Run the fallback ladder over a batched solve; returns
    ``(x, SolveReport)``, ``x`` on ``b``'s device.

    ``preconds`` is the rung sequence, ``(name, precond_fn_or_None)``
    best-first (e.g. ICR-whitened → unpreconditioned). Columns that end a
    rung with a retryable status (diverged, breakdown, stalled, maxiter)
    are re-solved on the next rung; the other columns ride along as
    zero-RHS padding (shapes never change between rungs), and their
    already-good results are kept. Columns still failing after the last
    rung go to ``dense_solve`` when the system is small enough
    (``cfg.dense_max``). Every transition emits a
    :class:`~.reports.FallbackEvent`; ``n_report`` trims the report to
    the first n columns (the server's real, unpadded RHS count).

    ``on_device_loss(exc)`` may return its new preconditioner as a
    **dict** ``{rung_name: precond}``: the ladder is updated in place, so
    a loss on one rung re-plans every later rung too, and the returned
    ``k_pad`` (which must stay >= the original width) widens all later
    rungs and the dense residual check.

    ``segment_graphs`` caches the rungs' captured segments (a dict, such
    as ``ConditionSystem.graphs``; None: for this solve alone). The
    report records ``cfg.rtol``, ``cfg.floor_cap`` and δ,
    the largest column's matvec rounding at its last CG iterate relative
    to its right-hand side.
    """
    graphs = {} if segment_graphs is None else segment_graphs
    t0 = time.perf_counter()
    k, n = b.shape
    device = b.device
    finite = torch.isfinite(b).all(dim=1).cpu().numpy()
    x_full = torch.zeros_like(b)
    status_full = np.full(k, NONFINITE, np.int32)
    status_full[finite] = ACTIVE
    iters_full = np.zeros(k, np.int64)
    relres_full = np.full(k, np.inf)
    relres_full[finite] = 0.0
    delta_full = np.full(k, np.nan)

    rung_names = [name for name, _ in preconds]
    remaining = np.where(finite)[0]
    fallbacks: list = []
    resumes: list = []
    n_ckpt = 0
    total_it = 0
    rungs_tried: list = []

    # live operator state: a device loss mid-rung re-plans the matvec,
    # the preconditioners and the padded width, and *later* rungs (and
    # the dense residual check) must see the re-planned versions
    cur = {"mv": matvec, "pcs": dict(preconds), "k": k}

    def _wrap_odl(rung):
        if on_device_loss is None:
            return None

        def odl(exc):
            new_mv, new_pc, k_pad = on_device_loss(exc)
            if new_mv is not None:
                cur["mv"] = new_mv
            if isinstance(new_pc, dict):
                cur["pcs"].update(new_pc)
                new_pc = cur["pcs"].get(rung)
            else:
                cur["pcs"][rung] = new_pc
            if k_pad is not None:
                cur["k"] = int(k_pad)
            return cur["mv"], new_pc, cur["k"]

        return odl

    def _pad_rows(arr):
        if cur["k"] == arr.shape[0]:
            return arr
        pad = torch.zeros((cur["k"] - arr.shape[0],) + tuple(arr.shape[1:]),
                          dtype=arr.dtype, device=arr.device)
        return torch.cat([arr, pad], dim=0)

    def _on_device(mask):
        return torch.as_tensor(mask, device=device)[:, None]

    for ri, (name, _) in enumerate(list(preconds)):
        if remaining.size == 0:
            break
        rungs_tried.append(name)
        mask = np.zeros(k, bool)
        mask[remaining] = True
        b_r = _pad_rows(torch.where(_on_device(mask), b, 0.0))
        # a fresh checkpoint namespace per rung: a later rung's restore
        # must never resurrect an earlier rung's (stale) carry
        mgr = manager if manager is None else type(manager)(
            os.path.join(manager.root, f"rung{ri}-{name}"),
            keep=manager.keep)
        x_r, stats, res, ck = pcg_solve(
            cur["mv"], b_r, precond=cur["pcs"].get(name), cfg=cfg,
            manager=mgr, checkpoint_every=checkpoint_every,
            fault_hook=fault_hook, on_device_loss=_wrap_odl(name),
            executor=executor, segment=segment, segment_graphs=graphs)
        resumes.extend(res)
        n_ckpt += ck
        st = stats["status"][:k].cpu().numpy()
        it = stats["iters"][:k].cpu().numpy()
        rr = stats["relres"][:k].double().cpu().numpy()
        dl = stats["delta"][:k].double().cpu().numpy()
        x_full = torch.where(_on_device(mask), x_r[:k], x_full)
        status_full[mask] = st[mask]
        iters_full[mask] += it[mask]
        relres_full[mask] = rr[mask]
        delta_full[mask] = dl[mask]
        total_it += int(stats["it"])
        retry = np.array([i for i in remaining if st[i] in RETRYABLE],
                         np.int64)
        if retry.size and ri + 1 < len(preconds):
            reasons: dict = {}
            for i in retry:
                nm = STATUS_NAMES[int(st[i])]
                reasons[nm] = reasons.get(nm, 0) + 1
            fallbacks.append(FallbackEvent(
                rung_from=name, rung_to=rung_names[ri + 1],
                at_iter=total_it, cols=tuple(int(i) for i in retry),
                reasons=tuple(sorted(reasons.items()))))
        remaining = retry

    if remaining.size and dense_solve is not None and n <= cfg.dense_max:
        rungs_tried.append("dense")
        reasons = {}
        for i in remaining:
            nm = STATUS_NAMES[int(status_full[i])]
            reasons[nm] = reasons.get(nm, 0) + 1
        fallbacks.append(FallbackEvent(
            rung_from=rungs_tried[-2] if len(rungs_tried) > 1 else "none",
            rung_to="dense", at_iter=total_it,
            cols=tuple(int(i) for i in remaining),
            reasons=tuple(sorted(reasons.items()))))
        mask = np.zeros(k, bool)
        mask[remaining] = True
        b_d = torch.where(_on_device(mask), b, 0.0)
        x_d = dense_solve(b_d)[:k]
        r_d = (_pad_rows(b_d) - cur["mv"](_pad_rows(x_d)))[:k]
        rr_d = (torch.linalg.vector_norm(r_d, dim=1).double()
                / torch.linalg.vector_norm(b_d, dim=1).double()
                .clamp_min(_TINY)).cpu().numpy()
        good = mask & torch.isfinite(x_d).all(dim=1).cpu().numpy()
        x_full = torch.where(_on_device(good), x_d, x_full)
        status_full[good] = DENSE
        relres_full[good] = rr_d[good]
        bad = mask & ~good
        status_full[bad] = NONFINITE
        x_full = torch.where(_on_device(bad), 0.0, x_full)

    m = k if n_report is None else int(n_report)
    quarantined = tuple(int(i) for i in range(m)
                        if status_full[i] in QUARANTINED)
    report = SolveReport(
        tag=tag, n_rhs=m, n_unknowns=n,
        rungs=tuple(rungs_tried),
        status=tuple(STATUS_NAMES[int(s)] for s in status_full[:m]),
        iterations=tuple(int(i) for i in iters_full[:m]),
        relres=tuple(float(r) for r in relres_full[:m]),
        quarantined=quarantined,
        fallbacks=tuple(fallbacks),
        resumes=tuple(resumes),
        checkpoints=n_ckpt,
        wall_s=time.perf_counter() - t0,
        rtol=cfg.rtol, floor_cap=cfg.floor_cap,
        delta=(float(np.nanmax(delta_full[:m]))
               if np.isfinite(delta_full[:m]).any() else None),
    )
    return x_full, report
