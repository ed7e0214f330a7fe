"""Fault injection for the sharded GP server.

The counterpart of the JAX package's ``distributed/chaos.py`` (without
its ``--bench`` rows, which feed the JAX package's benchmarks). Faults
are injected at the slab-execution boundary through the server's
``fault_injector`` hook, where a real runtime raises, so the recovery
exercised here (detect → shrink → re-plan → replay) is the serving path
itself:

  * :class:`KillDevice`: raise a :class:`DeviceLossError` for one or more
    slots at a chosen slab attempt; the server must shrink the mesh,
    re-plan and replay the in-flight rows bit for bit.
  * :class:`Straggler`: sleep inside the attempt so the slab's wall time
    spikes; the serving-side ``StragglerMonitor`` must flag it.
  * :func:`poison_request`: a NaN-poisoned ξ request; admission must
    reject it before it can touch a slab.

The checks run on a virtual mesh of 8 slots on one device (``--device``,
the card by default; the tests pass ``cpu``):

  PYTHONPATH=src python -m repro_torch.distributed.chaos --check \
      [--check-solvers] [--device cpu]

``--check-solvers`` runs the solver suite: a slot lost mid-CG-solve
(checkpoint and resume on the shrunk mesh, no right-hand side dropped),
and one NaN column of a sharded batched solve quarantined while its
siblings stay bit for bit.

A slot runs a whole slab in samples mode (``launch.serve_gp``), so the
checks' samples-mode servers take ``slab=2``: 16 rows a step on 8 slots,
so that the streams span several slab attempts, as the JAX suite's 8-row
slabs do.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np

from .fault import DeviceLossError, ServingFaultSupervisor, StragglerMonitor

N_SLOTS = 8
SLAB = 2   # rows per slot in samples mode


@dataclasses.dataclass
class KillDevice:
    """Lose slot(s) at slab attempt ``at_slab`` (0-based attempt index);
    ``device_indices`` index the mesh's slots in flat order."""

    at_slab: int
    device_indices: tuple = (0,)


@dataclasses.dataclass
class Straggler:
    """Delay slab attempt ``at_slab`` by ``delay_s`` (a slow collective)."""

    at_slab: int
    delay_s: float = 0.25


class ChaosInjector:
    """``GPFieldServer.fault_injector`` hook: fires each fault once, at its
    slab-attempt index, then lets execution proceed."""

    def __init__(self, faults: List):
        self.pending = list(faults)
        self.fired: list = []
        self.attempts = 0
        self.fault_times: list = []  # perf_counter at each fired fault

    def __call__(self, server):
        idx = self.attempts
        self.attempts += 1
        due = [f for f in self.pending if f.at_slab <= idx]
        kill_ids: list = []
        for f in due:
            self.pending.remove(f)
            self.fired.append((idx, f))
            if isinstance(f, Straggler):
                time.sleep(f.delay_s)
            elif isinstance(f, KillDevice):
                ids = ([s.id for s in server.mesh.slots]
                       if server.mesh is not None else [])
                if ids:
                    kill_ids.extend(ids[i % len(ids)]
                                    for i in f.device_indices)
                else:
                    kill_ids.append(0)
        if kill_ids:
            self.fault_times.append(time.perf_counter())
            raise DeviceLossError(sorted(set(kill_ids)))


def poison_request(icr, kind: str = "moments", n: int = 3, seed: int = 0):
    """A request whose ξ override carries a NaN: admission must reject it
    (code ``xi-nonfinite``) before it shares a slab with healthy
    traffic."""
    from repro_torch.launch.serve_gp import GPRequest

    xi = [np.zeros(s, np.float32) for s in icr.xi_shapes()]
    xi[-1].flat[0] = np.nan
    return GPRequest(kind=kind, n=n, seed=seed, xi=xi)


# -- acceptance checks (a virtual mesh of 8 slots) ---------------------------------
def _full_mesh(device, axis: str = "data"):
    import torch

    from repro_torch.launch.mesh import make_mesh

    return make_mesh((N_SLOTS,), (axis,),
                     devices=[torch.device(device)] * N_SLOTS)


def _mk_server(mesh, device, *, slab: int = SLAB, shard: str = "samples",
               injector=None, supervisor=None, scenario: str = "tod"):
    from repro_torch.launch.serve_gp import (GPFieldServer, SCENARIOS,
                                             demo_posterior, scenario_chart)

    chart = scenario_chart(scenario, quick=True)
    post = demo_posterior(chart, SCENARIOS[scenario], device=device)
    return GPFieldServer(post, slab=slab, mesh=mesh, shard=shard,
                         supervisor=supervisor, fault_injector=injector)


def _requests():
    from repro_torch.launch.serve_gp import GPRequest

    return [GPRequest(kind="sample", n=5, seed=11),
            GPRequest(kind="moments", n=9, seed=12),
            GPRequest(kind="sample", n=3, seed=13)]


def _assert_equal_results(base, got, *, exact: bool = True,
                          tol: float = 0.0):
    for a, b in zip(base, got):
        assert a.done and b.done and b.error is None, (a, b.error)
        pairs = (list(zip(a.fields, b.fields)) if a.kind == "sample"
                 else [(a.mean, b.mean), (a.std, b.std)])
        for xa, xb in pairs:
            if exact:
                assert np.array_equal(np.asarray(xa), np.asarray(xb)), \
                    "results differ from the unfaulted run"
            else:
                np.testing.assert_allclose(xa, xb, rtol=tol, atol=tol)


def check_kill_midstream(device: str = "cuda") -> str:
    """Lose one slot of 8 mid-stream: no dropped request, a re-planned
    mesh of 7, results bit for bit the unfaulted run's (and the
    unsharded server's), and a deliberate cache miss."""
    base = _requests()
    _mk_server(_full_mesh(device), device).run(base)
    single = _requests()
    _mk_server(None, device).run(single)
    _assert_equal_results(single, base, exact=True)

    inj = ChaosInjector([KillDevice(at_slab=1, device_indices=(3,))])
    srv = _mk_server(_full_mesh(device), device, injector=inj)
    fp_before = srv.cache_key_fingerprint()["digest"]
    misses_before = srv.cache_misses
    got = _requests()
    srv.run(got)

    assert inj.fired, "fault never fired"
    assert all(r.done and r.error is None for r in got), "dropped requests"
    assert srv.mesh is not None, "mesh collapsed instead of shrinking"
    live = srv.mesh.size
    assert live == N_SLOTS - 1, f"expected mesh of {N_SLOTS - 1}, got {live}"
    assert srv.replans == 1 and srv.replayed_slabs >= 1, srv.metrics()
    # the re-mesh is a deliberate cache miss, never a stale hit
    assert srv.cache_misses == misses_before + 1, srv.metrics()
    assert srv.cache_key_fingerprint()["digest"] != fp_before
    assert srv.capacity == SLAB * live, srv.metrics()
    _assert_equal_results(base, got, exact=True)
    return (f"kill-midstream: mesh {N_SLOTS}->{live}, "
            f"{srv.replayed_slabs} slab(s) replayed bit-identically, "
            f"cache miss on re-mesh")


def check_collapse_to_single_device(device: str = "cuda") -> str:
    """Losing all but one slot drops to the single-device path and keeps
    serving, the collapse recorded as a degradation."""
    base = _requests()
    _mk_server(None, device).run(base)

    inj = ChaosInjector([KillDevice(
        at_slab=0, device_indices=tuple(range(N_SLOTS - 1)))])
    srv = _mk_server(_full_mesh(device), device, injector=inj)
    got = _requests()
    srv.run(got)

    assert all(r.done and r.error is None for r in got)
    assert srv.mesh is None and srv.serving_mode.startswith("single")
    assert any(d.applied == "unsharded" for d in srv.degradations), \
        srv.metrics()
    _assert_equal_results(base, got, exact=True)
    return (f"collapse: {N_SLOTS}->1 slot, degraded to "
            f"{srv.serving_mode!r}, results bit-identical to unsharded")


def check_straggler_detection(device: str = "cuda") -> str:
    """A delayed slab must be flagged by the serving-side StragglerMonitor
    fed from slab times. The delay is 0.5 s, or ten times the median slab
    of the first eight where that is longer (a CPU shared with other
    work can take most of a second a slab)."""
    from repro_torch.launch.serve_gp import GPRequest

    sup = ServingFaultSupervisor(monitor=StragglerMonitor(min_samples=6))
    inj = ChaosInjector([])
    srv = _mk_server(_full_mesh(device), device, injector=inj,
                     supervisor=sup)
    srv.run([GPRequest(kind="sample", n=8 * srv.capacity, seed=4)])
    inj.pending.append(Straggler(at_slab=10,
                                 delay_s=max(0.5, 10 * sup.monitor.median)))
    srv.run([GPRequest(kind="sample", n=4 * srv.capacity, seed=5)])
    assert inj.fired, "straggler never fired"
    assert sup.monitor.stragglers >= 1, sup.metrics()
    return (f"straggler: flagged {sup.monitor.stragglers} of "
            f"{srv.slabs_run} slabs (median {sup.monitor.median*1e3:.1f} ms)")


def check_chart_sharded_kill(device: str = "cuda") -> str:
    """Chart-sharded serving (the DistributedICR halo body) survives a
    slot loss: the ring shrinks to the largest feasible size and results
    match the unsharded server to fp tolerance."""
    base = _requests()
    _mk_server(None, device, slab=8).run(base)

    inj = ChaosInjector([KillDevice(at_slab=1, device_indices=(2,))])
    srv = _mk_server(_full_mesh(device, "space"), device, slab=8,
                     shard="chart", injector=inj)
    got = _requests()
    srv.run(got)

    assert all(r.done and r.error is None for r in got)
    assert srv.replans == 1, srv.metrics()
    _assert_equal_results(base, got, exact=False, tol=1e-5)
    ring = srv.mesh.size if srv.mesh is not None else 1
    return f"chart-kill: ring shrank to {ring}, results within 1e-5"


def check_poison_isolation(device: str = "cuda") -> str:
    """A NaN-ξ request packed beside healthy traffic is rejected at
    admission and the healthy results are untouched."""
    from repro_torch.launch.serve_gp import GPRequest

    srv = _mk_server(_full_mesh(device), device)
    clean = GPRequest(kind="moments", n=6, seed=2)
    _mk_server(_full_mesh(device), device).run([clean])

    bad = poison_request(srv.posterior.icr)
    good = GPRequest(kind="moments", n=6, seed=2)
    srv.run([bad, good])
    assert bad.error is not None and bad.error.code == "xi-nonfinite"
    assert srv.slabs_run == 1 and good.error is None
    assert np.array_equal(good.mean, clean.mean)
    assert np.isfinite(good.mean).all() and np.isfinite(good.std).all()
    return "poison: rejected at admission, healthy neighbor bit-identical"


CHECKS = [check_kill_midstream, check_collapse_to_single_device,
          check_straggler_detection, check_chart_sharded_kill,
          check_poison_isolation]


# -- solver chaos (kind="condition", the guarded batched CG) -------------------
def _condition_inputs(srv):
    icr = srv.posterior.icr
    n = int(np.prod(icr.chart.final_shape))
    obs_idx = np.arange(0, n, 4)
    rng = np.random.default_rng(3)
    y = (np.sin(np.linspace(0.0, 6.0, obs_idx.size))
         + 0.05 * rng.standard_normal(obs_idx.size))
    return y, obs_idx


def check_solver_kill_midsolve(device: str = "cuda") -> str:
    """Lose one of 8 slots mid-CG-solve: the solve checkpoints, re-plans
    onto the 7 survivors, resumes from the saved carry and finishes with
    no dropped right-hand side; the mean matches the unfaulted run's (fp
    tolerance: the columns' batches differ on 7 slots and 8)."""
    from repro_torch.launch.serve_gp import GPRequest

    base_srv = _mk_server(_full_mesh(device), device)
    base_srv.solver_checkpoint_every = 2
    y, obs_idx = _condition_inputs(base_srv)
    base = GPRequest(kind="condition", n=7, seed=21, y=y, obs_idx=obs_idx)
    base_srv.run([base])
    assert base.error is None and base.report.ok, base.report

    inj = ChaosInjector([KillDevice(at_slab=1, device_indices=(3,))])
    srv = _mk_server(_full_mesh(device), device, injector=inj)
    srv.solver_checkpoint_every = 2
    req = GPRequest(kind="condition", n=7, seed=21, y=y, obs_idx=obs_idx)
    srv.run([req])

    assert inj.fired, "fault never fired"
    assert req.error is None, req.error
    assert req.report.ok, f"dropped RHS: {req.report.summary()}"
    assert req.report.resumes, "no checkpoint resume recorded"
    assert srv.mesh is not None, "mesh collapsed instead of shrinking"
    live = srv.mesh.size
    assert live == N_SLOTS - 1, f"expected mesh of {N_SLOTS - 1}, got {live}"
    rel = (np.linalg.norm(req.mean - base.mean)
           / np.linalg.norm(base.mean))
    assert rel < 1e-5, f"resumed mean off by rel {rel:.2e}"
    np.testing.assert_allclose(req.std, base.std, atol=1e-4)
    ev = req.report.resumes[0]
    return (f"solver-kill: mesh {N_SLOTS}->{live} at iter {ev.at_iter}, "
            f"resumed from checkpoint step {ev.restored_step}, "
            f"{req.report.n_rhs} RHS all converged (mean rel {rel:.1e})")


def check_solver_divergence_isolation(device: str = "cuda") -> str:
    """NaN-poison one RHS column of a mesh-sharded batched solve: the
    column is quarantined (iterate zeroed, status nonfinite) and every
    sibling column is bit for bit the clean run's."""
    import torch

    from repro_torch.launch.serve_gp import (SCENARIOS, demo_posterior,
                                             scenario_chart)
    from repro_torch.solvers import (CGConfig, build_condition_system,
                                     obs_operator, pcg_solve)
    from repro_torch.solvers.pcg import NONFINITE

    mesh = _full_mesh(device)
    chart = scenario_chart("tod", quick=True)
    post = demo_posterior(chart, SCENARIOS["tod"], device=device)
    icr = post.icr
    n = int(np.prod(chart.final_shape))
    op = obs_operator(icr, obs_idx=np.arange(0, n, 4))
    system = build_condition_system(icr, op, 0.05 ** 2, mesh=mesh)
    k = N_SLOTS
    rng = np.random.default_rng(5)
    b = rng.standard_normal((k, op.n_obs)).astype(np.float32)
    cfg = CGConfig(rtol=1e-7, max_iters=200)

    def solve(rhs):
        with system.solve_context():
            return pcg_solve(system.matvec, torch.tensor(rhs, device=device),
                             precond=system.precond, cfg=cfg)

    x_clean, _, _, _ = solve(b)
    bad = b.copy()
    bad[3, 0] = np.nan
    x_bad, st_bad, _, _ = solve(bad)
    keep = [i for i in range(k) if i != 3]
    x_clean, x_bad = x_clean.cpu().numpy(), x_bad.cpu().numpy()
    assert np.array_equal(x_clean[keep], x_bad[keep]), \
        "sibling columns perturbed by the poisoned RHS"
    assert int(st_bad["status"][3]) == NONFINITE, st_bad
    assert np.all(x_bad[3] == 0.0), "quarantine not zeroed"
    return (f"solver-isolation: NaN column quarantined on mesh {k}, "
            f"{len(keep)} siblings bit-identical to the clean run")


SOLVER_CHECKS = [check_solver_kill_midsolve,
                 check_solver_divergence_isolation]


def run_checks(checks=None, label: str = "chaos",
               device: str = "cuda") -> int:
    """Run `checks` on `device`, printing ``PASS``/``FAIL`` per check;
    returns 1 if any failed."""
    checks = CHECKS if checks is None else checks
    print(f"{label} acceptance suite on {N_SLOTS} slots of {device}")
    failed = 0
    for check in checks:
        try:
            msg = check(device)
        except Exception as exc:  # noqa: BLE001 — report every check
            failed += 1
            print(f"FAIL {check.__name__}: {type(exc).__name__}: {exc}")
        else:
            print(f"PASS {msg}")
    return 1 if failed else 0


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--check", action="store_true",
                    help="run the chaos acceptance suite")
    ap.add_argument("--check-solvers", action="store_true",
                    help="run the solver chaos suite (mid-solve kill and "
                         "sharded divergence isolation)")
    ap.add_argument("--device", default="cuda",
                    help="the device of the 8 virtual slots")
    args = ap.parse_args()
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("chaos: no CUDA device (pass --device cpu)")
    rc = 0
    if args.check or not args.check_solvers:
        rc = run_checks(device=args.device)
    if args.check_solvers:
        rc = max(rc, run_checks(SOLVER_CHECKS, label="solver chaos",
                                device=args.device))
    raise SystemExit(rc)


if __name__ == "__main__":
    main()
