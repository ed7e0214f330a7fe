"""The port's guarded batched CG and conditioning system
(``repro_torch.solvers``, ``core.vi.cg_posterior``) held to the JAX
package's, on the CPU.

* Engine parity: ``pcg_iterate``/``solve_guarded`` on the reference
  tests' SPD system give the JAX package's iterations (±1) and solution
  (1e-5).
* Engine contract, the reference's engine tests as cases: a zero RHS, a
  NaN or a diverging column quarantined with its siblings bit-identical,
  breakdown, the ladder, maxiter to the dense rung, a device loss resumed
  from a checkpoint, and one result for any host-check segment length.
* Conditioning: ``condition_matvec`` and the ICR-whitened preconditioner
  on the JAX package's matrices (``CarriedICR``) at 1e-5; the
  ``cg_posterior`` mean field against the JAX package's and against the
  exact posterior on ``implicit_cov`` at rel <= 1e-5 (fields, not ξ̂,
  which depends on the square root's sign convention); the ICR rung's
  iterations; off-grid 1-D observations.
"""
import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ICR as JICR
from repro.core import charts as jcharts
from repro.core import kernels as jkernels
from repro.core.vi import cg_posterior as jcg_posterior
from repro.solvers import gp_system as jgp
from repro.solvers import pcg as jpcg
from repro_torch import ICR, cg_posterior, exact_posterior
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import matrices_to_torch
from repro_torch.core import charts as tcharts
from repro_torch.core import kernels as tkernels
from repro_torch.distributed.fault import DeviceLossError
from repro_torch.solvers import (CGConfig, build_condition_system,
                                 condition_matvec, icr_whitening_precond,
                                 obs_operator, pcg_iterate, pcg_solve,
                                 solve_guarded)
from repro_torch.solvers import gp_system as tgp
from repro_torch.solvers.reports import (BREAKDOWN, CONVERGED, DIVERGED,
                                         NONFINITE, STALLED)

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _spd_system(n=40, k=5, seed=0, cond=50.0, dtype=np.float32):
    """The reference tests' system, as numpy arrays of `dtype`."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.geomspace(1.0, cond, n)) @ q.T
    b = rng.standard_normal((k, n))
    return a.astype(dtype), b.astype(dtype), np.linalg.solve(a, b.T).T


def _mv(a):
    a = torch.as_tensor(a)
    return lambda v: v @ a.T


# -- engine parity -----------------------------------------------------------------
# (dtype, condition number, rtol): at float32 the two engines' matmuls
# sum in other orders, which moves CG's iteration count near the float32
# floor by a few; float64 (the JAX package under x64) shows the engines
# step for step
ENGINE_PARITY = {"f32": ("float32", 50.0, 1e-5),
                 "f64": ("float64", 500.0, 1e-10)}


@pytest.mark.parametrize("case", sorted(ENGINE_PARITY))
def test_pcg_iterate_matches_the_jax_engine(case):
    dtype, cond, rtol = ENGINE_PARITY[case]
    a, b, x_ref = _spd_system(cond=cond, dtype=dtype)
    cfg = dict(rtol=rtol, max_iters=300)
    with jax.enable_x64(dtype == "float64"):
        jx, jstats, _ = jpcg.pcg_iterate(lambda v: v @ jnp.asarray(a).T,
                                         jnp.asarray(b),
                                         cfg=jpcg.CGConfig(**cfg))
        jx, jiters = np.asarray(jx), np.asarray(jstats["iters"])
        jstatus = np.asarray(jstats["status"])
    assert jx.dtype == dtype
    x, stats, _ = pcg_iterate(_mv(a), torch.tensor(b), cfg=CGConfig(**cfg))
    assert stats["status"].tolist() == jstatus.tolist()
    assert np.all(np.abs(stats["iters"].numpy() - jiters) <= 1)
    np.testing.assert_allclose(x.numpy(), jx, atol=1e-5)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=2e-4, atol=1e-5)


def test_solve_guarded_matches_the_jax_ladder():
    a, b, _ = _spd_system(cond=1e4)
    cfg = dict(rtol=1e-7, max_iters=3)
    jx, jrep = jpcg.solve_guarded(
        lambda v: v @ jnp.asarray(a).T, jnp.asarray(b),
        preconds=[("bad", lambda r: -r), ("none", None)],
        cfg=jpcg.CGConfig(**cfg),
        dense_solve=lambda bb: jnp.linalg.solve(jnp.asarray(a),
                                                jnp.asarray(bb).T).T)
    ta = torch.tensor(a)
    x, rep = solve_guarded(
        _mv(a), torch.tensor(b),
        preconds=[("bad", lambda r: -r), ("none", None)],
        cfg=CGConfig(**cfg),
        dense_solve=lambda bb: torch.linalg.solve(ta, bb.T).T)
    assert rep.rungs == jrep.rungs == ("bad", "none", "dense")
    assert rep.status == jrep.status
    assert rep.iterations == jrep.iterations
    assert [f.summary() for f in rep.fallbacks] == \
        [f.summary() for f in jrep.fallbacks]
    # two float32 direct solves at cond 1e4: each within its own rounding
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=5e-3,
                               atol=2e-4)


# (n, condition number, rtol, the port's status): float32 CG's recursive
# residual drifts from b − A x, and on these systems the JAX engine calls
# every column converged on it
TRUE_RESIDUAL = {"restart-converges": (200, 1e3, 3e-6, CONVERGED),
                 "floor-stalls": (200, 3e3, 1e-6, STALLED)}


@pytest.mark.parametrize("case", sorted(TRUE_RESIDUAL))
def test_converged_holds_the_true_residual(case):
    """A column is converged only when its true residual, plus the
    matvec's rounding, is within 10·tol: it restarts from its iterate
    until it is (more iterations than the JAX engine) or ends stalled at
    its floor, and relres is the true residual either way."""
    n, cond, rtol, want = TRUE_RESIDUAL[case]
    a, b, _ = _spd_system(n=n, k=4, cond=cond)
    cfg = dict(rtol=rtol, max_iters=2000)
    _, jstats, _ = jpcg.pcg_iterate(lambda v: v @ jnp.asarray(a).T,
                                    jnp.asarray(b), cfg=jpcg.CGConfig(**cfg))
    x, stats, _ = pcg_iterate(_mv(a), torch.tensor(b), cfg=CGConfig(**cfg))
    true = (np.linalg.norm(b - x.numpy().astype(np.float64)
                           @ a.astype(np.float64).T, axis=1)
            / np.linalg.norm(b, axis=1))
    assert np.all(np.asarray(jstats["status"]) == CONVERGED)
    assert np.all(stats["status"].numpy() == want)
    assert np.all(stats["iters"].numpy() > np.asarray(jstats["iters"]))
    # relres is b − A x evaluated at float32, which is rounded by up to a
    # few tol here: the float64 one within the 10·tol bar
    np.testing.assert_allclose(stats["relres"].numpy(), true, rtol=0,
                               atol=10 * rtol)
    assert np.all((true <= 10 * rtol) == (want == CONVERGED)), true / rtol


# -- the engine's contract ----------------------------------------------------------
def _case_zero_rhs():
    a, b, _ = _spd_system()
    b[2] = 0.0
    _, stats, _ = pcg_iterate(_mv(a), torch.tensor(b))
    assert int(stats["iters"][2]) == 0
    assert int(stats["status"][2]) == CONVERGED


def _case_nonfinite_column():
    a, b, _ = _spd_system(k=6)
    x_clean, _, _ = pcg_iterate(_mv(a), torch.tensor(b))
    bad = b.copy()
    bad[3, 1] = np.nan
    x_bad, stats, _ = pcg_iterate(_mv(a), torch.tensor(bad))
    assert int(stats["status"][3]) == NONFINITE
    assert torch.all(x_bad[3] == 0.0)
    assert torch.isinf(stats["relres"][3])
    keep = [i for i in range(6) if i != 3]
    assert torch.equal(x_clean[keep], x_bad[keep]), \
        "a poisoned RHS perturbed its slab-mates"


def _case_diverging_column():
    """Column 2's operator is a scaled rotation (nonsymmetric, positive
    pᵀAp, spectral radius > 1): CG on it runs away, the divergence
    monitor quarantines it, and the SPD siblings are bit-identical to a
    clean run."""
    a, b, _ = _spd_system(n=40, k=5)
    rot = np.eye(40, dtype=np.float32)
    c, s = np.cos(1.2), np.sin(1.2)
    for i in range(0, 40, 2):
        rot[i:i + 2, i:i + 2] = [[c, -s], [s, c]]
    ta, trot = torch.tensor(a), torch.tensor(3.0 * rot)

    def mv_mixed(v):
        col = torch.arange(v.shape[0])[:, None] == 2
        return torch.where(col, v @ trot.T, v @ ta.T)

    def mv_clean(v):
        col = torch.arange(v.shape[0])[:, None] == 2
        return torch.where(col, 0.0 * (v @ ta.T), v @ ta.T)

    cfg = CGConfig(rtol=1e-6, divergence_factor=10.0, stall_window=100,
                   max_iters=300)
    b_clean = b.copy()
    b_clean[2] = 0.0
    x_clean, _, _ = pcg_iterate(mv_clean, torch.tensor(b_clean), cfg=cfg)
    x_bad, stats, _ = pcg_iterate(mv_mixed, torch.tensor(b), cfg=cfg)
    st = stats["status"].numpy()
    assert st[2] == DIVERGED, st
    keep = [i for i in range(5) if i != 2]
    assert np.all(st[keep] == CONVERGED)
    assert torch.equal(x_clean[keep], x_bad[keep]), \
        "a runaway column perturbed its slab-mates"
    assert torch.all(x_bad[2] == 0.0)


def _case_breakdown():
    """pᵀAp <= 0 (an indefinite operator) freezes the column with status
    breakdown, never a silent-garbage division."""
    a, b, _ = _spd_system(k=3)
    ta = torch.tensor(a)

    def mv(v):
        col = torch.arange(v.shape[0])[:, None] == 1
        return torch.where(col, -v, v @ ta.T)

    _, stats, _ = pcg_iterate(mv, torch.tensor(b))
    assert stats["status"].tolist() == [CONVERGED, BREAKDOWN, CONVERGED]


def _case_ladder():
    """A non-SPD preconditioner breaks every column at init; the ladder
    retries them unpreconditioned and records the transition."""
    a, b, x_ref = _spd_system()
    x, report = solve_guarded(
        _mv(a), torch.tensor(b), preconds=[("bad", lambda r: -r),
                                           ("none", None)],
        cfg=CGConfig(rtol=1e-6))
    assert report.rungs == ("bad", "none") and report.ok
    assert all(s == "converged" for s in report.status)
    (ev,) = report.fallbacks
    assert (ev.rung_from, ev.rung_to) == ("bad", "none")
    assert dict(ev.reasons) == {"breakdown": 5}
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=2e-4, atol=1e-5)


def _case_maxiter_to_dense():
    a, b, x_ref = _spd_system(cond=1e4)
    ta = torch.tensor(a)
    x, report = solve_guarded(
        _mv(a), torch.tensor(b), preconds=[("none", None)],
        cfg=CGConfig(rtol=1e-7, max_iters=3),
        dense_solve=lambda bb: torch.linalg.solve(ta, bb.T).T)
    assert report.rungs == ("none", "dense") and report.ok
    assert all(s == "dense" for s in report.status)
    # f32 direct solve at cond 1e4 vs the f64 numpy oracle
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=5e-3, atol=2e-4)


def _case_nonfinite_never_dense():
    a, b, _ = _spd_system(k=4)
    b[1, 0] = np.inf
    ta = torch.tensor(a)
    x, report = solve_guarded(
        _mv(a), torch.tensor(b), preconds=[("none", None)],
        cfg=CGConfig(rtol=1e-6),
        dense_solve=lambda bb: torch.linalg.solve(ta, bb.T).T)
    assert report.status[1] == "nonfinite"
    assert report.quarantined == (1,)
    assert torch.all(x[1] == 0.0) and not report.ok


def _case_device_loss_resumes(tmp_path):
    a, b, _ = _spd_system(cond=500.0)
    cfg = CGConfig(rtol=1e-7, max_iters=200)
    x_ref, ref, _, _ = pcg_solve(_mv(a), torch.tensor(b), cfg=cfg)
    fired = {"n": 0}

    def fault_hook(it):
        if it >= 6 and not fired["n"]:
            fired["n"] += 1
            raise DeviceLossError([0])

    x, stats, resumes, n_ckpt = pcg_solve(
        _mv(a), torch.tensor(b), cfg=cfg,
        manager=CheckpointManager(str(tmp_path / "cg")),
        checkpoint_every=3, fault_hook=fault_hook,
        on_device_loss=lambda exc: (None, None, None))
    assert fired["n"] == 1 and len(resumes) == 1
    assert resumes[0].restored_step == 6 and n_ckpt >= 3
    # the restored carry is the saved carry: the continuation reproduces
    # the uninterrupted solve bit for bit, statuses and true residuals too
    # (at cond 500 float32 cannot hold ‖b − A x‖ under 10·1e-7·‖b‖: every
    # column ends stalled at its floor, 4e-6–1.1e-5)
    assert torch.equal(x, x_ref)
    for key in ("status", "iters", "relres"):
        assert torch.equal(stats[key], ref[key])
    assert torch.all(stats["status"] == STALLED)
    assert torch.all(stats["relres"] < 1e-4)


def _case_device_loss_restarts_without_manager():
    a, b, _ = _spd_system()
    fired = {"n": 0}

    def fault_hook(it):
        if it >= 2 and not fired["n"]:
            fired["n"] += 1
            raise DeviceLossError([1])

    _, stats, resumes, _ = pcg_solve(
        _mv(a), torch.tensor(b), cfg=CGConfig(rtol=1e-6, max_iters=200),
        checkpoint_every=2, fault_hook=fault_hook,
        on_device_loss=lambda exc: (None, None, None))
    assert resumes and resumes[0].restored_step == 0
    assert torch.all(stats["status"] == CONVERGED)


def _case_device_loss_propagates_without_handler():
    a, b, _ = _spd_system()

    def fault_hook(it):
        raise DeviceLossError([0])

    with pytest.raises(DeviceLossError):
        pcg_solve(_mv(a), torch.tensor(b), fault_hook=fault_hook)


def _case_segment_length_changes_nothing():
    """Iterations past convergence are no-ops, so the host's segment
    length leaves every result bit-identical, iteration counts too."""
    a, b, _ = _spd_system(k=6, cond=500.0)
    b[4] = 0.0
    runs = [pcg_iterate(_mv(a), torch.tensor(b), cfg=CGConfig(rtol=1e-6),
                        segment=seg) for seg in (1, 3, 16)]
    for x, stats, _ in runs[1:]:
        assert torch.equal(x, runs[0][0])
        for key in ("status", "iters", "relres", "it"):
            assert torch.equal(stats[key], runs[0][1][key])


ENGINE_CASES = {
    "zero-rhs": _case_zero_rhs,
    "nonfinite-quarantined": _case_nonfinite_column,
    "diverging-quarantined": _case_diverging_column,
    "breakdown": _case_breakdown,
    "ladder": _case_ladder,
    "maxiter-to-dense": _case_maxiter_to_dense,
    "nonfinite-never-dense": _case_nonfinite_never_dense,
    "device-loss-resumes": _case_device_loss_resumes,
    "device-loss-restarts": _case_device_loss_restarts_without_manager,
    "device-loss-propagates": _case_device_loss_propagates_without_handler,
    "segment-length": _case_segment_length_changes_nothing,
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_contract(case, tmp_path):
    fn = ENGINE_CASES[case]
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames else fn()


# -- the conditioning system -------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CarriedICR(ICR):
    """The port's ICR on matrices carried across from the JAX package."""

    carried: Any = None

    def matrices(self, theta=None, **kw):
        return self.carried


@dataclasses.dataclass(frozen=True)
class JitICR(JICR):
    """The JAX package's ICR with its matrices built under ``jax.jit``
    (built op by op they take seconds on the CPU)."""

    def matrices(self, theta=None, **kw):
        return jax.jit(lambda: JICR.matrices(self, theta, **kw))()


# the reference tests' charts: 128-point tod and the 32x32 image
CHARTS = {
    "tod": (lambda m: m.regular_chart(32, 2, boundary="reflect"), 8.0),
    "image": (lambda m: m.regular_chart((8, 8), 2, boundary="reflect"), 4.0),
}


def _pair(name):
    """(JAX ICR, the port's ICR on the JAX package's matrices), both on
    the kernel route."""
    build, rho = CHARTS[name]
    jicr = JitICR(chart=build(jcharts),
                  kernel=jkernels.matern32.with_defaults(rho=rho),
                  use_pallas=True, use_pyramid=False)
    mats = matrices_to_torch(
        jax.tree.map(np.asarray, jicr.matrices_cached()), device="cpu")
    ticr = CarriedICR(build(tcharts),
                      tkernels.matern32.with_defaults(rho=rho),
                      use_pallas=True, device="cpu", carried=mats)
    return jicr, ticr


def _obs(n, seed=1):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=n // 2, replace=False)), rng


def _whitening_f64(s64, obs_idx, r, noise_var, m):
    """The ICR-whitened preconditioner at float64 from the dense square
    root: ``U = W S[:, :m]``, ``(r − U C⁻¹ Uᵀ r) / σ²``."""
    u = s64[obs_idx][:, :m]
    c = noise_var * np.eye(m) + u.T @ u
    return (r - np.linalg.solve(c, (r @ u).T).T @ u.T) / noise_var


@pytest.mark.parametrize("name", sorted(CHARTS))
def test_condition_matvec_and_precond_match_the_jax_package(name):
    """The matvec at 1e-5 from the JAX package's. The preconditioner at
    1e-5 from its float64 value on the same matrices, and from the JAX
    package's within 1e-5 plus the JAX package's own distance to that
    value (its float32 build is 3.2e-6 off on tod and 2.0e-5 on image,
    the port's 8.5e-8 and 1.2e-7)."""
    jicr, ticr = _pair(name)
    n = ticr.chart.size
    obs_idx, rng = _obs(n)
    v = rng.standard_normal((3, obs_idx.size)).astype(np.float32)
    jmats = jicr.matrices_cached()
    jop = jgp.obs_operator(jicr, obs_idx=obs_idx)
    op = obs_operator(ticr, obs_idx=obs_idx)
    assert op.fingerprint() == jop.fingerprint()
    want = np.asarray(jax.jit(lambda vv: jgp.condition_matvec(
        jicr, jmats, jop, 0.0625, vv))(jnp.asarray(v)))
    mats = ticr.matrices()
    got = condition_matvec(ticr, mats, op, 0.0625, torch.tensor(v))
    assert rel(got.numpy(), want) <= 1e-5

    level0 = ticr.xi_shapes()[0][0]   # max_basis = level 0's size
    jz = np.asarray(jax.jit(lambda vv: jgp.icr_whitening_precond(
        jicr, jmats, jop, 0.0625, max_basis=level0)(vv))(jnp.asarray(v)))
    pc = icr_whitening_precond(ticr, mats, op, 0.0625, max_basis=level0)
    s64 = ticr.implicit_sqrt(dtype=torch.float64).numpy()
    exact = _whitening_f64(s64, obs_idx, v.astype(np.float64), 0.0625,
                           level0)
    z = pc(torch.tensor(v)).numpy()
    assert rel(z, exact) <= 1e-5
    assert rel(z, jz) <= 1e-5 + rel(jz, exact)
    # ConditionSystem.correct is one Sᵀ then one S: K Wᵀ α
    sys_ = build_condition_system(ticr, op, 0.0625, use_precond=False)
    cov = s64 @ s64.T
    corr = sys_.correct(torch.tensor(v)).reshape(3, -1).numpy()
    assert rel(corr, v.astype(np.float64) @ cov[obs_idx]) <= 1e-5


@pytest.mark.parametrize("name", sorted(CHARTS))
def test_cg_posterior_matches_the_jax_package_and_the_exact_posterior(name):
    """The reference test's data: y = (K truth)[obs] + 0.05 noise, σ=0.25.
    At the JAX package's default config (rtol 1e-7; the port's default
    draws its rtol from the matvec's rounding) the port's mean field
    equals the JAX package's and the exact posterior's on
    ``implicit_cov`` (float64) at rel <= 1e-5."""
    jicr, ticr = _pair(name)
    n = ticr.chart.size
    obs_idx, rng = _obs(n)
    cov = ticr.implicit_cov(dtype=torch.float64)
    truth = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,)))
    y = ((cov.numpy() @ truth)[obs_idx]
         + 0.05 * rng.standard_normal(obs_idx.size)).astype(np.float32)

    post, report = cg_posterior(
        ticr, obs_idx, y, noise_std=0.25,
        config=CGConfig(rtol=1e-7, max_iters=max(4 * obs_idx.size, 200)))
    assert report.ok and report.rungs[0] == "icr", report.summary()
    assert post.log_std is None
    mean = ticr.apply_sqrt(post.matrices(), post.mean).reshape(-1).numpy()

    jpost, jreport = jcg_posterior(jicr, obs_idx, y, noise_std=0.25)
    jmean = np.asarray(jicr.apply_sqrt(jicr.matrices_cached(), jpost.mean))
    assert abs(report.iterations[0] - jreport.iterations[0]) <= 1
    assert rel(mean, jmean.reshape(-1)) <= 1e-5

    m_ref, _ = exact_posterior(cov, obs_idx, torch.tensor(y), 0.25 ** 2)
    assert rel(mean, m_ref.numpy()) <= 1e-5


def test_icr_preconditioner_halves_iterations():
    """The ICR-whitened rung needs <= 0.5x the unpreconditioned rung's
    iterations (BENCH_PR9.json: 2 against 61 and 90 on tod and image).
    At rtol 1e-7 both rungs end stalled at the float32 floor of this
    system (the true residual of the float64 dense solution is 1.6e-4 at
    float32), so each rung's count is its iterations to that floor."""
    icr = ICR(tcharts.regular_chart(32, 3, boundary="reflect"),
              tkernels.matern32.with_defaults(rho=8.0), use_pallas=True,
              device="cpu")
    obs_idx = np.arange(0, icr.chart.size, 2)
    y = np.random.default_rng(2).standard_normal(obs_idx.size)
    _, rep_pre = cg_posterior(icr, obs_idx, y, use_precond=True)
    _, rep_raw = cg_posterior(icr, obs_idx, y, use_precond=False)
    assert rep_pre.ok and rep_raw.ok
    assert rep_pre.rungs[0] == "icr" and rep_raw.rungs[0] == "none"

    def first_rung(rep):
        """(iterations on the first rung, why it was left)"""
        if not rep.fallbacks:
            return rep.max_iterations, rep.status
        return rep.fallbacks[0].at_iter, rep.fallbacks[0].reasons

    (pre, why_pre), (raw, why_raw) = first_rung(rep_pre), first_rung(rep_raw)
    assert why_pre == why_raw
    assert pre / max(raw, 1) <= 0.5, (pre, raw)


def test_offgrid_interpolation_matches_the_jax_package():
    """1-D ``GridInterp``: the same stencil as the JAX package's, W and Wᵀ
    at 1e-6, and ``cg_posterior`` on off-grid points explains the data."""
    icr = ICR(tcharts.regular_chart(32, 3, boundary="reflect"),
              tkernels.matern32.with_defaults(rho=8.0), use_pallas=True,
              device="cpu")
    jchart = jcharts.regular_chart(32, 3, boundary="reflect")
    grid = icr.chart.axis_coords(icr.chart.n_levels, 0)
    rng = np.random.default_rng(3)
    x_obs = rng.uniform(grid[2], grid[-3], 40)
    op = obs_operator(icr, x_obs=x_obs)
    jop = jgp.GridInterp.from_points(
        jchart.axis_coords(jchart.n_levels, 0), x_obs)
    assert isinstance(op, tgp.GridInterp)
    assert op.fingerprint() == jop.fingerprint()
    f = rng.standard_normal((2, icr.chart.size)).astype(np.float32)
    v = rng.standard_normal((2, 40)).astype(np.float32)
    np.testing.assert_allclose(op.apply(torch.tensor(f)).numpy(),
                               np.asarray(jop.apply(jnp.asarray(f))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(op.apply_t(torch.tensor(v)).numpy(),
                               np.asarray(jop.apply_t(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-6)

    y = np.sin(x_obs / 8.0).astype(np.float32)
    post, report = cg_posterior(icr, x_obs.astype(np.float32), y,
                                noise_std=0.05)
    assert report.ok, report.summary()
    mean = icr.apply_sqrt(post.matrices(), post.mean).reshape(1, -1)
    pred = op.apply(mean)[0].numpy()
    assert np.sqrt(np.mean((pred - y) ** 2)) < 0.1


def test_build_condition_system_refuses_a_mesh():
    """A mesh of slots splits the matvec's right-hand sides (held to the
    unsharded matvec in ``test_torch_serve_mesh.py``); any other object
    passed as ``mesh`` is refused."""
    _, ticr = _pair("tod")
    op = obs_operator(ticr, obs_idx=np.arange(8))
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        build_condition_system(ticr, op, 0.01, mesh=object())
