"""The matrix build without a host sync, on the CPU, held against numpy and
the JAX package.

On a CUDA device a learned-θ step rebuilds every refinement matrix inside
a captured CUDA graph: the families' eigenpairs come from the batched
Jacobi of ``kernels/sym_eig.py`` (``csrc/sym_eig.cu``), the level-0 root is
a float64 Cholesky factor, and each factorisation's status stays on the
device until the fit ends. On CPU tensors the same code runs the Jacobi's
plain version, so these tests hold its arithmetic, and
``tests/test_torch_cuda.py`` holds the kernel against it on the card:

* the plain Jacobi against ``numpy.linalg.eigh`` on seeded batches with
  repeated eigenvalues and numerically semi-definite matrices: in float64
  within 1e-6 of the largest eigenvalue (eigenvalues, ``V Λ Vᵀ``, ``VᵀV =
  I``); in float32 within 8·n·eps_f32, the rounding of ~n rotations per
  entry and sweep; its sweep order covers every pair once; its status
  flags a sweep count short of convergence;
* the builders (``refinement_matrices_level``,
  ``axis_refinement_matrices_level``, ``level0_sqrt``) against the JAX
  package on small well-conditioned charts: R, sqrtD·sqrtDᵀ and
  sqrt0·sqrt0ᵀ within 1e-5 (both builds float32; the roots' own factors
  differ by an orthogonal matrix, so their Gram matrices are compared);
* the θ-gradient of a sign-free functional of the matrices against
  ``jax.grad`` of the same functional, 1e-4 (float32 cotangents through
  the eigen-solve, the symmetric root and the Cholesky factor; the root's
  term only where the JAX package's gradient through eigh is finite);
* the level-0 root: a Cholesky factor of K in float64, of ``K + eps·I``
  where K has eigenvalues under eps; a NaN θ raises after the fit, naming
  the level.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import charts as jcharts
from repro.core import kernels as jkernels
from repro.core import refine as jrefine
from repro_torch import (StandardizedModel, gaussian_log_likelihood,
                         lognormal_prior, map_fit)
from repro_torch.core import ICR
from repro_torch.core import charts as tcharts
from repro_torch.core import kernels as tkernels
from repro_torch.core import refine as trefine
from repro_torch.kernels import sym_eig

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _sq(m):
    return m @ np.swapaxes(m, -1, -2)


def _batch(n, rng):
    """Random symmetric matrices, ones with repeated eigenvalues, and
    numerically semi-definite ones (eigenvalues 0 and ±1e-12 beside O(1)),
    as the conditional covariances D of strongly correlated points."""
    out = []
    for _ in range(4):
        a = rng.normal(size=(n, n))
        out.append(a + a.T)
    for evals in ([1.0] * n, [2.0] * (n // 2) + [0.5] * (n - n // 2),
                  [0.0, 1e-12, -1e-12] + list(rng.uniform(0.1, 1, n))):
        q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        out.append((q * np.asarray(evals[:n])) @ q.T)
    return np.stack(out)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 32])
def test_plain_jacobi_matches_numpy(n):
    rng = np.random.default_rng(n)
    a = _batch(n, rng)
    a = 0.5 * (a + np.swapaxes(a, -1, -2))
    want = np.linalg.eigvalsh(a)
    scale = np.abs(want).max(axis=-1)[:, None]
    for dtype, tol in ((torch.float64, 1e-6),
                       (torch.float32, 8 * n * 2.0**-23)):
        w, v, status = sym_eig.sym_eig(torch.tensor(a, dtype=dtype))
        w, v = w.double().numpy(), v.double().numpy()
        assert (np.abs(w - want) / scale).max() < tol
        assert (np.abs((v * w[:, None, :]) @ np.swapaxes(v, -1, -2) - a)
                / scale[..., None]).max() < tol
        assert np.abs(np.swapaxes(v, -1, -2) @ v - np.eye(n)).max() < tol
        assert np.all(np.diff(w, axis=-1) >= 0)
        assert float(status.max()) <= sym_eig.BOUND


def test_sweep_order_and_the_status():
    """A sweep rotates every pair once (the circle method's rounds, pairs
    of a round disjoint); one sweep leaves a 16×16 matrix far from
    diagonal and the status says so; the default sweeps converge."""
    for n in range(1, 34):
        pairs = [pq for rnd in sym_eig.rounds(n) for pq in rnd
                 if max(pq) < n]
        assert sorted(tuple(sorted(pq)) for pq in pairs) == list(
            itertools.combinations(range(n), 2))
        for rnd in sym_eig.rounds(n):
            idx = [i for pq in rnd for i in pq]
            assert len(idx) == len(set(idx))
    a = torch.tensor(_batch(16, np.random.default_rng(0))[:4],
                     dtype=torch.float32)
    assert float(sym_eig.sym_eig(a, sweeps=1)[2].min()) > 100 * sym_eig.BOUND
    assert float(sym_eig.sym_eig(a)[2].max()) <= sym_eig.BOUND


# (chart builder, rho, joint, root gradient): small well-conditioned
# charts (shrink boundaries, neighbours within about a correlation length:
# the two float32 builds then agree to 1.3e-6 to 2.9e-6 where the JAX
# package's own float32 error nears 1e-5 at twice the correlation); the
# 3-D joint build is n_csz^9 per family, so dust takes the per-axis
# factors. The JAX package's θ-gradient through eigh is NaN where K has
# repeated eigenvalues, as the level-0 grids of log_polar and dust do (the
# symmetric angular axes): there the functional leaves the root out
BUILD_CHARTS = {
    "regular": (lambda m: m.regular_chart(16, 2), 0.7, True, True),
    "log": (lambda m: m.log_chart(12, 2, n_csz=5, n_fsz=4, delta0=0.2), 0.3,
            True, True),
    "log_polar": (lambda m: m.log_polar_chart(
        (8, 8), 2, delta_logr=0.3, boundary="shrink"), 0.5, True, False),
    "dust": (lambda m: m.galactic_dust_chart(
        (7, 7, 7), 2, delta_logr=0.3, angular_extent=3.5,
        boundary="shrink"), 0.3, False, False),
}


def _builds(refine, chart, k, joint):
    out = {"sqrt0": refine.level0_sqrt(chart, k)}
    for lvl in range(chart.n_levels):
        if joint:
            out[f"joint{lvl}"] = refine.refinement_matrices_level(chart, k,
                                                                  lvl)
        out[f"axes{lvl}"] = refine.axis_refinement_matrices_level(chart, k,
                                                                  lvl)
    return out


def _port_builds(chart, k, joint):
    out = {"sqrt0": trefine.level0_sqrt(chart, k, device="cpu")}
    for lvl in range(chart.n_levels):
        if joint:
            out[f"joint{lvl}"] = trefine.refinement_matrices_level(
                chart, k, lvl, device="cpu")
        out[f"axes{lvl}"] = trefine.axis_refinement_matrices_level(
            chart, k, lvl, device="cpu")
    return out


def _pairs(builds):
    """(R, sqrtD) pairs of every build, and the level-0 root."""
    pairs = []
    for name, b in sorted(builds.items()):
        if name.startswith("joint"):
            pairs.append(b)
        elif name.startswith("axes"):
            pairs += list(zip(*b))
    return pairs, builds["sqrt0"]


@pytest.mark.parametrize("name", sorted(BUILD_CHARTS))
def test_builders_match_the_jax_package(name):
    build, rho, joint, _ = BUILD_CHARTS[name]
    jc, tc = build(jcharts), build(tcharts)
    jk = jkernels.matern32.with_defaults(rho=rho)()
    tk = tkernels.matern32.with_defaults(rho=rho)()
    want = jax.jit(lambda: _builds(jrefine, jc, jk, joint))()
    (wpairs, w0), (gpairs, g0) = _pairs(want), _pairs(
        _port_builds(tc, tk, joint))
    assert rel(_sq(g0.numpy()), _sq(np.asarray(w0))) < 1e-5
    for (wr, wd), (gr, gd) in zip(wpairs, gpairs):
        assert gr.shape == wr.shape
        assert rel(gr.numpy(), wr) < 1e-5
        assert rel(_sq(gd.numpy()), _sq(np.asarray(wd))) < 1e-5


def _functional(pairs, root, weights, sq):
    """Σ R∘C + Σ (sqrtD sqrtDᵀ)∘C' over every build, + Σ (S0 S0ᵀ)∘C0
    where C0 is given."""
    total = 0.0 if weights[0] is None else (sq(root) * weights[0]).sum()
    for (r, d), (cr, cd) in zip(pairs, weights[1:]):
        total = total + (r * cr).sum() + (sq(d) * cd).sum()
    return total


@pytest.mark.parametrize("name", sorted(BUILD_CHARTS))
def test_theta_gradient_matches_jax_grad(name):
    build, rho, joint, with_root = BUILD_CHARTS[name]
    jc, tc = build(jcharts), build(tcharts)
    rng = np.random.default_rng(5)
    tk = tkernels.matern32
    pairs, root = _pairs(_port_builds(tc, tk.with_defaults(rho=rho)(),
                                      joint))
    weights = [rng.normal(size=root.shape).astype(np.float32)
               if with_root else None]
    for r, d in pairs:
        weights.append((rng.normal(size=r.shape).astype(np.float32),
                        rng.normal(size=d.shape[:-1] + d.shape[-2:-1])
                        .astype(np.float32)))

    def jax_f(log_rho):
        k = jkernels.matern32.fn({"rho": jnp.exp(log_rho), "sigma": 1.0})
        p, s0 = _pairs(_builds(jrefine, jc, k, joint))
        return _functional(p, s0, weights,
                           lambda m: m @ jnp.swapaxes(m, -1, -2))

    want = float(jax.jit(jax.grad(jax_f))(jnp.float32(np.log(rho))))
    log_rho = torch.tensor(np.log(rho), dtype=torch.float32,
                           requires_grad=True)
    k = tk.fn({"rho": torch.exp(log_rho), "sigma": 1.0})
    p, s0 = _pairs(_port_builds(tc, k, joint))
    tw = [None if weights[0] is None else torch.tensor(weights[0])] + [
        tuple(map(torch.tensor, w)) for w in weights[1:]]
    got, = torch.autograd.grad(
        _functional(p, s0, tw, lambda m: m @ m.transpose(-1, -2)), log_rho)
    assert abs(float(got) - want) <= 1e-4 * abs(want)


def test_level0_root_is_a_float64_cholesky_factor():
    """The regular chart of the card's learned-θ path (1,024 level-0
    points, ρ = 0.06 of its extent): its float32 kernel matrix has
    eigenvalues under −eps, and no Cholesky factor of ``K + eps·I``; the
    root built in float64 factors ``K + eps·I`` (an eigenvalue under eps)
    and passes its status. On a well-conditioned chart the root factors K
    itself, as the JAX package's clipped root spans it."""
    chart = tcharts.regular_chart(1024, 10, boundary="reflect")
    k = tkernels.matern32.with_defaults(rho=0.06 * chart.size)()
    k32 = tkernels.kernel_matrix(k, chart.grid_positions(0, device="cpu"))
    eye = torch.eye(1024)
    assert int(torch.linalg.cholesky_ex(k32 + 1e-6 * eye)[1]) > 0
    with trefine.build_checks() as log:
        s0 = trefine.level0_sqrt(chart, k, device="cpu")
    assert not log.failures()
    k64 = tkernels.kernel_matrix(k, chart.grid_positions(
        0, device="cpu", dtype=torch.float64))
    assert rel(_sq(s0.double().numpy()), (k64 + 1e-6 * eye).numpy()) < 1e-6
    small = tcharts.regular_chart(16, 2)
    k = tkernels.matern32.with_defaults(rho=2.0)()
    s0 = trefine.level0_sqrt(small, k, device="cpu", dtype=torch.float64)
    k64 = tkernels.kernel_matrix(k, small.grid_positions(
        0, device="cpu", dtype=torch.float64))
    assert rel(_sq(s0.numpy()), k64.numpy()) < 1e-12


def test_nan_theta_raises_after_the_fit_naming_the_level():
    """A NaN in θ reaches every factorisation of the build; the fit runs
    all its steps (nothing reads the statuses before), then raises,
    naming the level-0 root and the refinement levels."""
    icr = ICR(tcharts.regular_chart(16, 2), tkernels.matern32, device="cpu",
              use_pallas=True)
    priors = StandardizedModel({"rho": lognormal_prior(8.0, 4.0)})

    def fwd(latent):
        theta = dict(priors(latent[1]))
        theta["sigma"] = 1.0
        return icr(latent[0], theta)

    latent0 = (icr.zero_xi(), {"rho": torch.tensor(float("nan"))})
    y = torch.zeros(icr.chart.size)
    with pytest.raises(trefine.BuildError,
                       match="level-0 root.*refinement level 0"):
        map_fit(gaussian_log_likelihood(0.05), fwd, latent0, y, steps=3)
