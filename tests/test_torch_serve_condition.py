"""``kind="condition"`` on the port's GP field server, held to the JAX
package's ``GPFieldServer`` on the CPU.

* Admission: each malformed condition request gets the JAX server's
  rejection code, before any solve work.
* The served posterior mean equals the JAX server's, and the exact
  posterior's at float64, at 1e-5 (relative, 2-norm) on the same
  matrices (``CarriedICR``) and data, at σ = 0.25 (the CG example's
  default; at σ = 0.05 each server lies 6–8e-6 from the float64 posterior,
  in other directions, and the two 1.1e-5 apart). The Matheron
  draws come from the port's counter-based (seed, row) stream, so the
  std is held to the exact posterior std instead: its pixel mean within
  0.75–1.25× (the JAX test's bound; 64 draws), and lower at observed
  pixels than elsewhere.
* Condition requests ride alongside sampling traffic without changing
  it, and repeat traffic hits the condition-system cache.
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
from repro.core.vi import Posterior as JPosterior
from repro.launch import serve_gp as jserve
from repro_torch import ICR, exact_posterior
from repro_torch.convert import matrices_to_torch
from repro_torch.core import charts as tcharts
from repro_torch.core import kernels as tkernels
from repro_torch.core.vi import Posterior
from repro_torch.launch import serve_gp as sg
from repro_torch.solvers import SolveReport, build_condition_system
from repro_torch.solvers.gp_system import obs_operator

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

RHO = 8.0


def _chart(m):
    """The JAX test's chart: 256 points, 1-D."""
    return m.regular_chart(32, 3, boundary="reflect")


@dataclasses.dataclass(frozen=True)
class CarriedICR(ICR):
    """The port's ICR on matrices carried across from the JAX package."""

    carried: Any = None

    def matrices(self, theta=None, **kw):
        return self.carried


@dataclasses.dataclass(frozen=True)
class JitICR(JICR):
    """The JAX package's ICR with its matrices built under ``jax.jit``."""

    def matrices(self, theta=None, **kw):
        return jax.jit(lambda: JICR.matrices(self, theta, **kw))()


@pytest.fixture(scope="module")
def posteriors():
    """A MAP posterior of the JAX package and its port on the JAX
    package's matrices."""
    jicr = JitICR(chart=_chart(jcharts),
                  kernel=jkernels.matern32.with_defaults(rho=RHO),
                  use_pallas=True)
    mats = matrices_to_torch(jax.tree.map(np.asarray,
                                          jicr.matrices_cached()),
                             device="cpu")
    ticr = CarriedICR(_chart(tcharts),
                      tkernels.matern32.with_defaults(rho=RHO),
                      use_pallas=True, device="cpu", carried=mats)
    rng = np.random.default_rng(5)
    xi = [rng.normal(size=s).astype(np.float32) for s in ticr.xi_shapes()]
    return (JPosterior(icr=jicr, mean=[jnp.asarray(x) for x in xi]),
            Posterior(icr=ticr, mean=[torch.tensor(x) for x in xi]))


def _own_posterior():
    """The port's own demo posterior on the JAX test's chart."""
    return sg.demo_posterior(_chart(tcharts), RHO, device="cpu")


def _obs_y(step=4, seed=0):
    n = _chart(tcharts).size
    obs_idx = np.arange(0, n, step)
    rng = np.random.default_rng(seed)
    y = (np.sin(np.linspace(0.0, 6.0, obs_idx.size))
         + 0.05 * rng.standard_normal(obs_idx.size)).astype(np.float32)
    return y, obs_idx


def _cond(make, y, obs_idx, n=6, seed=9, **kw):
    kw.setdefault("noise_std", 0.05)
    return make(kind="condition", n=n, seed=seed, y=y, obs_idx=obs_idx,
                **kw)


# -- admission --------------------------------------------------------------------
def _admission_cases(make):
    y, obs_idx = _obs_y()
    n = _chart(tcharts).size
    return {
        "y-missing": _cond(make, None, obs_idx),
        "y-nonfinite": _cond(make, np.full(len(obs_idx), np.nan), obs_idx),
        "obs-spec-none": make(kind="condition", n=4, y=y),
        "obs-spec-both": make(kind="condition", n=4, y=y, obs_idx=obs_idx,
                              x_obs=np.zeros(len(y))),
        "obs-range": _cond(make, y[:3], np.array([0, 5, n + 7])),
        "obs-dtype": _cond(make, y[:3], np.array([0.5, 1.5, 2.5])),
        "obs-length": _cond(make, y[:4], obs_idx[:3]),
        "noise-zero": _cond(make, y, obs_idx, noise_std=0.0),
        "noise-nan": _cond(make, y, obs_idx, noise_std=float("nan")),
        "x-obs-nonfinite": make(kind="condition", n=4, y=y[:2],
                                x_obs=np.array([1.0, np.inf])),
    }


CASES = sorted(_admission_cases(sg.GPRequest))


@pytest.fixture(scope="module")
def servers(posteriors):
    jpost, tpost = posteriors
    return (jserve.GPFieldServer(jpost, slab=2),
            sg.GPFieldServer(tpost, slab=2))


@pytest.mark.parametrize("case", CASES)
def test_condition_admission_codes_match_the_jax_server(servers, case):
    jsrv, tsrv = servers
    jreq = _admission_cases(jserve.GPRequest)[case]
    treq = _admission_cases(sg.GPRequest)[case]
    jsrv.run([jreq])
    tsrv.run([treq])
    assert treq.done and jreq.done and treq.error is not None
    assert treq.error.code == jreq.error.code
    assert tsrv.condition_requests == jsrv.condition_requests == 0


# -- the served posterior ------------------------------------------------------------
def test_served_mean_matches_the_jax_server(posteriors):
    """Each server's mean against the exact posterior mean on the ICR
    covariance (float64) at rel <= 1e-5, at the data's σ = 0.05; the two
    float32 servers then agree within the sum of their distances to it."""
    jpost, tpost = posteriors
    y, obs_idx = _obs_y()
    jreq = _cond(jserve.GPRequest, y, obs_idx)
    jserve.GPFieldServer(jpost, slab=4).run([jreq])
    srv = sg.GPFieldServer(tpost, slab=4)
    req = _cond(sg.GPRequest, y, obs_idx)
    srv.run([req])
    assert req.done and req.error is None, req.error
    assert isinstance(req.report, SolveReport) and req.report.ok
    assert req.report.rungs[0] == "icr"
    assert req.mean.shape == tuple(tpost.icr.chart.final_shape)
    cov = tpost.icr.implicit_cov(dtype=torch.float64)
    mean, _ = exact_posterior(cov, obs_idx,
                              torch.tensor(y, dtype=torch.float64), 0.05 ** 2)
    mean = mean.numpy()

    def rel(got, want):
        got = np.asarray(got, np.float64).reshape(-1)
        want = np.asarray(want, np.float64).reshape(-1)
        return np.linalg.norm(got - want) / np.linalg.norm(want)

    port, jax_ = rel(req.mean, mean), rel(jreq.mean, mean)
    assert port <= 1e-5 and jax_ <= 1e-5, (port, jax_)
    assert rel(req.mean, jreq.mean) <= 2e-5
    assert np.isfinite(req.std).all() and (req.std > 0).all()

    met = srv.metrics()
    assert met["condition_requests"] == 1
    assert met["condition_rhs"] == 1 + req.n
    assert met["solve_segments"] >= 1
    assert met["solve_reports"][-1]["tag"] == f"condition:{obs_idx.size}obs"
    assert met["solve_reports"][-1]["ok"]


def test_matheron_std_tracks_the_exact_posterior():
    """Pathwise (Matheron) std over 64 draws against the exact posterior
    std on the ICR covariance (float64): within 0.75–1.25× on the pixel
    mean (~9 % Monte Carlo error) and depressed at observed pixels."""
    post = _own_posterior()
    y, obs_idx = _obs_y(step=8)
    srv = sg.GPFieldServer(post, slab=4)
    req = _cond(sg.GPRequest, y, obs_idx, n=64)
    srv.run([req])
    assert req.error is None and np.isfinite(req.std).all()
    std = req.std.reshape(-1)
    unobs = np.setdiff1d(np.arange(std.size), obs_idx)
    assert std[obs_idx].mean() < std[unobs].mean()

    cov = post.icr.implicit_cov(dtype=torch.float64)
    _, cov_post = exact_posterior(cov, obs_idx,
                                  torch.tensor(y, dtype=torch.float64),
                                  0.05 ** 2)
    exact_std = torch.sqrt(torch.diagonal(cov_post)).numpy()
    ratio = std.mean() / exact_std.mean()
    assert 0.75 < ratio < 1.25, f"Matheron std off exact by x{ratio:.3f}"


def test_matheron_draws_are_the_slab_noise_stream():
    """Row j's ξ is the sampling slab's draw for (seed, row j); ε follows
    it in the same row's stream."""
    post = _own_posterior()
    srv = sg.GPFieldServer(post, slab=4)
    req = _cond(sg.GPRequest, *_obs_y(), n=3, seed=21)
    mats = post.icr.matrices_cached()
    fields, eps = srv._matheron_draws(req, 7, mats)
    n_xi = post.icr.xi_size()
    z = sg.row_normals(torch.full((3,), 21), torch.arange(3),
                       sg.noise_counters(n_xi + 7, "cpu"))
    xi, o = [], 0
    for s in post.icr.xi_shapes():
        m = int(np.prod(s))
        xi.append(z[:, o:o + m].reshape((3,) + tuple(s)))
        o += m
    want = post.icr.apply_sqrt_batch(mats, xi).reshape(3, -1)
    torch.testing.assert_close(fields, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(eps, z[:, n_xi:])


# -- alongside other traffic, and the cache ---------------------------------------------
def test_condition_rides_with_sampling_traffic():
    """A mixed queue: the condition solve and the sampling slabs both
    complete, and the sampling results are those of the same queue
    without the condition request."""
    post = _own_posterior()
    y, obs_idx = _obs_y()
    clean = sg.GPRequest(kind="moments", n=6, seed=2)
    sg.GPFieldServer(post, slab=4).run(
        [sg.GPRequest(kind="sample", n=3, seed=1), clean])
    srv = sg.GPFieldServer(post, slab=4)
    mixed = [sg.GPRequest(kind="sample", n=3, seed=1),
             _cond(sg.GPRequest, y, obs_idx),
             sg.GPRequest(kind="moments", n=6, seed=2)]
    srv.run(mixed)
    assert all(r.done and r.error is None for r in mixed), \
        [r.error for r in mixed]
    assert np.array_equal(mixed[2].mean, clean.mean)
    assert np.array_equal(mixed[2].std, clean.std)
    assert srv.metrics()["condition_requests"] == 1


def test_condition_system_cache_hits_on_repeat_traffic():
    post = _own_posterior()
    y, obs_idx = _obs_y()
    srv = sg.GPFieldServer(post, slab=4, solver_checkpoint_every=0)
    srv.run([_cond(sg.GPRequest, y, obs_idx)])
    sys_first = next(iter(srv._cond_cache.values()))
    srv.run([_cond(sg.GPRequest, 2.0 * y, obs_idx, seed=5)])
    assert len(srv._cond_cache) == 1
    assert next(iter(srv._cond_cache.values())) is sys_first
    # a new observation pattern is a deliberate miss
    srv.run([_cond(sg.GPRequest, y[:-1], obs_idx[:-1])])
    assert len(srv._cond_cache) == 2
    # the cached system is the one build_condition_system makes
    op = obs_operator(post.icr, obs_idx=obs_idx)
    ref = build_condition_system(post.icr, op, 0.05 ** 2)
    v = torch.randn(2, obs_idx.size, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(sys_first.matvec(v), ref.matvec(v))
