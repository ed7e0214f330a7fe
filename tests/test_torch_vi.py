"""The port's fits, priors, optimizer and dataset held against the JAX
package's (paper §3.2, Eq. 2/3).

The fits run on the problem of ``tests/test_vi.py``, with its assertions:
a 52-point regular chart, ρ=10, every second point observed with noise
0.05. ξ and the noise come from numpy seeds, the matrices from the JAX
package (handed across), and the port's ICR runs on the kernel route on
CPU tensors: its kernels' plain versions, forward and backward. The MAP
fit's final loss must match the JAX package's at rtol 5e-2, the JAX
test's own bound (``tests/test_vi.py``): per-step gradients agree to
1e-5, but 250 float32 steps compound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ICR as JICR
from repro.core import charts as jcharts
from repro.core import kernels as jkernels
from repro.core import standardize as jstd
from repro.core import vi as jvi
from repro.optim import adamw as jadamw
from repro.optim import linear_warmup_cosine as jschedule
from repro_torch import (
    ICR,
    StandardizedModel,
    advi_fit,
    advi_posterior,
    charted_gp_dataset,
    gaussian_log_likelihood,
    lognormal_prior,
    map_fit,
    map_posterior,
    matern32,
    normal_prior,
    poisson_log_likelihood,
    regular_chart,
    uniform_prior,
)
from repro_torch.convert import matrices_to_torch, posterior_to_torch
from repro_torch.optim import adamw, linear_warmup_cosine

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    jicr = JICR(jcharts.regular_chart(16, 2),
                jkernels.matern32.with_defaults(rho=10.0))
    icr = ICR(regular_chart(16, 2), matern32.with_defaults(rho=10.0),
              use_pallas=True, device="cpu")
    jmats = jax.jit(jicr.matrices)()
    mats = matrices_to_torch(jax.tree.map(np.asarray, jmats), device="cpu")
    rng = np.random.default_rng(7)
    xi = [torch.tensor(rng.normal(size=s), dtype=torch.float32)
          for s in icr.xi_shapes()]
    truth = icr.apply_sqrt(mats, xi).reshape(-1)
    obs_idx = torch.arange(0, truth.numel(), 2)
    noise = 0.05
    y = truth[obs_idx] + noise * torch.tensor(
        rng.normal(size=obs_idx.shape), dtype=torch.float32)
    return icr, mats, jicr, jmats, truth, obs_idx, y, noise


def _rmse(icr, mats, xi, obs_idx, y) -> float:
    rec = icr.apply_sqrt(mats, xi).reshape(-1)
    return float(torch.sqrt(torch.mean((rec[obs_idx] - y) ** 2)))


def test_map_recovers_field_and_matches_reference(problem):
    icr, mats, jicr, jmats, truth, obs_idx, y, noise = problem
    ll = gaussian_log_likelihood(noise, obs_idx)
    xi, losses = map_fit(ll, lambda x: icr.apply_sqrt(mats, x),
                         icr.zero_xi(), y, steps=250)
    assert losses.shape == (250,)
    assert float(losses[-1]) < float(losses[0]) * 0.1
    assert _rmse(icr, mats, xi, obs_idx, y) < 3 * noise
    jll = jvi.gaussian_log_likelihood(noise, jnp.asarray(obs_idx.numpy()))
    _, jlosses = jvi.map_fit(jll, lambda x: jicr.apply_sqrt(jmats, x),
                             jicr.zero_xi(), jnp.asarray(y.numpy()),
                             steps=250)
    np.testing.assert_allclose(float(losses[-1]), float(jlosses[-1]),
                               rtol=5e-2)
    np.testing.assert_allclose(float(losses[0]), float(jlosses[0]),
                               rtol=1e-5)


def test_advi_improves_elbo(problem):
    icr, mats, *_, obs_idx, y, noise = problem
    ll = gaussian_log_likelihood(noise, obs_idx)
    (mean, log_std), elbos = advi_fit(
        torch.Generator().manual_seed(0), ll,
        lambda x: icr.apply_sqrt_batch(mats, x), icr.zero_xi(), y,
        steps=200)
    assert float(elbos[-1]) > float(elbos[0])
    # the posterior std shrank below the prior's
    assert float(torch.mean(torch.exp(log_std[0]))) < 1.0
    post = advi_posterior(icr, (mean, log_std))
    m, s = post.moments(torch.Generator().manual_seed(1), 16)
    assert m.shape == s.shape == icr.out_shape
    assert bool(torch.all(s > 0))


def test_joint_theta_field_inference(problem):
    """Kernel parameters θ learned jointly with the field: the matrices
    are rebuilt inside every differentiated step."""
    icr, _, *_, obs_idx, y, noise = problem
    priors = StandardizedModel({"rho": lognormal_prior(8.0, 4.0)})
    ll = gaussian_log_likelihood(noise, obs_idx)

    def fwd(latent):
        xi_s, xi_t = latent
        theta = priors(xi_t)
        theta["sigma"] = 1.0
        return icr(xi_s, theta)

    latent, losses = map_fit(ll, fwd, (icr.zero_xi(),
                                       priors.zero_xi(device="cpu")), y,
                             steps=150)
    assert float(losses[-1]) < float(losses[0])
    rho_hat = float(priors(latent[1])["rho"])
    assert 1.0 < rho_hat < 100.0


def test_poisson_likelihood(problem):
    """A non-Gaussian likelihood, without any kernel inversion."""
    icr, mats, _, _, truth, obs_idx, _, _ = problem
    lam = np.exp(truth[obs_idx].numpy())
    counts = torch.tensor(np.random.default_rng(3).poisson(lam),
                          dtype=torch.float32)
    xi, losses = map_fit(poisson_log_likelihood(obs_idx),
                         lambda x: icr.apply_sqrt(mats, x), icr.zero_xi(),
                         counts, steps=200)
    assert float(losses[-1]) < float(losses[0])
    post = map_posterior(icr, xi)
    assert all(float(s.abs().max()) == 0.0 for s in post.std())


def test_posterior_carried_across(problem):
    """A JAX fit, as numpy arrays, becomes the port's Posterior: ξ exact,
    θ float32, and its fields the port's apply at that θ (the two
    packages' matrices differ by eigh column signs, so fields are compared
    within the port)."""
    icr, _, jicr, *_ = problem
    rng = np.random.default_rng(9)
    mean = [rng.normal(size=s).astype(np.float32) for s in jicr.xi_shapes()]
    theta = {"rho": np.float32(10.0), "sigma": np.float32(1.0)}
    post = posterior_to_torch(icr, mean, theta=theta)
    assert post.theta["rho"].dtype == torch.float32
    for a, b in zip(post.mean, mean):
        np.testing.assert_array_equal(a.numpy(), b)
    got = post.sample_fields(None, 2)
    want = icr.apply_sqrt(icr.matrices({"rho": 10.0, "sigma": 1.0}),
                          post.mean)
    assert got.shape == (2,) + icr.out_shape
    torch.testing.assert_close(got[1], want)


def test_priors_pushforward():
    assert float(lognormal_prior(3.0, 1.0)(torch.zeros(()))) > 0
    assert np.isclose(float(normal_prior(2.0, 0.5)(torch.zeros(()))), 2.0)
    u = uniform_prior(1.0, 3.0)
    assert 1.0 < float(u(torch.zeros(()))) < 3.0
    assert np.isclose(float(u(torch.tensor(-8.0))), 1.0, atol=1e-3)
    x = np.linspace(-3, 3, 13).astype(np.float32)
    for tp, jp in [(lognormal_prior(3.0, 1.0), jstd.lognormal_prior(3.0, 1.0)),
                   (normal_prior(2.0, 0.5), jstd.normal_prior(2.0, 0.5)),
                   (uniform_prior(1.0, 3.0), jstd.uniform_prior(1.0, 3.0))]:
        np.testing.assert_allclose(tp(torch.tensor(x)).numpy(),
                                   np.asarray(jp(jnp.asarray(x))), rtol=1e-5)
    model = StandardizedModel({"rho": lognormal_prior(3.0, 1.0)})
    xi = model.init_xi(torch.Generator().manual_seed(0))
    assert set(xi) == {"rho"} and abs(float(xi["rho"])) < 1.0


def test_adamw_matches_reference():
    """The same update rule step for step: warm-up from lr(0) = 0, global
    norm clipping at 1.0, float32 moments."""
    rng = np.random.default_rng(11)
    params = [rng.normal(size=(5,)).astype(np.float32),
              rng.normal(size=(2, 3)).astype(np.float32)]
    grads = [[3 * rng.normal(size=p.shape).astype(np.float32)
              for p in params] for _ in range(6)]
    jopt = jadamw(jschedule(0.1, 2, 6))
    jp = [jnp.asarray(p) for p in params]
    st = jopt.init(jp)
    opt = adamw(linear_warmup_cosine(0.1, 2, 6))
    tp = [torch.tensor(p) for p in params]
    for g in grads:
        jp, st = jopt.update([jnp.asarray(x) for x in g], st, jp)
        opt.update([torch.tensor(x) for x in g], tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    # the port's schedule is host float64, the JAX package's float32
    np.testing.assert_allclose(
        [linear_warmup_cosine(0.1, 2, 6)(s) for s in range(8)],
        np.asarray([jschedule(0.1, 2, 6)(s) for s in range(8)]), rtol=1e-6)


def test_charted_gp_dataset(problem):
    icr = problem[0]
    truth, obs_idx, y = charted_gp_dataset(
        icr, torch.Generator().manual_seed(2), obs_frac=0.3, noise_std=0.05)
    n = icr.chart.size
    assert truth.shape == (n,) and y.dtype == torch.float32
    assert obs_idx.shape == (int(n * 0.3),) == y.shape
    assert bool(torch.all(obs_idx[1:] > obs_idx[:-1]))
    resid = (y - truth[obs_idx]).numpy()
    assert 0.02 < resid.std() < 0.1
