"""The port's exact GP reference (``core/exact.py``), its KISS-GP baseline
(``core/kissgp.py``) and its checkpointer, held to the JAX package's on
the CPU.

* ``exact``: every function at float64 (the JAX package under x64) to
  1e-10 relative, on the quickstart's log chart and ρ.
* ``KissGP``: ``dense_cov``, ``matvec`` and ``solve`` at float32 to 1e-5
  of the JAX package's; ``logdet_slq`` within its Monte Carlo error of
  the dense log-determinant (the probes come from a ``torch.Generator``,
  so its draws are not the JAX package's).
* The checkpointer: round trip of every leaf kind and dtype, atomic
  publish, async saves with retention, restore of a given step.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KissGP as JKissGP
from repro.core import charts as jcharts
from repro.core import exact as jexact
from repro.core import kernels as jkernels
from repro_torch import (KissGP, cov_errors, exact_cov, exact_posterior,
                         exact_sample, gauss_kl)
from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                    save_pytree)
from repro_torch.core import charts as tcharts
from repro_torch.core import kernels as tkernels

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _log_chart(m):
    """The quickstart's chart: log-spaced points (paper §5)."""
    return m.log_chart(11, 5, n_csz=5, n_fsz=4, delta0=0.0197)


# the quickstart's ρ, the largest nearest-neighbour spacing (0.0007): K's
# condition number is 11, so two LAPACKs' Cholesky factors agree to 1e-10
# (at ρ = 2 it is 9e12, and they differ by 6e-9)
RHO = float(np.diff(_log_chart(tcharts).grid_positions(
    5, device="cpu", dtype=torch.float64)[:, 0].numpy()).max())


# -- exact GP, float64 -------------------------------------------------------------
@pytest.fixture(scope="module")
def exact64():
    """The JAX package's exact-GP outputs under x64, and their inputs."""
    rng = np.random.default_rng(0)
    with jax.enable_x64(True):
        chart = _log_chart(jcharts)
        kfn = jkernels.matern32.with_defaults(rho=RHO)()
        cov = jexact.exact_cov(chart, kfn)
        cov_c = jexact.exact_cov(chart, kfn, level=2)
        n = cov.shape[0]
        approx = cov + 1e-3 * jnp.asarray(rng.standard_normal((n, n)))
        approx = 0.5 * (approx + approx.T)
        key = jax.random.PRNGKey(3)
        normals = jax.random.normal(key, (n,), jnp.float64)
        obs = np.sort(rng.choice(n, size=n // 3, replace=False))
        y = rng.standard_normal(obs.size)
        out = {
            "cov": cov, "cov_c": cov_c, "sample": jexact.exact_sample(key, cov),
            "errors": jexact.cov_errors(approx, cov),
            "kl": jexact.gauss_kl(cov, cov + 1e-2 * jnp.eye(n)),
            "posterior": jexact.exact_posterior(cov, jnp.asarray(obs),
                                                jnp.asarray(y), 0.01),
        }
        out = jax.tree.map(np.asarray, out)
    assert out["cov"].dtype == np.float64
    return out, dict(approx=np.asarray(approx), normals=np.asarray(normals),
                     obs=obs, y=y)


def test_exact_cov_and_sample_match_float64(exact64):
    want, inp = exact64
    chart = _log_chart(tcharts)
    kfn = tkernels.matern32.with_defaults(rho=RHO)()
    cov = exact_cov(chart, kfn, device="cpu", dtype=torch.float64)
    assert cov.dtype == torch.float64
    assert rel(cov.numpy(), want["cov"]) <= 1e-10
    cov_c = exact_cov(chart, kfn, level=2, device="cpu",
                      dtype=torch.float64)
    assert rel(cov_c.numpy(), want["cov_c"]) <= 1e-10
    s = exact_sample(cov, normals=torch.tensor(inp["normals"]))
    assert rel(s.numpy(), want["sample"]) <= 1e-10
    # from a generator: seeded, and distributed as N(0, cov)
    gen = torch.Generator().manual_seed(0)
    a, b = exact_sample(cov, gen), exact_sample(cov, gen)
    assert not torch.equal(a, b) and torch.isfinite(a).all()


def test_cov_errors_kl_and_posterior_match_float64(exact64):
    want, inp = exact64
    chart = _log_chart(tcharts)
    cov = exact_cov(chart, tkernels.matern32.with_defaults(rho=RHO)(),
                    device="cpu", dtype=torch.float64)
    errs = cov_errors(torch.tensor(inp["approx"]), cov)
    assert set(errs) == set(want["errors"])
    for k, v in errs.items():
        assert rel(v.numpy(), want["errors"][k]) <= 1e-10, k
    n = cov.shape[0]
    kl = gauss_kl(cov, cov + 1e-2 * torch.eye(n, dtype=cov.dtype))
    assert rel(kl.numpy(), want["kl"]) <= 1e-10
    mean, post = exact_posterior(cov, inp["obs"], torch.tensor(inp["y"]),
                                 0.01)
    assert rel(mean.numpy(), want["posterior"][0]) <= 1e-10
    assert rel(post.numpy(), want["posterior"][1]) <= 1e-10


# -- KISS-GP, float32 ---------------------------------------------------------------
def _kiss_pair(n=128, jitter=1e-1, rho=1.0):
    xs = np.sort(np.random.default_rng(0).uniform(0, 10, n))
    jk = JKissGP(x=xs, kernel_fn=jkernels.matern32.with_defaults(rho=rho)(),
                 jitter=jitter)
    tk = KissGP(x=xs, kernel_fn=tkernels.matern32.with_defaults(rho=rho)(),
                jitter=jitter, device="cpu")
    return jk, tk


def test_kissgp_operators_match_the_jax_package():
    jk, tk = _kiss_pair()
    assert tk.mp == jk.mp and tk.xi_size == jk.xi_size
    assert rel(tk.spectrum().numpy(), np.asarray(jk.spectrum())) <= 1e-5
    assert rel(tk.dense_cov().numpy(), np.asarray(jk.dense_cov())) <= 1e-5
    rng = np.random.default_rng(1)
    v = rng.standard_normal(tk.n).astype(np.float32)
    assert rel(tk.matvec(torch.tensor(v)).numpy(),
               np.asarray(jk.matvec(jnp.asarray(v)))) <= 1e-5
    # a batch along the leading axis is the vectors one by one
    vb = rng.standard_normal((3, tk.n)).astype(np.float32)
    torch.testing.assert_close(
        tk.matvec(torch.tensor(vb)),
        torch.stack([tk.matvec(torch.tensor(r)) for r in vb]))
    # the generative sqrt against its formula at float64 on the same
    # spectrum (the two packages' float32 FFTs differ by 1.0e-5 here)
    xi = rng.standard_normal(tk.xi_size).astype(np.float32)
    p = tk.spectrum().double().numpy()
    u = np.fft.irfft(np.sqrt(p) * xi, n=tk.mp) * np.sqrt(tk.mp)
    idx, wl, wr = (a.double().numpy() if a.is_floating_point() else a.numpy()
                   for a in tk.interp_weights())
    assert rel(tk.apply_sqrt(torch.tensor(xi)).numpy(),
               wl * u[idx] + wr * u[idx + 1]) <= 1e-5


def test_kissgp_solve_matches_the_jax_package():
    jk, tk = _kiss_pair()
    y = np.random.default_rng(1).normal(size=tk.n).astype(np.float32)
    jx, jstats = jk.solve(jnp.asarray(y), rtol=1e-4, max_iters=200)
    x, stats = tk.solve(torch.tensor(y), rtol=1e-4, max_iters=200)
    assert int(stats["status"]) == int(jstats["status"]) == 1  # converged
    assert abs(int(stats["iters"]) - int(jstats["iters"])) <= 1
    assert rel(x.numpy(), np.asarray(jx)) <= 1e-5
    with pytest.warns(DeprecationWarning, match="solve_cg is deprecated"):
        x_shim = tk.solve_cg(torch.tensor(y), 40)
    assert torch.equal(x_shim, tk.solve(torch.tensor(y), max_iters=40)[0])


@pytest.mark.parametrize("case", ["matern", "rank-one"])
def test_kissgp_logdet_slq_within_its_monte_carlo_error(case):
    """Against the dense log-determinant: within 20 % (30 probes × 20
    Lanczos steps, the JAX test's bound) on a Matérn kernel, and 5 % on a
    constant kernel whose Lanczos recurrence breaks down."""
    xs = np.sort(np.random.default_rng(0).uniform(0, 10, 64 if case ==
                                                  "matern" else 80))
    if case == "matern":
        kfn, jitter, probes, iters, bound = (
            tkernels.matern32.with_defaults(rho=0.5)(), 1e-1, 30, 20, 0.2)
    else:
        kfn, jitter, probes, iters, bound = (
            torch.ones_like, 1e-4, 10, 15, 0.05)
    kiss = KissGP(x=xs, kernel_fn=kfn, jitter=jitter, device="cpu")
    dense = kiss.dense_cov().double().numpy() + jitter * np.eye(len(xs))
    exact = float(np.linalg.slogdet(dense)[1])
    est = float(kiss.logdet_slq(torch.Generator().manual_seed(0),
                                probes=probes, lanczos_iters=iters))
    assert np.isfinite(est)
    assert abs(est - exact) / abs(exact) < bound
    sol, ld = kiss.forward_pass(torch.ones(len(xs)),
                                torch.Generator().manual_seed(1))
    assert torch.isfinite(sol).all() and np.isfinite(float(ld))


# -- the checkpointer ---------------------------------------------------------------
def _tree(scale=1.0):
    gen = torch.Generator().manual_seed(0)
    return {
        "layer": {"w": scale * torch.randn((8, 16), generator=gen),
                  "b": torch.full((16,), 0.5 * scale, dtype=torch.bfloat16)},
        "status": torch.arange(5, dtype=torch.int32),
        "it": torch.tensor(7, dtype=torch.int64),
        "nested": [np.ones(3), (2.0 * scale, 3)],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_same(got, want):
    assert type(got) is type(want)
    for a, b in zip(_leaves(got), _leaves(want)):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)


def test_checkpoint_round_trip_and_atomic_publish(tmp_path):
    save_pytree(_tree(), str(tmp_path / "ck"))
    assert not os.path.exists(str(tmp_path / "ck.tmp"))
    assert os.path.exists(str(tmp_path / "ck" / "manifest.json"))
    _assert_same(load_pytree(str(tmp_path / "ck"), _tree(0.0)), _tree())
    # a save that dies half-written leaves the published one intact
    os.makedirs(str(tmp_path / "ck.tmp"))
    mgr = CheckpointManager(str(tmp_path / "mgr"))
    mgr.save(1, _tree(), blocking=True)
    os.makedirs(str(tmp_path / "mgr" / "step_2.tmp"))
    assert mgr.steps() == [1] and mgr.latest_step() == 1
    with pytest.raises(TypeError):
        save_pytree({"bad": object()}, str(tmp_path / "bad"))


def test_checkpoint_manager_async_retention_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (10, 20, 30, 40):
        mgr.save(step, _tree(float(step)))
    mgr.wait()
    assert mgr.steps() == [30, 40]
    step, tree = mgr.restore(_tree(0.0))
    assert step == 40
    _assert_same(tree, _tree(40.0))
    step, tree = mgr.restore(_tree(0.0), step=30)
    assert step == 30
    _assert_same(tree, _tree(30.0))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_tree())
