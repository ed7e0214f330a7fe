"""The port's compiled paths and the default conditioning rtol, on the CPU,
held against the JAX package and against the loops they replace.

On a CUDA device the fit step, the transpose and a CG segment are
captured CUDA graphs (``core/graphs.capture``); on CPU tensors the same
code runs eagerly, so these tests hold that code's arithmetic and
control flow, and ``tests/test_torch_cuda.py`` holds graph against eager
on the card:

* AdamW with its step count, schedule and bias corrections on the device
  against the JAX package's ``adamw``, step for step (rtol 1e-6: both in
  float32, the sums in other orders);
* ``map_fit(jit=True)`` against ``jit=False`` bit for bit and against the
  JAX package's ``map_fit`` (first loss at 1e-5, the last of 30 steps at
  1e-3: per-step gradients agree to 1e-5 and 30 float32 steps compound);
  ADVI compiled against eager bit for bit;
* the fit's capture branch through a stub of ``capture`` that fails
  where the card's capture fails (an op that syncs with the host): the
  warm-up is the real step 0, a learned-θ forward (MAP and ADVI, the
  matrices rebuilt in the step) captures and equals ``jit=False`` bit for
  bit, and a joint N-D build whose families exceed 32 points raises,
  naming their size;
* the static-carry segment loop against the dict-carry loop it replaced,
  bit for bit, and against the JAX package's ``pcg_iterate``;
* the default config, whose bar rises to the matvec's rounding at the
  solution and refuses x = 0, and the level-0 preconditioner's byte
  bound.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ICR as JICR
from repro.core import charts as jcharts
from repro.core import kernels as jkernels
from repro.core import vi as jvi
from repro.optim import adamw as jadamw
from repro.optim import linear_warmup_cosine as jschedule
from repro.solvers import pcg as jpcg
from repro_torch import (ICR, Chart, StandardizedModel, advi_fit,
                         cg_posterior, gaussian_log_likelihood,
                         lognormal_prior, map_fit, matern32, per_draw,
                         regular_chart)
from repro_torch.convert import matrices_to_torch
from repro_torch.core import graphs
from repro_torch.kernels.policy import cast_tree, tree_leaves
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.solvers import (CGConfig, build_condition_system,
                                 gp_system, jacobi_precond, obs_operator,
                                 pcg, pcg_iterate)
from repro_torch.solvers.reports import CONVERGED, STALLED

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)


def _same_bits(a, b) -> bool:
    a, b = tree_leaves(a), tree_leaves(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


# -- AdamW on the device ---------------------------------------------------------------
def test_device_step_adamw_matches_reference():
    """The step count is an int32 tensor, the schedule and the bias
    corrections torch ops of it: the same update as the JAX package's,
    step for step, the schedule at tensor steps equal to its own."""
    rng = np.random.default_rng(11)
    params = [rng.normal(size=(5,)).astype(np.float32),
              rng.normal(size=(2, 3)).astype(np.float32)]
    grads = [[3 * rng.normal(size=p.shape).astype(np.float32)
              for p in params] for _ in range(8)]
    jopt = jadamw(jschedule(0.1, 3, 8))
    jp = [jnp.asarray(p) for p in params]
    st = jopt.init(jp)
    opt = adamw(linear_warmup_cosine(0.1, 3, 8))
    tp = [torch.tensor(p) for p in params]
    for i, g in enumerate(grads):
        jp, st = jopt.update([jnp.asarray(x) for x in g], st, jp)
        opt.update([torch.tensor(x) for x in g], tp)
        assert opt.step.dtype == torch.int32 and int(opt.step) == i + 1
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    steps = torch.arange(10, dtype=torch.int32)
    got = linear_warmup_cosine(0.1, 3, 8)(steps)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jschedule(0.1, 3, 8)(jnp.arange(10))),
        rtol=1e-6)


# -- the fits ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def problem():
    """``tests/test_torch_vi.py``'s problem: a 64-point regular chart,
    every second point observed with noise 0.05, the JAX package's
    matrices handed across."""
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
    y = truth[obs_idx] + 0.05 * torch.tensor(
        rng.normal(size=obs_idx.shape), dtype=torch.float32)
    return icr, mats, jicr, jmats, obs_idx, y


def test_map_fit_jit_equals_eager_and_the_jax_package(problem):
    icr, mats, jicr, jmats, obs_idx, y = problem
    ll = gaussian_log_likelihood(0.05, obs_idx)
    runs = [map_fit(ll, lambda x: icr.apply_sqrt(mats, x), icr.zero_xi(), y,
                    steps=30, jit=jit) for jit in (True, False)]
    assert _same_bits(runs[0], runs[1])
    losses = runs[0][1]
    assert losses.shape == (30,) and losses.dtype == torch.float32
    jll = jvi.gaussian_log_likelihood(0.05, jnp.asarray(obs_idx.numpy()))
    _, jlosses = jvi.map_fit(jll, lambda x: jicr.apply_sqrt(jmats, x),
                             jicr.zero_xi(), jnp.asarray(y.numpy()),
                             steps=30, jit=True)
    np.testing.assert_allclose(float(losses[0]), float(jlosses[0]),
                               rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-3)
    def advi():
        return advi_fit(torch.Generator().manual_seed(3), ll,
                        lambda x: icr.apply_sqrt_batch(mats, x),
                        icr.zero_xi(), y, steps=8)

    compiled = advi()
    with graphs.eager():
        assert _same_bits(compiled, advi())


# the ops that sync with the host (or read host memory) in a captured
# region on the card
_SYNCING = [(torch.linalg, "eigh"), (torch.linalg, "solve"),
            (torch.linalg, "cholesky"), (torch.Tensor, "item"),
            (torch.Tensor, "cpu"), (torch.Tensor, "tolist")]


def _syncing_capture(fn, *buffers, device):
    """``graphs.capture`` as the card behaves, on the CPU: the eager
    warm-up runs (the fit's step 0); a call that reaches an op that syncs
    with the host (``_SYNCING``, or a tensor made from a numpy array on a
    non-CPU device) fails to capture there, as the card's capture fails;
    otherwise each replay is one more call."""
    saved = [(owner, name, getattr(owner, name)) for owner, name in _SYNCING]

    def fail(what):
        raise RuntimeError(f"CUDA error: operation not permitted when "
                           f"stream is capturing ({what})")

    for owner, name, _ in saved:
        setattr(owner, name, lambda *a, _n=name, **k: fail(_n))
    makers = [(name, getattr(torch, name)) for name in ("as_tensor",
                                                        "tensor")]

    def maker(real, name):
        def make(data, *a, **k):
            if (isinstance(data, np.ndarray) and k.get("device") is not None
                    and torch.device(k["device"]).type != "cpu"):
                fail(f"torch.{name} of a numpy array")
            return real(data, *a, **k)
        return make

    for name, real in makers:
        setattr(torch, name, maker(real, name))
    try:
        fn(*buffers)
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)
        for name, real in makers:
            setattr(torch, name, real)

    def replay(*new):
        return fn(*buffers)

    replay.graph, replay.launches = "stub", collections.Counter()
    return replay


def test_fit_capture_branch_and_learned_theta(problem, monkeypatch):
    """Through the stub: a fixed-θ fit equals ``jit=False`` bit for bit
    (the warm-up is step 0, not a step lost); a learned-θ forward syncs
    with nothing, so its MAP fit and its ADVI fit (one build per draw)
    capture and equal their eager twins bit for bit; a plain-route joint
    3-D build, whose 64-point families take torch.linalg, raises and
    names the size."""
    icr, mats, *_, obs_idx, y = problem
    ll = gaussian_log_likelihood(0.05, obs_idx)
    eager = map_fit(ll, lambda x: icr.apply_sqrt(mats, x), icr.zero_xi(), y,
                    steps=12, jit=False)
    monkeypatch.setattr(graphs, "capture", _syncing_capture)
    got = map_fit(ll, lambda x: icr.apply_sqrt(mats, x), icr.zero_xi(), y,
                  steps=12)
    assert _same_bits(got, eager)
    priors = StandardizedModel({"rho": lognormal_prior(8.0, 4.0)})

    def fwd(latent, icr=icr):
        theta = dict(priors(latent[1]))
        theta["sigma"] = 1.0
        return icr(latent[0], theta)

    latent0 = (icr.zero_xi(), priors.zero_xi(device="cpu"))
    compiled = map_fit(ll, fwd, latent0, y, steps=4)
    assert _same_bits(compiled, map_fit(ll, fwd, latent0, y, steps=4,
                                        jit=False))

    def advi():
        return advi_fit(torch.Generator().manual_seed(5), ll, per_draw(fwd),
                        latent0, y, steps=3)

    compiled = advi()
    with graphs.eager():
        assert _same_bits(compiled, advi())

    # 27 level-0 points and a 27-point K_cc take the Jacobi; D is 64×64
    joint = ICR(Chart(shape0=(3, 3, 3), n_levels=1, n_csz=3, n_fsz=4),
                matern32.with_defaults(rho=2.0), device="cpu")
    y3 = torch.zeros(64)
    with pytest.raises(RuntimeError, match="64×64"):
        map_fit(gaussian_log_likelihood(0.05), lambda x: fwd(x, joint),
                (joint.zero_xi(), latent0[1]), y3, steps=2)


# -- the CG segment loop ------------------------------------------------------------------
def _spd_system(n=40, k=4, seed=0, cond=200.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = ((q * np.geomspace(1.0, cond, n)) @ q.T).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    b[2] = 0.0          # a zero column converges at iteration 0
    return a, b


def _dict_loop_solve(matvec, b, precond, cfg, segment):
    """The loop the static carry replaced: a fresh carry dict per
    iteration, the statuses read every `segment` iterations."""
    carry = pcg._pcg_init(matvec, b, precond, cfg)
    body = pcg._pcg_body(matvec, precond, cfg)
    again = True
    while again:
        while True:
            it, live = pcg._poll(carry)
            if not live or it >= cfg.max_iters:
                break
            for _ in range(min(segment, cfg.max_iters - it)):
                carry = body(carry)
        carry, again = pcg._settle(matvec, precond, carry,
                                   it < cfg.max_iters)
    carry = pcg._finalize(carry)
    return carry["x"], pcg._stats(carry)


# (segment, max_iters, preconditioned): a full segment, a remainder past
# the iteration budget, one iteration per poll
SEGMENT_CASES = {"seg4": (4, 300, False), "seg3-budget": (3, 22, True),
                 "seg1": (1, 300, True)}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_static_carry_segments_equal_the_dict_loop_and_jax(case):
    segment, max_iters, pre = SEGMENT_CASES[case]
    a, b = _spd_system()
    at = torch.tensor(a)

    def matvec(v):
        return v @ at.T

    precond = jacobi_precond(torch.diagonal(at).clone()) if pre else None
    cfg = CGConfig(rtol=1e-5, max_iters=max_iters)
    cache = {}
    x, stats, _ = pcg_iterate(matvec, torch.tensor(b), precond=precond,
                              cfg=cfg, segment=segment, segment_graphs=cache)
    assert len(cache) == 1
    x_ref, stats_ref = _dict_loop_solve(matvec, torch.tensor(b), precond, cfg,
                                        segment)
    assert torch.equal(x, x_ref)
    for key in ("status", "iters", "relres", "it"):
        assert torch.equal(stats[key], stats_ref[key]), key
    # the cache is re-used: a second solve captures nothing new and
    # returns copies, not the static buffers
    x2, _, _ = pcg_iterate(matvec, torch.tensor(b), precond=precond, cfg=cfg,
                           segment=segment, segment_graphs=cache)
    assert len(cache) == 1 and torch.equal(x2, x) and x2 is not x
    if pre:
        return
    jx, jstats, _ = jpcg.pcg_iterate(lambda v: v @ jnp.asarray(a).T,
                                     jnp.asarray(b),
                                     cfg=jpcg.CGConfig(rtol=1e-5,
                                                       max_iters=max_iters))
    assert (stats["status"] == CONVERGED).all()
    assert np.all(np.abs(stats["iters"].numpy()
                         - np.asarray(jstats["iters"])) <= 1)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-4)


# -- the default rtol --------------------------------------------------------------------
@pytest.fixture(scope="module")
def conditioned():
    """A 1,024-point regular chart on the kernel route (the plain versions
    on the CPU), 256 on-grid observations of a prior draw, σ = 0.25; the
    same system on float64 matrices (the float32 ones cast) through the
    plain route."""
    chart = regular_chart(64, 4, boundary="reflect")
    kernel = matern32.with_defaults(rho=0.04 * chart.size)
    icr = ICR(chart, kernel, use_pallas=True, device="cpu")
    mats = icr.matrices()
    gen = torch.Generator().manual_seed(31)
    truth = icr.apply_sqrt(mats, icr.init_xi(gen)).reshape(-1)
    obs = torch.sort(torch.randperm(chart.size, generator=gen)[:256]).values
    y = truth[obs] + 0.25 * torch.randn(256, generator=gen)
    op = obs_operator(icr, obs_idx=obs.numpy())
    plain = ICR(chart, kernel, use_pallas=False, device="cpu")
    sys64 = build_condition_system(plain, op, 0.0625,
                                   mats=cast_tree(mats, torch.float64),
                                   use_precond=False)
    return icr, mats, op, y, sys64


def test_default_rtol_answers_where_1e7_stalls(conditioned):
    """rtol 1e-7 (the JAX package's default) is under float32's floor of
    this system: without the dense rung every CG rung ends stalled. The
    default config (rtol 1e-7, the bar rising to the matvec's rounding at
    each column's own iterate, capped) converges; its report states rtol,
    the cap and δ, the rounding at α; α's float64 residual on the same
    matrices is within 10·max(rtol, min(δ at α, cap)). The same bar
    refuses x = 0 and half the answer, which a bar taken at y relative to
    ‖y‖ would accept on a large system. Float64 matrices keep 1e-7."""
    icr, mats, op, y, sys64 = conditioned
    tight = CGConfig(rtol=1e-7, max_iters=4 * op.n_obs)
    _, rep = cg_posterior(icr, op, y, noise_std=0.25, config=tight,
                          dense_fallback=False)
    assert not rep.ok and set(rep.status) == {"stalled"}, rep.summary()
    assert rep.rtol == 1e-7 and rep.floor_cap == 0.0 and rep.delta > 0
    sol = {}
    _, rep = cg_posterior(icr, op, y, noise_std=0.25, dense_fallback=False,
                          _solution=sol)
    assert rep.ok and rep.status == ("converged",), rep.summary()
    cap = gp_system.DEFAULT_FLOOR_CAP
    assert rep.rtol == 1e-7 and rep.floor_cap == cap and 0 < rep.delta < cap
    assert rep.summary()["delta"] == rep.delta
    alpha, system, cfg = sol["alpha"], sol["system"], sol["cfg"]
    ny = float(y.double().norm())
    res = float((y.double() - sys64.matvec(alpha.double())).norm()) / ny
    delta = float(pcg.matvec_rounding(system.matvec, alpha)[0]) / ny
    assert res <= 10 * max(rep.rtol, min(delta, cap))
    # x = 0 (no rounding at all) and half the answer end stalled
    for x in (torch.zeros_like(alpha), 0.5 * alpha):
        carry = pcg._pcg_init(system.matvec, y[None], None, cfg, x0=x)
        carry["status"] = torch.full_like(carry["status"], STALLED)
        carry, _ = pcg._settle(system.matvec, None, carry, False,
                               cfg.floor_cap)
        assert int(carry["status"][0]) == STALLED
    assert sys64.default_config() == CGConfig(
        rtol=1e-7, max_iters=max(4 * op.n_obs, 200), floor_cap=0.0)


def test_level0_preconditioner_is_bounded_by_bytes(conditioned,
                                                  monkeypatch):
    """Level 0 larger than ``max_basis``: the JAX package has no
    preconditioner there; the port takes level 0 alone while U fits
    ``PRECOND_MAX_BYTES`` (the same Woodbury as at ``max_basis`` = level
    0) and returns None above it."""
    icr, mats, op, y, _ = conditioned
    level0 = icr.xi_shapes()[0][0]
    want = gp_system.icr_whitening_precond(icr, mats, op, 0.0625,
                                           max_basis=level0)
    got = gp_system.icr_whitening_precond(icr, mats, op, 0.0625,
                                          max_basis=level0 - 1)
    r = y[None].repeat(2, 1)
    assert torch.equal(got(r), want(r))
    assert got.nbytes == (op.n_obs * level0 + level0 ** 2) * 8
    monkeypatch.setattr(gp_system, "PRECOND_MAX_BYTES",
                        op.n_obs * level0 * 8 - 1)
    assert gp_system.icr_whitening_precond(
        icr, mats, op, 0.0625, max_basis=level0 - 1) is None

