"""The port's GP field server (``repro_torch.launch.serve_gp``) held to
the JAX package's ``GPFieldServer``, on the CPU.

* Packing: a packed mixed batch equals a one-row-per-slab loop and a
  manual per-row reference through the port's documented (seed, row)
  draw, at 1e-5.
* Against the JAX server: requests carrying their own ξ on a MAP (delta)
  posterior serve the same fields and moments from both servers, at 1e-5
  (float32) and 5e-2 (bfloat16 storage), relative to the largest
  magnitude, with std 0. The port's server runs on the JAX package's
  matrices (``CarriedICR``): the two packages' square roots differ by
  eigh column signs and the port's symmetric roots (ROADMAP queue 3), as
  in the apply-path parity tests.
* Admission codes, the executable cache's hit and miss sequence, the
  plan cache, the level-traffic model against the JAX package's on every
  route both have, and the counter-based noise against a numpy uint32
  re-implementation.
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
from repro.core.refine import LevelGeom as JLevelGeom
from repro.core.vi import Posterior as JPosterior
from repro.distributed import fault as jfault
from repro.kernels import dispatch as jdispatch
from repro.launch import serve_gp as jserve
from repro.roofline.level_traffic import (
    refine_level_traffic as jrefine_level_traffic,
)
from repro_torch import ICR
from repro_torch.convert import matrices_to_torch, posterior_to_torch
from repro_torch.core import charts as tcharts
from repro_torch.core import graphs
from repro_torch.core import kernels as tkernels
from repro_torch.core.refine import LevelGeom
from repro_torch.core.vi import Posterior
from repro_torch.distributed import fault as tfault
from repro_torch.kernels import dispatch
from repro_torch.launch import serve_gp as sg
from repro_torch.roofline import refine_level_traffic

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

TOL = {None: 1e-5, "bf16": 5e-2}
CHART = tcharts.regular_chart(32, 3, boundary="reflect")  # 256 points, 1-D


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _posterior(theta=None, chart=CHART, dtype_policy=None, seed=0):
    """The JAX test's posterior on the port: matern32, θ={"rho": 8.0} by
    default, log_std -1."""
    icr = ICR(chart, tkernels.matern32, use_pallas=True,
              dtype_policy=dtype_policy, device="cpu")
    theta = {"rho": 8.0} if theta is None else theta
    gen = torch.Generator().manual_seed(seed)
    mean = icr.init_xi(gen, dtype=torch.float32)
    return Posterior(icr=icr, mean=mean,
                     log_std=[torch.full_like(m, -1.0) for m in mean],
                     theta=theta)


def _jposterior(theta=None, chart=None, dtype_policy=None, seed=0):
    chart = jcharts.regular_chart(32, 3, boundary="reflect") \
        if chart is None else chart
    icr = JICR(chart=chart, kernel=jkernels.matern32, use_pallas=True,
               dtype_policy=dtype_policy)
    theta = {"rho": 8.0} if theta is None else theta
    mean = icr.init_xi(jax.random.PRNGKey(seed), dtype=jnp.float32)
    return JPosterior(icr=icr, mean=mean,
                      log_std=[jnp.full_like(m, -1.0) for m in mean],
                      theta=theta)


# -- slab packing ----------------------------------------------------------------
def test_packed_batch_matches_per_row_loop_and_manual_draw():
    post = _posterior()
    reqs = lambda: [sg.GPRequest(kind="sample", n=3, seed=11),  # noqa: E731
                    sg.GPRequest(kind="moments", n=5, seed=12),
                    sg.GPRequest(kind="sample", n=2, seed=13)]
    packed, looped = reqs(), reqs()
    sg.GPFieldServer(post, slab=4).run(packed)
    sg.GPFieldServer(post, slab=1).run(looped)

    icr, mats = post.icr, post.matrices()
    counters = sg.noise_counters(icr.xi_size(), "cpu")
    mean = torch.cat([m.reshape(-1) for m in post.mean])
    std = torch.cat([s.reshape(-1) for s in post.std()])

    def row_field(seed, row):
        """The documented draw for one row, then sqrt(K) applied."""
        z = sg.row_normals(torch.tensor([seed]), torch.tensor([row]),
                           counters)[0]
        flat, xi, o = mean + std * z, [], 0
        for s in icr.xi_shapes():
            n = int(np.prod(s))
            xi.append(flat[o:o + n].reshape(s))
            o += n
        return icr.apply_sqrt(mats, xi).numpy()

    for p, lp in zip(packed, looped):
        assert p.done and lp.done and p.error is None
        if p.kind == "sample":
            assert len(p.fields) == p.n
            for row, (fp, fl) in enumerate(zip(p.fields, lp.fields)):
                np.testing.assert_allclose(fp, fl, rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(fp, row_field(p.seed, row),
                                           rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(p.mean, lp.mean, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(p.std, lp.std, rtol=1e-5, atol=1e-5)
            draws = np.stack([row_field(p.seed, r) for r in range(p.n)])
            np.testing.assert_allclose(p.mean, draws.mean(0), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(p.std, draws.std(0), rtol=1e-4,
                                       atol=1e-5)


def test_welford_moments_stream_across_slabs():
    post = _posterior()
    req = sg.GPRequest(kind="moments", n=13, seed=3)  # 13 rows, slab 4
    srv = sg.GPFieldServer(post, slab=4)
    srv.run([req])
    assert srv.slabs_run == 4
    sample = sg.GPRequest(kind="sample", n=13, seed=3)
    sg.GPFieldServer(post, slab=4).run([sample])
    draws = np.stack(sample.fields)
    np.testing.assert_allclose(req.mean, draws.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(req.std, draws.std(0), rtol=1e-5, atol=1e-6)


# -- against the JAX server --------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CarriedICR(ICR):
    """The port's ICR on matrices carried across from the JAX package."""

    carried: Any = None

    def matrices(self, theta=None, **kw):
        return self.carried


@dataclasses.dataclass(frozen=True)
class JitICR(JICR):
    """The JAX package's ICR with its matrices built under ``jax.jit``
    (built op by op, the dust chart's take ~12 s on the CPU)."""

    def matrices(self, theta=None, **kw):
        return jax.jit(lambda: JICR.matrices(self, theta, **kw))()


# (port chart, JAX chart, kernel ρ): the JAX test's chart and the JAX
# package's three serving scenarios at their quick sizes
SERVE_CHARTS = {
    "regular": (lambda: CHART,
                lambda: jcharts.regular_chart(32, 3, boundary="reflect"),
                8.0),
    **{name: (lambda name=name: sg.scenario_chart(name, quick=True),
              lambda name=name: jserve.scenario_chart(name, quick=True), rho)
       for name, rho in sg.SCENARIOS.items()},
}


def _map_pair(name, pol):
    """A MAP posterior of the JAX package and its port (ξ̂ from numpy),
    the port's ICR on the JAX package's matrices."""
    tchart, jchart, rho = (f() if callable(f) else f
                           for f in SERVE_CHARTS[name])
    jicr = JitICR(chart=jchart,
                  kernel=jkernels.matern32.with_defaults(rho=rho),
                  use_pallas=True, dtype_policy=pol)
    rng = np.random.default_rng(5)
    xi_hat = [rng.normal(size=s).astype(np.float32)
              for s in jicr.xi_shapes()]
    jpost = JPosterior(icr=jicr, mean=[jnp.asarray(x) for x in xi_hat])
    mats = matrices_to_torch(jax.tree.map(np.asarray, jicr.matrices_cached()),
                             device="cpu")
    ticr = CarriedICR(tchart, tkernels.matern32.with_defaults(rho=rho),
                      use_pallas=True, dtype_policy=pol, device="cpu",
                      carried=mats)
    assert ticr.xi_shapes() == jicr.xi_shapes()
    return jpost, posterior_to_torch(ticr, xi_hat, dtype=torch.float32)


def _client_requests(shapes, make):
    rng = np.random.default_rng(17)
    own = lambda: [rng.normal(size=s).astype(np.float32)  # noqa: E731
                   for s in shapes]
    return [make(kind="sample", n=2, seed=1, xi=own()),
            make(kind="moments", n=3, seed=2, xi=own()),
            make(kind="sample", n=1, seed=3),
            make(kind="moments", n=2, seed=4)]


@pytest.mark.parametrize("pol", [None, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(SERVE_CHARTS))
def test_fields_and_moments_match_the_jax_server(name, pol):
    jpost, tpost = _map_pair(name, pol)
    shapes = jpost.icr.xi_shapes()
    jreqs = _client_requests(shapes, jserve.GPRequest)
    treqs = _client_requests(shapes, sg.GPRequest)
    jserve.GPFieldServer(jpost, slab=4).run(jreqs)
    sg.GPFieldServer(tpost, slab=4).run(treqs)
    for j, t in zip(jreqs, treqs):
        assert j.error is None and t.error is None and t.done
        if t.kind == "sample":
            assert len(t.fields) == len(j.fields) == t.n
            for ft, fj in zip(t.fields, j.fields):
                assert ft.dtype == np.float32 and ft.shape == fj.shape
                assert rel(ft, fj) < TOL[pol]
        else:
            assert rel(t.mean, j.mean) < TOL[pol]
            np.testing.assert_allclose(t.std, 0.0, atol=1e-5)
            np.testing.assert_allclose(j.std, 0.0, atol=1e-5)


def test_map_posterior_moments_are_delta():
    icr = ICR(CHART, tkernels.matern32, use_pallas=True, device="cpu")
    xi_hat = icr.init_xi(torch.Generator().manual_seed(5),
                         dtype=torch.float32)
    post = Posterior(icr=icr, mean=xi_hat, theta={"rho": 8.0})
    req = sg.GPRequest(kind="moments", n=6, seed=1)
    sg.GPFieldServer(post, slab=4).run([req])
    want = icr.apply_sqrt(icr.matrices_cached(post.theta), xi_hat).numpy()
    np.testing.assert_allclose(req.mean, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(req.std, 0.0, atol=1e-5)


# -- admission ---------------------------------------------------------------------
ADMISSION = {
    "bad-kind": (dict(kind="quantiles", n=3), "bad-request"),
    "zero-n": (dict(kind="sample", n=0), "bad-request"),
    "seed-overflow": (dict(kind="sample", n=1, seed=2**31), "bad-request"),
    "theta-nonfinite": (dict(kind="sample", n=1, theta={"rho": np.nan}),
                        "theta-nonfinite"),
    "theta-mismatch": (dict(kind="sample", n=1, theta={"rho": 3.0}),
                       "theta-mismatch"),
    "xi-geometry": (dict(kind="sample", n=1, xi="short"), "xi-geometry"),
    "xi-nonfinite": (dict(kind="sample", n=1, xi="nan"), "xi-nonfinite"),
}


def _bad_request(make, case, shapes):
    kw, _ = ADMISSION[case]
    kw = dict(kw)
    if kw.get("xi") == "short":
        kw["xi"] = [np.zeros(s, np.float32) for s in shapes[:-1]]
    elif kw.get("xi") == "nan":
        kw["xi"] = [np.full(s, np.nan, np.float32) for s in shapes]
    return make(**kw)


@pytest.fixture(scope="module")
def servers():
    return (jserve.GPFieldServer(_jposterior(), slab=2),
            sg.GPFieldServer(_posterior(), slab=2))


@pytest.mark.parametrize("case", sorted(ADMISSION))
def test_admission_codes_match_the_jax_server(servers, case):
    jsrv, tsrv = servers
    shapes = tsrv.posterior.icr.xi_shapes()
    jreq = _bad_request(jserve.GPRequest, case, shapes)
    treq = _bad_request(sg.GPRequest, case, shapes)
    jsrv.run([jreq])
    tsrv.run([treq])
    assert treq.done and jreq.done
    assert treq.error.code == jreq.error.code == ADMISSION[case][1]
    assert tsrv.slabs_run == 0 and not treq.fields


def test_condition_is_served_beside_sample_traffic():
    """The solvers are ported: a condition request is no longer rejected
    but solved, beside a sample request (``test_torch_serve_condition``
    holds its answers to the JAX server's)."""
    srv = sg.GPFieldServer(_posterior(), slab=2)
    cond = sg.GPRequest(kind="condition", n=2, y=np.zeros(3),
                        obs_idx=np.arange(3))
    ok = sg.GPRequest(kind="sample", n=1)
    srv.run([cond, ok])
    assert cond.done and cond.error is None and cond.report.ok
    assert np.array_equal(cond.mean, np.zeros(CHART.final_shape))
    assert ok.error is None and len(ok.fields) == 1


# -- the executable cache ------------------------------------------------------------
def test_cache_hits_and_misses():
    """The JAX test's sequence on both servers: the same hit and miss
    counts after every step."""
    t0, j0 = _posterior(theta={"rho": 8.0}), _jposterior(theta={"rho": 8.0})
    tsrv = sg.GPFieldServer(t0, slab=4)
    jsrv = jserve.GPFieldServer(j0, slab=4)
    seq = []

    def both(do):
        do(tsrv, sg, _posterior, tcharts)
        do(jsrv, jserve, _jposterior, jcharts)
        counts = [(s.cache_misses, s.cache_hits) for s in (tsrv, jsrv)]
        assert counts[0] == counts[1]
        seq.append(counts[0])

    both(lambda s, m, p, c: None)
    both(lambda s, m, p, c: s.run(m.mixed_requests(2, 4)))
    both(lambda s, m, p, c: s.run(m.mixed_requests(2, 4)))
    both(lambda s, m, p, c: s.set_posterior(p(theta={"rho": 2.0})))
    both(lambda s, m, p, c: s.set_posterior(p(theta={"rho": 8.0}, seed=9)))
    both(lambda s, m, p, c: s.set_posterior(p(
        theta={"rho": 8.0},
        chart=c.regular_chart(64, 3, boundary="reflect"))))
    both(lambda s, m, p, c: s.set_posterior(p(theta={"rho": 8.0},
                                              dtype_policy="bf16")))
    assert seq == [(1, 0), (1, 1), (1, 2), (2, 2), (2, 3), (3, 3), (4, 3)]
    assert tsrv.graph_captures == 0  # the CPU runs each slab eagerly
    assert tsrv.metrics()["mode"] == "single:cpu-eager"


def test_kernel_defaults_are_part_of_the_cache_key():
    """θ baked into the kernel's defaults keys the cache: the same hit and
    miss counts as the JAX server, and the served field is the fresh
    server's, not the first entry's."""
    counts, fields = [], {}
    for m, charts in ((sg, tcharts), (jserve, jcharts)):
        chart = charts.regular_chart(32, 3, boundary="reflect")
        kw = {"device": "cpu"} if m is sg else {}
        srv = m.GPFieldServer(m.demo_posterior(chart, 8.0, **kw), slab=2)
        reqs = [m.GPRequest(kind="sample", n=1, seed=1) for _ in range(2)]
        srv.run(reqs[:1])
        srv.set_posterior(m.demo_posterior(chart, 0.5, **kw))
        srv.run(reqs[1:])
        counts.append((srv.cache_misses, srv.cache_hits))
        fields[m] = [r.fields[0] for r in reqs]
    assert counts[0] == counts[1] == (2, 2)

    req_a, req_b = fields[sg]
    fresh = sg.GPFieldServer(sg.demo_posterior(CHART, 0.5, device="cpu"),
                             slab=2)
    req_f = sg.GPRequest(kind="sample", n=1, seed=1)
    fresh.run([req_f])
    np.testing.assert_allclose(req_b, req_f.fields[0], rtol=1e-6, atol=1e-6)
    assert np.abs(req_b - req_a).max() > 0.1


def test_cache_hit_serves_the_new_q_parameters():
    """A hit after ``set_posterior`` with new q-parameters copies them into
    the entry's buffers: the new mean is served."""
    post = _posterior()
    srv = sg.GPFieldServer(post, slab=2)
    shifted = dataclasses.replace(post, mean=[m + 1.0 for m in post.mean],
                                  log_std=None)
    srv.set_posterior(shifted)
    assert (srv.cache_misses, srv.cache_hits) == (1, 1)
    req = sg.GPRequest(kind="moments", n=2, seed=4)
    srv.run([req])
    want = post.icr.apply_sqrt(post.matrices(), shifted.mean).numpy()
    np.testing.assert_allclose(req.mean, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(req.std, 0.0, atol=1e-5)


def test_warm_traffic_rebuilds_nothing():
    post = _posterior()
    srv = sg.GPFieldServer(post, slab=4)
    srv.run(sg.mixed_requests(2, 4))
    mats, plans = (dict(post.icr.matrices_cache_stats),
                   dict(dispatch.plan_cache_stats))
    srv.run(sg.mixed_requests(2, 4))
    assert dict(post.icr.matrices_cache_stats) == mats
    assert dict(dispatch.plan_cache_stats) == plans
    assert srv.modeled_slab_bytes() == sum(
        e["hbm_bytes"]["selected"] for e in dispatch.plan(
            CHART, pyramid=True, samples=4))
    assert srv.route == "pyramid"  # the cover takes all three levels
    fp = srv.cache_key_fingerprint()
    assert fp == sg.GPFieldServer(_posterior(seed=3),
                                  slab=4).cache_key_fingerprint()
    assert fp["device"] == "cpu" and len(fp["digest"]) == 16


def test_retry_replays_and_device_loss_propagates():
    post = _posterior()
    clean = sg.GPRequest(kind="sample", n=2, seed=6)
    sg.GPFieldServer(post, slab=2).run([clean])
    fails = iter([RuntimeError("transient")])

    def flaky(_srv):
        exc = next(fails, None)
        if exc is not None:
            raise exc

    srv = sg.GPFieldServer(
        post, slab=2, fault_injector=flaky,
        supervisor=tfault.ServingFaultSupervisor(
            retry=tfault.RetryPolicy(backoff_s=0.0)))
    req = sg.GPRequest(kind="sample", n=2, seed=6)
    srv.run([req])
    m = srv.metrics()
    assert (m["slabs_attempted"], m["slabs_run"]) == (2, 1)
    assert m["fault_transient_retries"] == 1
    np.testing.assert_array_equal(np.stack(req.fields),
                                  np.stack(clean.fields))

    def lost(_srv):
        raise tfault.DeviceLossError([0])

    srv = sg.GPFieldServer(post, slab=2, fault_injector=lost)
    with pytest.raises(tfault.DeviceLossError):
        srv.run([sg.GPRequest(kind="sample", n=1)])
    assert srv.metrics()["fault_device_losses"] == 1


def test_fault_copy_decides_as_the_jax_module():
    times = [1.0, 1.1, 0.9, 1.0, 1.05, 0.95, 1.0, 1.0, 5.0, 1.0, 9.0]
    tm, jm = tfault.StragglerMonitor(), jfault.StragglerMonitor()
    assert [tm.observe(t) for t in times] == [jm.observe(t) for t in times]
    assert tm.stragglers == jm.stragglers == 2
    assert tfault.RetryPolicy().backoff(3) == jfault.RetryPolicy().backoff(3)


def test_graph_helper_runs_eagerly_on_the_cpu():
    buf = torch.zeros(3)
    replay = graphs.capture(lambda x: x * 2.0, buf, device="cpu")
    assert replay.graph is None and not replay.launches
    np.testing.assert_array_equal(replay(torch.ones(3)).numpy(), [2.0] * 3)
    buf.fill_(4.0)
    np.testing.assert_array_equal(replay().numpy(), [8.0] * 3)


@pytest.mark.parametrize("symbol, want", [
    ("_ZN5repro27refine_1d_stationary_kernelIfLb1ELi2ELi3ELi4EEEvPKT_",
     "refine_stationary"),
    ("_ZN5repro27refine_1d_stationary_kernelI13__nv_bfloat16Lb0ELi4ELi5E"
     "Li2EEEv", "refine_stationary_nn"),
    ("_ZN5repro24refine_1d_charted_kernelIfLb1ELi4ELi5ELi1EEEv",
     "refine_charted"),
    ("_ZN5repro24refine_1d_charted_kernelIfLb0ELi2ELi3ELi2EEEv",
     "refine_charted_nn"),
    ("_ZN5repro31refine_1d_stationary_adj_kernelIfLb0ELi2ELi3ELi2EEEv",
     "refine_stationary_adjoint_nn"),
    ("_ZN5repro28refine_1d_charted_adj_kernelI13__nv_bfloat16Lb1ELi0ELi0E"
     "Li1EEEv", "refine_charted_adjoint"),
    ("_ZN5repro22refine_nd_fused_kernelIfLi4ELi5EEEvPKT_",
     "refine_nd_fused"),
    ("_ZN5repro21refine_pyramid_kernelI13__nv_bfloat16Lb0ELi2ELi3EEEvNS_9"
     "PyrParamsE", "refine_pyramid"),
    ("_Z16gemmSN_TN_kernelIfLi128ELi16ELi2ELi4ELi2ELi2ELb1E30cublasGemv",
     None),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_", None),
])
def test_graph_node_symbols_name_their_wrapper(symbol, want):
    """A graph node's kernel symbol maps to the launch counter of its
    wrapper, the 1-D kernels by their NOISE template argument; other
    kernels (cuBLAS, torch's) map to none."""
    assert graphs.wrapper_of_kernel(symbol) == want


def test_graph_node_symbol_without_noise_argument_raises():
    with pytest.raises(ValueError):
        graphs.wrapper_of_kernel("_ZN5repro24refine_1d_charted_kernelIfEEv")


# -- the plan ------------------------------------------------------------------
def test_plan_cached():
    dispatch.plan_cache_clear()
    p1 = dispatch.plan_cached(CHART, samples=4)
    p2 = dispatch.plan_cached(CHART, samples=4)
    assert p1 is p2
    assert dispatch.plan_cache_stats == {"hits": 1, "misses": 1}
    p3 = dispatch.plan_cached(CHART, samples=4, dtype="bfloat16")
    assert p3 is not p1 and p3[0]["dtype"] == "bfloat16"
    p4 = dispatch.plan_cached(CHART, samples=4, device="cpu")
    assert p4 is not p1
    assert dispatch.plan_cache_stats == {"hits": 1, "misses": 3}
    assert [dict(e) for e in p1] == [
        {**e, "vjp": tuple(e["vjp"])}
        for e in dispatch.plan(CHART, samples=4, pyramid=True)]
    with pytest.raises(TypeError):
        p1[0]["route"] = "other"
    with pytest.raises(TypeError):
        p1[0]["hbm_bytes"]["selected"] = 0


TRAFFIC_CHARTS = {
    **{name: (lambda m, name=name: (sg if m is tcharts else jserve)
              .scenario_chart(name, quick=True))
       for name in sg.SCENARIOS},
    "flagship": lambda m: m.galactic_dust_chart((8, 16, 16), 3),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(TRAFFIC_CHARTS))
def test_level_traffic_matches_the_jax_model(name, dtype):
    tchart = TRAFFIC_CHARTS[name](tcharts)
    jchart = TRAFFIC_CHARTS[name](jcharts)
    for lvl in range(tchart.n_levels):
        tg = LevelGeom.for_level(tchart, lvl)
        jg = JLevelGeom.for_level(jchart, lvl)
        routes = (["nd-fused", "nd-axes"] if tchart.ndim > 1
                  else [dispatch.route_for(tg)])
        for route in routes + ["pyramid"]:
            for first, last in ((True, True), (True, False),
                                (False, False), (False, True)):
                kw = dict(samples=8, dtype=dtype, first=first, last=last)
                got = refine_level_traffic(tg, route, **kw)
                want = jrefine_level_traffic(jg, route, **kw)
                assert got["total"] == want["total"], (lvl, route, kw)
                assert got["dtype"] == want["dtype"] == dtype
    # plan()'s column reads the same model at the selected route
    jplan = {e["level"]: e for e in jdispatch.plan(
        jchart, samples=8, dtype=dtype, pyramid=False)}
    for e in dispatch.plan(tchart, samples=8, dtype=dtype):
        assert e["dtype"] == dtype
        if jplan[e["level"]]["route"] == e["route"]:
            assert e["hbm_bytes"]["selected"] \
                == jplan[e["level"]]["hbm_bytes"][e["route"]]


# -- the noise -------------------------------------------------------------------
def _np_mix32(x):
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x2C1B3C6D)
    x = x ^ (x >> np.uint32(12))
    x = x * np.uint32(0x297A2D39)
    return x ^ (x >> np.uint32(15))


def _np_row_bits(seed, row, n):
    """The documented stream in numpy uint32 arithmetic (wrapping)."""
    with np.errstate(over="ignore"):
        k = _np_mix32(_np_mix32(np.uint32(seed)) ^ np.uint32(row))
        mul = (_np_mix32(k ^ np.uint32(0x9E3779B9))
               & np.uint32(0x7FFFFFFF)) | np.uint32(1)
        add = _np_mix32(k ^ np.uint32(0x85EBCA6B))
        p = np.arange(n, dtype=np.uint32)
        ctr = np.stack([2 * p, 2 * p + 1])
        return _np_mix32(ctr * mul + add)


def test_noise_matches_a_numpy_uint32_reimplementation():
    seeds = [0, 1, 7, 2**31 - 1, 123456]
    rows = [0, 3, 2**30, 17, 99999]
    n = 5000
    bits = sg.row_noise_bits(torch.tensor(seeds), torch.tensor(rows),
                             sg.noise_counters(n, "cpu"))
    want = np.stack([_np_row_bits(s, r, n) for s, r in zip(seeds, rows)])
    np.testing.assert_array_equal(bits.numpy(), want.astype(np.int64))
    u = ((want >> np.uint32(8)).astype(np.float64) + 1.0) * 2.0**-24
    z = np.sqrt(-2.0 * np.log(u[:, 0])) * np.cos(2.0 * np.pi * u[:, 1])
    got = sg.row_normals(torch.tensor(seeds), torch.tensor(rows),
                         sg.noise_counters(n, "cpu")).numpy()
    np.testing.assert_allclose(got, z, rtol=0, atol=1e-6)


def test_noise_moments():
    n = 10**5
    z = sg.row_normals(torch.tensor([42, 43]), torch.tensor([0, 0]),
                       sg.noise_counters(n // 2, "cpu")).double().reshape(-1)
    assert abs(float(z.mean())) < 5 / np.sqrt(n)
    assert abs(float(z.var(correction=0)) - 1.0) < 5 * np.sqrt(2.0 / n)
