"""The port's ``ICR`` held against the JAX package's, end to end.

* Whole slice: ``apply_sqrt_batch`` on the kernel route, fed the JAX
  package's matrices and numpy-seeded ξ, against the JAX package's
  ``ICR(use_pallas=True)`` with its pyramid prefix on. Tolerances are the
  JAX package's own: 1e-5 at float32, 5e-2 with bfloat16 storage
  (relative to the largest magnitude).
* Sign-free: ``implicit_cov`` from the port's own matrices against the
  JAX package's, at float32. The two build their matrices independently
  in float32, so the bound is 1e-4 relative (measured: <= 3e-5 on these
  charts); eigh's arbitrary column signs cancel in the covariance. At
  float64 (the JAX package under x64) both build in float64: 1e-10.
* ``ICRArchConfig.build``: the paper's configurations, cut to a small
  chart, build the JAX package's model (the same ``apply_sqrt_batch`` on
  the JAX package's matrices, 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ICR_ARCHS as JICR_ARCHS
from repro.core import ICR as JICR
from repro.core import charts as jcharts
from repro.core import kernels as jkernels
from repro_torch import ICR
from repro_torch.configs.registry import ICR_ARCHS
from repro_torch.convert import matrices_to_torch, xi_to_torch
from repro_torch.core import charts as tcharts
from repro_torch.core import kernels as tkernels

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

TOL = {None: 1e-5, "bf16": 5e-2}


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t2n(t):
    return t.detach().float().cpu().numpy()


# the three serving charts of the JAX package (launch/serve_gp.py,
# quick sizes) plus a charted 1-D chart, with their kernel scales
SLICE_CHARTS = {
    "tod": (lambda m: m.regular_chart(64, 3, boundary="reflect"), 8.0),
    "image": (lambda m: m.regular_chart((16, 16), 2, boundary="reflect"),
              4.0),
    "dust": (lambda m: m.galactic_dust_chart((6, 8, 8), n_levels=2), 0.5),
    "log": (lambda m: m.log_chart(12, 3, n_csz=5, n_fsz=4, delta0=0.05),
            0.3),
}


def _pair(name, pol, *, use_pallas=True):
    build_chart, rho = SLICE_CHARTS[name]
    jicr = JICR(build_chart(jcharts), jkernels.matern32.with_defaults(rho=rho),
                use_pallas=use_pallas, dtype_policy=pol)
    ticr = ICR(build_chart(tcharts), tkernels.matern32.with_defaults(rho=rho),
               use_pallas=use_pallas, dtype_policy=pol, device="cpu")
    return jicr, ticr


def _xi(jicr, n_s, seed=0):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.normal(size=(n_s,) + s), jicr.policy.storage_dtype)
            for s in jicr.xi_shapes()]


@pytest.mark.parametrize("pol", [None, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(SLICE_CHARTS))
def test_whole_slice_matches_reference(name, pol):
    jicr, ticr = _pair(name, pol)
    assert ticr.xi_shapes() == jicr.xi_shapes()
    mats = jax.jit(jicr.matrices)()
    xi = _xi(jicr, 3)
    want = jax.jit(jicr.apply_sqrt_batch)(mats, xi)
    got = ticr.apply_sqrt_batch(
        matrices_to_torch(jax.tree.map(np.asarray, mats), device="cpu"),
        xi_to_torch([np.asarray(x) for x in xi], device="cpu"))
    assert got.dtype == ticr.policy.storage_dtype
    assert tuple(got.shape) == tuple(want.shape) == (3,) + ticr.out_shape
    assert rel(t2n(got), np.asarray(want.astype(jnp.float32))) < TOL[pol]


def test_apply_sqrt_is_one_sample_of_the_batch():
    jicr, ticr = _pair("dust", None)
    mats = ticr.matrices()
    xi = xi_to_torch([np.asarray(x) for x in _xi(jicr, 2, seed=1)],
                     device="cpu")
    batch = ticr.apply_sqrt_batch(mats, xi)
    one = ticr.apply_sqrt(mats, [x[1] for x in xi])
    torch.testing.assert_close(one, batch[1], rtol=1e-6, atol=1e-6)


# (chart builder, rho): small 1-D, 2-D and 3-D charts; the 3-D radial
# spacing is 0.2 so that float32 builds agree to 1e-4 (see module doc)
COV_CHARTS = {
    "1d": (lambda m: m.regular_chart(16, 2, boundary="reflect"), 4.0),
    "2d": (lambda m: m.regular_chart((8, 8), 2), 3.0),
    "3d": (lambda m: m.galactic_dust_chart((6, 8, 8), 1, delta_logr=0.2),
           0.5),
}


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain-joint", "kernel-route"])
@pytest.mark.parametrize("name", sorted(COV_CHARTS))
def test_implicit_cov_matches_reference(name, use_pallas):
    """The sign-free end to end check (as tests/test_icr_math.py uses
    implicit_cov): joint matrices on the plain path, per-axis factors on
    the kernel route (the JAX package's pyramid is off there: its
    custom-VJP prefix has no forward-mode derivative)."""
    build_chart, rho = COV_CHARTS[name]
    jicr = JICR(build_chart(jcharts), jkernels.matern32.with_defaults(rho=rho),
                use_pallas=use_pallas, use_pyramid=False)
    ticr = ICR(build_chart(tcharts), tkernels.matern32.with_defaults(rho=rho),
               use_pallas=use_pallas, device="cpu")
    # jit: eager jacfwd dispatches the reference op by op (~10x slower)
    want = np.asarray(jax.jit(lambda: jicr.implicit_cov(
        dtype=jnp.float32))())
    got = ticr.implicit_cov()
    assert tuple(got.shape) == want.shape == (ticr.chart.size,) * 2
    assert rel(t2n(got), want) < 1e-4


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain-joint", "kernel-route"])
@pytest.mark.parametrize("name", sorted(COV_CHARTS))
def test_implicit_cov_float64_matches_reference(name, use_pallas):
    """At float64 the port builds its matrices in float64, as the JAX
    package does under x64: the two agree to 1e-10 relative (measured
    <= 1.7e-14; a float32 build left 2.1e-6 to 1.3e-5)."""
    build_chart, rho = COV_CHARTS[name]
    with jax.enable_x64(True):
        jicr = JICR(build_chart(jcharts),
                    jkernels.matern32.with_defaults(rho=rho),
                    use_pallas=use_pallas, use_pyramid=False)
        want = np.asarray(jax.jit(lambda: jicr.implicit_cov())())
    assert want.dtype == np.float64
    ticr = ICR(build_chart(tcharts), tkernels.matern32.with_defaults(rho=rho),
               use_pallas=use_pallas, device="cpu")
    got = ticr.implicit_cov(dtype=torch.float64)
    assert got.dtype == torch.float64
    assert rel(got.numpy(), want) < 1e-10


def test_plain_path_equals_kernel_route_on_1d():
    """On a 1-D chart both paths use the same joint matrices."""
    ticr = ICR(tcharts.log_chart(12, 3, n_csz=5, n_fsz=4, delta0=0.05),
               tkernels.matern32.with_defaults(rho=0.3), device="cpu")
    route = ICR(ticr.chart, ticr.kernel, use_pallas=True, device="cpu")
    mats = ticr.matrices()
    xi = ticr.init_xi(torch.Generator().manual_seed(0), batch=2)
    torch.testing.assert_close(route.apply_sqrt_batch(mats, xi),
                               ticr.apply_sqrt_batch(mats, xi),
                               rtol=1e-5, atol=1e-6)


def test_sample_batch_is_seeded_and_typed():
    icr = ICR(tcharts.galactic_dust_chart((6, 8, 8), 2),
              tkernels.matern32.with_defaults(rho=0.5), use_pallas=True,
              dtype_policy="bf16", device="cpu")
    a = icr.sample_batch(torch.Generator().manual_seed(3), 2)
    b = icr.sample_batch(torch.Generator().manual_seed(3), 2)
    assert a.dtype == torch.bfloat16
    assert tuple(a.shape) == (2,) + icr.out_shape
    assert bool(torch.isfinite(a.float()).all())
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    xi = icr.init_xi(torch.Generator().manual_seed(3), batch=2)
    assert [tuple(x.shape) for x in xi] == [(2,) + s
                                            for s in icr.xi_shapes()]
    assert all(x.dtype == torch.bfloat16 for x in xi)
    assert icr.xi_size() == sum(int(np.prod(s)) for s in icr.xi_shapes())
    assert all(float(z.abs().max()) == 0 for z in icr.zero_xi())


def test_matrices_cached_keys_on_theta():
    icr = ICR(tcharts.regular_chart(16, 2), tkernels.matern32, device="cpu")
    a = icr.matrices_cached({"rho": 2.0})
    assert icr.matrices_cached({"rho": 2.0}) is a
    assert icr.matrices_cached({"rho": torch.tensor(3.0)}) is not a
    assert icr.matrices_cache_stats == {"hits": 1, "misses": 2}


def test_n_d_kernel_route_builds_only_axis_factors():
    icr = ICR(tcharts.galactic_dust_chart((6, 8, 8), 1),
              tkernels.matern32.with_defaults(rho=0.5), use_pallas=True,
              device="cpu")
    assert set(icr.matrices()) == {"sqrt0", "Rax", "sqrtDax"}
    assert set(ICR(icr.chart, icr.kernel, device="cpu").matrices()) == {
        "sqrt0", "R", "sqrtD"}


def test_defaults_target_the_card_and_refuse_the_pyramid():
    """The defaults: the card, and the pyramid prefix on, as in the JAX
    package (it was refused before the pyramid kernel was ported)."""
    c = tcharts.regular_chart(16, 2)
    assert ICR(c, tkernels.matern32).device == "cuda"
    assert ICR(c, tkernels.matern32).use_pyramid
    assert ICR(c, tkernels.matern32, use_pyramid=False).use_pyramid is False


@pytest.mark.parametrize("name,cut", [
    ("icr-log1d", dict(shape0=(12,), n_levels=3)),
    ("icr-dust-pod", dict(shape0=(6, 8, 8), n_levels=2)),
])
def test_icr_arch_config_builds_the_jax_model(name, cut):
    jicr = dataclasses.replace(JICR_ARCHS[name], **cut).build()
    ticr = dataclasses.replace(ICR_ARCHS[name], **cut).build(device="cpu")
    assert ticr.device == "cpu" and ticr.xi_shapes() == jicr.xi_shapes()
    mats = jax.jit(jicr.matrices)()
    xi = _xi(jicr, 2)
    want = jax.jit(jicr.apply_sqrt_batch)(mats, xi)
    got = ticr.apply_sqrt_batch(
        matrices_to_torch(jax.tree.map(np.asarray, mats), device="cpu"),
        xi_to_torch([np.asarray(x) for x in xi], device="cpu"))
    assert tuple(got.shape) == tuple(want.shape) == (2,) + ticr.out_shape
    assert rel(t2n(got), np.asarray(want)) < TOL[None]
