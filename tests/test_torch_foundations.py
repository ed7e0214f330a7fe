"""The port's foundations held against the JAX package.

Dtypes and the dtype policy, the kernel zoo, chart geometry, the
refinement-matrix builders and the plain refinement step of
``repro_torch`` against ``repro`` on the same numpy-seeded inputs. Data
crosses between the packages as numpy arrays.

Tolerances (relative to the largest magnitude of the reference):
  * chart geometry: exact (both are the same float64 numpy arithmetic);
  * kernel matrices and charted positions: 1e-6 (float32 elementwise);
  * R and sqrtD·sqrtDᵀ, level-0 S·Sᵀ: 1e-4. Both packages solve and
    eigendecompose independently in float32, so the difference grows
    with the conditioning of K_cc; the charts below are sized so that
    neighbours sit within a few correlation lengths, and they use the
    shrink boundary: a reflect boundary repeats window points at the
    edge, K_cc there is singular up to the jitter (condition ~4e6), and
    two float32 builds differ by several percent in R, each as far from
    a float64 solve as the other. So do the builds on the flagship dust
    chart's radial axis (spacing 0.02 at rho 0.5): that is float32, not
    the port;
    sqrtD itself is compared through sqrtD·sqrtDᵀ: the port's is the
    symmetric root V sqrt(Λ) Vᵀ, the JAX package's V sqrt(Λ), whose
    columns have arbitrary signs;
  * the plain refinement step on the JAX package's matrices: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import charts as jcharts
from repro.core import kernels as jkernels
from repro.core import refine as jrefine
from repro_torch import dtypes
from repro_torch.convert import matrices_to_torch, to_torch, xi_to_torch
from repro_torch.core import charts as tcharts
from repro_torch.core import kernels as tkernels
from repro_torch.core import refine as trefine
from repro_torch.kernels import policy

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t2n(t):
    return t.detach().float().cpu().numpy()


# (name, builder) pairs: the builder takes the chart module of a package
CHARTS = {
    "regular-1d-shrink": lambda m: m.regular_chart(16, 3),
    "regular-1d-reflect": lambda m: m.regular_chart(64, 3,
                                                    boundary="reflect"),
    "regular-1d-5x4": lambda m: m.regular_chart(20, 2, n_csz=5, n_fsz=4),
    "log-1d": lambda m: m.log_chart(12, 3, n_csz=5, n_fsz=4, delta0=0.05),
    "regular-2d-shrink": lambda m: m.regular_chart((12, 10), 2),
    "regular-2d-reflect": lambda m: m.regular_chart((16, 16), 2,
                                                    boundary="reflect"),
    "dust-3d": lambda m: m.galactic_dust_chart((6, 8, 8), 2),
}


# -- dtypes and policy ------------------------------------------------------------
@pytest.mark.parametrize("spelling,want", [
    ("float32", torch.float32), ("f32", torch.float32),
    ("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16),
    (np.float32, torch.float32), (np.dtype("float64"), torch.float64),
    (torch.bfloat16, torch.bfloat16),
])
def test_as_dtype_spellings(spelling, want):
    assert dtypes.as_dtype(spelling) == want


def test_as_dtype_rejects_unknown():
    with pytest.raises(TypeError):
        dtypes.as_dtype("int4")


def test_policy_matches_reference_aliases():
    from repro.kernels import policy as jpolicy

    for alias in ("bf16", "bfloat16", "mixed", "default", "fp32", "f32"):
        ours, ref = policy.resolve(alias), jpolicy.resolve(alias)
        assert ours.storage_dtype.itemsize == ref.storage_itemsize
        assert ours.accum_dtype == torch.float32
    assert policy.resolve(None) is policy.FP32
    assert policy.DtypePolicy("bfloat16") == policy.BF16
    assert hash(policy.DtypePolicy(torch.bfloat16)) == hash(policy.BF16)
    with pytest.raises(ValueError):
        policy.resolve("int8")


def test_cast_storage_keeps_nesting_and_none():
    tree = {"a": [torch.ones(2), (torch.zeros(1), None)], "b": None}
    out = policy.BF16.cast_storage(tree)
    assert out["a"][0].dtype == torch.bfloat16
    assert out["a"][1][0].dtype == torch.bfloat16
    assert out["a"][1][1] is None and out["b"] is None
    assert isinstance(out["a"][1], tuple)


# -- kernels -----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(jkernels.KERNELS))
def test_kernel_matrix_matches_reference(name):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(17, 3)).astype(np.float32)
    y = rng.normal(size=(5, 3)).astype(np.float32)
    theta = {"rho": 0.7, "sigma": 1.3}
    want = jkernels.kernel_matrix(jkernels.KERNELS[name](theta),
                                  jnp.asarray(x), jnp.asarray(y))
    got = tkernels.kernel_matrix(tkernels.KERNELS[name](theta),
                                 torch.from_numpy(x), torch.from_numpy(y))
    assert rel(t2n(got), want) < 1e-6
    # batched form: leading dims batch independent matrices
    got_b = tkernels.kernel_matrix(tkernels.KERNELS[name](theta),
                                   torch.from_numpy(np.stack([x, x])))
    want_b = jkernels.kernel_matrix(jkernels.KERNELS[name](theta),
                                    jnp.asarray(x))
    assert rel(t2n(got_b[1]), want_b) < 1e-6


def test_kernel_with_defaults():
    k = tkernels.matern32.with_defaults(rho=2.0)
    assert k.default_theta == {"rho": 2.0, "sigma": 1.0}
    assert tkernels.matern32.default_theta["rho"] == 1.0


# -- charts ------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CHARTS))
def test_chart_geometry_is_identical(name):
    jc, tc = CHARTS[name](jcharts), CHARTS[name](tcharts)
    assert tc.shape0 == jc.shape0 and tc.n_levels == jc.n_levels
    assert tc.invariant == jc.invariant
    assert (tc.b, tc.stride) == (jc.b, jc.stride)
    assert tc.final_shape == jc.final_shape and tc.size == jc.size
    for lvl in range(jc.n_levels + 1):
        assert tc.shape(lvl) == jc.shape(lvl)
        assert tc.delta(lvl) == jc.delta(lvl)
        assert tc.origin(lvl) == jc.origin(lvl)
        for a in range(jc.ndim):
            np.testing.assert_array_equal(tc.axis_coords(lvl, a),
                                          jc.axis_coords(lvl, a))
            if lvl < jc.n_levels:
                assert tc.family_count(lvl, a) == jc.family_count(lvl, a)
                np.testing.assert_array_equal(
                    tc.axis_coarse_windows(lvl, a),
                    jc.axis_coarse_windows(lvl, a))
                np.testing.assert_array_equal(
                    tc.axis_fine_windows(lvl, a),
                    jc.axis_fine_windows(lvl, a))
    lvl = min(1, jc.n_levels)
    assert rel(t2n(tc.grid_positions(lvl, device="cpu")),
               jc.grid_positions(lvl)) < 1e-6


def test_chart_is_frozen_and_hashable():
    a = tcharts.galactic_dust_chart((6, 8, 8), 2)
    b = tcharts.galactic_dust_chart((6, 8, 8), 2)
    assert hash(a) == hash(b) and a == b
    assert tcharts.log_chart(8, 1) == tcharts.log_chart(8, 1)
    with pytest.raises(AttributeError):
        a.n_levels = 3
    with pytest.raises(ValueError):
        tcharts.regular_chart(3, 2)          # level 1 smaller than n_csz


# -- refinement matrices -------------------------------------------------------------
# well-conditioned versions of each chart family (see the module docstring)
MATRIX_CASES = {
    "regular-1d": (lambda m: m.regular_chart(16, 2), 2.0),
    "log-1d": (lambda m: m.log_chart(12, 2, n_csz=5, n_fsz=4, delta0=0.2),
               0.5),
    "regular-2d": (lambda m: m.regular_chart((10, 12), 2), 2.0),
    "dust-3d": (lambda m: m.galactic_dust_chart(
        (8, 8, 8), 2, delta_logr=0.3, angular_extent=4.0,
        boundary="shrink"), 0.8),
}


def _sq(m):
    return m @ np.swapaxes(m, -1, -2)


@pytest.mark.parametrize("name", sorted(MATRIX_CASES))
def test_refinement_matrices_match_reference(name):
    build, rho = MATRIX_CASES[name]
    jc, tc = build(jcharts), build(tcharts)
    jk = jkernels.matern32.with_defaults(rho=rho)()
    tk = tkernels.matern32.with_defaults(rho=rho)()
    # jit: the eager reference dispatches its vmapped linalg op by op
    s0 = np.asarray(jax.jit(lambda: jrefine.level0_sqrt(jc, jk))())
    assert rel(_sq(t2n(trefine.level0_sqrt(tc, tk, device="cpu"))),
               _sq(s0)) < 1e-4
    for lvl in range(jc.n_levels):
        if jc.ndim < 3:  # the joint 3-D build is n_csz^9 per family
            r, d = jax.jit(lambda: jrefine.refinement_matrices_level(
                jc, jk, lvl))()
            r2, d2 = trefine.refinement_matrices_level(tc, tk, lvl,
                                                       device="cpu")
            assert r2.shape == r.shape and d2.shape == d.shape
            assert rel(t2n(r2), r) < 1e-4
            assert rel(_sq(t2n(d2)), _sq(np.asarray(d))) < 1e-4
        rs, ds = jax.jit(lambda: jrefine.axis_refinement_matrices_level(
            jc, jk, lvl))()
        rs2, ds2 = trefine.axis_refinement_matrices_level(tc, tk, lvl,
                                                          device="cpu")
        for a in range(jc.ndim):
            assert rs2[a].shape == rs[a].shape
            assert rel(t2n(rs2[a]), rs[a]) < 1e-4
            assert rel(_sq(t2n(ds2[a])), _sq(np.asarray(ds[a]))) < 1e-4


@pytest.mark.parametrize("name", sorted(CHARTS))
def test_level_geom_matches_reference(name):
    jc, tc = CHARTS[name](jcharts), CHARTS[name](tcharts)
    for lvl in range(jc.n_levels):
        j = jrefine.LevelGeom.for_level(jc, lvl)
        t = trefine.LevelGeom.for_level(tc, lvl)
        assert dataclass_tuple(t) == dataclass_tuple(j)


def dataclass_tuple(g):
    return (g.coarse_shape, g.fine_shape, g.T, g.kept_T, g.n_csz, g.n_fsz,
            g.stride, g.b, g.boundary)


@pytest.mark.parametrize("name", ["regular-1d-reflect", "log-1d",
                                  "regular-2d-shrink", "regular-2d-reflect"])
def test_refine_level_on_reference_matrices(name):
    """The plain step, fed the JAX package's joint matrices, reproduces
    its ``refine_level`` on every level."""
    jc, tc = CHARTS[name](jcharts), CHARTS[name](tcharts)
    k = jkernels.matern32.with_defaults(rho=3.0)()
    rng = np.random.default_rng(1)
    for lvl in range(jc.n_levels):
        geom = jrefine.LevelGeom.for_level(jc, lvl)
        r, d = jax.jit(lambda: jrefine.refinement_matrices_level(
            jc, k, lvl))()
        field = rng.normal(size=geom.coarse_shape).astype(np.float32)
        xi = rng.normal(size=(int(np.prod(geom.T)),
                              geom.n_fsz ** jc.ndim)).astype(np.float32)
        want = jax.jit(lambda f, x: jrefine.refine_level(f, x, r, d, geom))(
            field, xi)
        got = trefine.refine_level(
            torch.from_numpy(field), torch.from_numpy(xi),
            to_torch(np.asarray(r), device="cpu"),
            to_torch(np.asarray(d), device="cpu"),
            trefine.LevelGeom.for_level(tc, lvl))
        assert tuple(got.shape) == tuple(want.shape)
        assert rel(t2n(got), want) < 1e-5


def test_chunked_eigh_matches_one_batch():
    """A batch larger than the eigh chunk (the ~65K families of a charted
    1-D level) decomposes as one call would, keeping its leading dims."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=(3, trefine._EIGH_CHUNK, 4, 4))
    spd = torch.from_numpy(a @ np.swapaxes(a, -1, -2))
    evals, evecs = trefine._eigh(spd)
    want_vals, _ = torch.linalg.eigh(spd)
    assert tuple(evals.shape) == (3, trefine._EIGH_CHUNK, 4)
    torch.testing.assert_close(evals, want_vals, rtol=0, atol=0)
    torch.testing.assert_close(evecs @ torch.diag_embed(evals)
                               @ evecs.transpose(-1, -2), spd,
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("evals", [[0.5, 1.0, 2.0, 4.0], [1.0, 1.0, 2.0, 1e-9],
                                   [1.0, 1.0 + 1e-9, 0.5, 3e-7], [2.0] * 4],
                         ids=["distinct", "tie-clipped", "near-tie-clipped",
                              "all-tied"])
def test_psd_sqrt_is_the_symmetric_root_and_differentiable(evals):
    """``_psd_sqrt`` is ``V sqrt(max(Λ, eps)) Vᵀ``, and its backward (the
    divided differences) matches central differences in float64, in the
    matrix and in eps, also at exact and near ties and at clipped
    eigenvalues, where the backward of eigh is NaN or unbounded."""
    rng = np.random.default_rng(13)
    q, _ = np.linalg.qr(rng.normal(size=(4, 4)))
    a = torch.from_numpy(q @ np.diag(evals) @ q.T).requires_grad_(True)
    eps = torch.full((1, 1), 1e-6, dtype=torch.float64, requires_grad=True)
    want = q @ np.diag(np.sqrt(np.maximum(evals, 1e-6))) @ q.T
    np.testing.assert_allclose(trefine._psd_sqrt(a, eps).detach().numpy(),
                               want, rtol=0, atol=1e-12)
    assert torch.autograd.gradcheck(
        lambda m, e: trefine._psd_sqrt(0.5 * (m + m.T), e), (a, eps),
        eps=1e-9, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_reflect_pad_matches_numpy(ndim):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3,) + (7,) * ndim).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        got = trefine.reflect_pad(torch.from_numpy(x).to(dtype), 2, ndim)
        want = np.pad(torch.from_numpy(x).to(dtype).float().numpy(),
                      [(0, 0)] + [(2, 2)] * ndim, mode="reflect")
        np.testing.assert_array_equal(t2n(got), want)


# -- conversion --------------------------------------------------------------------
def test_convert_carries_nesting_and_bf16():
    """The JAX package's matrices layout, with bfloat16 leaves as numpy
    holds them (the ml_dtypes type)."""
    rng = np.random.default_rng(3)

    def bf16(*shape):
        return np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16))

    mats = {"sqrt0": bf16(6, 6),
            "Rax": [[bf16(3, 4, 5), bf16(4, 5)], [bf16(6, 4, 5), bf16(4, 5)]],
            "sqrtDax": [[bf16(3, 4, 4), bf16(4, 4)],
                        [bf16(6, 4, 4), bf16(4, 4)]]}
    got = matrices_to_torch(mats, device="cpu")
    assert set(got) == {"sqrt0", "Rax", "sqrtDax"}
    assert got["Rax"][0][0].dtype == torch.bfloat16
    assert isinstance(got["Rax"][1], list) and len(got["Rax"][1]) == 2
    np.testing.assert_array_equal(t2n(got["Rax"][1][1]),
                                  mats["Rax"][1][1].astype(np.float32))
    assert matrices_to_torch(mats, dtype="float32",
                             device="cpu")["sqrt0"].dtype \
        == torch.float32
    xi = [np.ones((2, 3), np.float32), np.zeros(4, np.float32)]
    out = xi_to_torch(xi, dtype="bfloat16", device="cpu")
    assert isinstance(out, list) and out[0].dtype == torch.bfloat16
