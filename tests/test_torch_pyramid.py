"""The port's pyramid held against the JAX package's.

* ``refine_pyramid`` (on CPU tensors: its plain version, the per-level
  plain versions with the storage rounding between levels) against
  ``repro.kernels.pyramid.refine_pyramid`` in interpret mode, on a 1-D
  stationary, a 1-D charted, two 2-D and a 3-D dust-like chart, reflect
  and shrink, at float32 and with bfloat16 storage, with and without the
  sample axis; the reference's matrices are handed across.
* Its backward: the ξ/field VJP at fixed matrices (the adjoint chain) and
  the factors' cotangents (the replay through the per-level routes)
  against ``jax.vjp`` of the reference pyramid.
* ``ICR(use_pallas=True)`` with the pyramid on (the default in both
  packages): ``apply_sqrt_batch`` and ``apply_sqrt_T_batch`` against the
  reference, on the reference's matrices.
* The residency rule (``dispatch.pyramid_prefix``), the cover rule
  (``dispatch.pyramid_cover``: 1-D stationary levels only), their covers
  of the four charts ``chip_smoke.py`` drives, and ``plan(pyramid=True)``.

Operands come from numpy seeds. Tolerances are relative to the largest
magnitude: 1e-5 at float32 and 5e-2 with bfloat16 storage for fields and
input cotangents, 1e-4 for matrix cotangents (sums over every family and
sample, taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ICR as JICR
from repro.core import charts as jcharts
from repro.core import kernels as jkernels
from repro.core import refine as jrefine
from repro.kernels import pyramid as jpyramid
from repro_torch import ICR
from repro_torch.convert import matrices_to_torch, to_torch, xi_to_torch
from repro_torch.core import charts as tcharts
from repro_torch.core import kernels as tkernels
from repro_torch.core import refine as trefine
from repro_torch.kernels import dispatch, pyramid

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
MAT_TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t2n(t):
    return t.detach().float().cpu().numpy()


def j2n(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


CHARTS = {
    "1d-stationary": (lambda m: m.regular_chart(32, 3, boundary="reflect"),
                      10.0),
    "1d-charted": (lambda m: m.log_chart(32, 3, n_csz=5, n_fsz=4,
                                         delta0=0.05), 1.0),
    "2d-shrink": (lambda m: m.regular_chart((12, 10), 2), 4.0),
    "2d-charted-reflect": (lambda m: m.log_polar_chart((8, 8), 2), 1.0),
    "3d-dust-reflect": (lambda m: m.galactic_dust_chart((6, 8, 8), 2), 0.5),
}


def _case(name, dname, seed, *, batch=None):
    """The reference's geometries and per-axis factors (1-D: the joint
    matrices in the route's shapes), seeded field and ξ; each as JAX
    arrays and as the port's tensors, in storage dtype `dname`."""
    build, rho = CHARTS[name]
    jc, tc = build(jcharts), build(tcharts)
    k = jkernels.matern32.with_defaults(rho=rho)()
    mats = []
    for lvl in range(jc.n_levels):
        if jc.ndim > 1:
            rs, ds = jax.jit(lambda lvl=lvl: jrefine.axis_refinement_matrices_level(
                jc, k, lvl))()
        else:
            r, d = jax.jit(lambda lvl=lvl: jrefine.refinement_matrices_level(
                jc, k, lvl))()
            if r.shape[0] == 1:
                r, d = r.reshape(r.shape[-2:]), d.reshape(d.shape[-2:])
            rs, ds = [r], [d]
        mats.append((list(rs), list(ds)))
    jdt, tdt = DTYPES[dname]
    jmats = [([jnp.asarray(r, jdt) for r in rs], [jnp.asarray(d, jdt)
                                                  for d in ds])
             for rs, ds in mats]
    tmats = [([to_torch(np.asarray(r), device="cpu").to(tdt) for r in rs],
              [to_torch(np.asarray(d), device="cpu").to(tdt) for d in ds])
             for rs, ds in jmats]
    jgeoms = [jrefine.LevelGeom.for_level(jc, lvl)
              for lvl in range(jc.n_levels)]
    tgeoms = [trefine.LevelGeom.for_level(tc, lvl)
              for lvl in range(tc.n_levels)]
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    field = jnp.asarray(rng.normal(size=lead + tuple(jgeoms[0].coarse_shape)),
                        jdt)
    xis = [jnp.asarray(rng.normal(size=lead + (int(np.prod(g.T)),
                                                g.n_fsz ** jc.ndim)), jdt)
           for g in jgeoms]
    tfield = to_torch(np.asarray(field), device="cpu").to(tdt)
    txis = [to_torch(np.asarray(x), device="cpu").to(tdt) for x in xis]
    return (jgeoms, jmats, field, xis), (tgeoms, tmats, tfield, txis)


@pytest.mark.parametrize("batch", [None, 2], ids=["no-sample-axis", "S=2"])
@pytest.mark.parametrize("dname", sorted(TOL))
@pytest.mark.parametrize("name", sorted(CHARTS))
def test_pyramid_matches_reference(name, dname, batch):
    (jg, jm, jf, jx), (tg, tm, tf, tx) = _case(name, dname,
                                              [1, len(name)], batch=batch)
    want = jpyramid.refine_pyramid(jf, jx, jm, jg, interpret=True,
                                   sample_axis=batch is not None)
    got = pyramid.refine_pyramid(tf, tx, tm, tg,
                                 sample_axis=batch is not None)
    assert got.dtype == DTYPES[dname][1]
    assert tuple(got.shape) == tuple(want.shape)
    assert rel(t2n(got), j2n(want)) < TOL[dname]


@pytest.mark.parametrize("name", sorted(CHARTS))
def test_pyramid_vjp_matches_reference(name):
    """Fixed matrices: the cotangents of the field and of every level's ξ
    through the port's adjoint chain against jax.vjp of the reference."""
    (jg, jm, jf, jx), (tg, tm, tf, tx) = _case(name, "float32", [2, len(name)],
                                              batch=2)
    out, vjp = jax.vjp(lambda f, xs: jpyramid.refine_pyramid(
        f, xs, jm, jg, interpret=True, sample_axis=True), jf, jx)
    g = np.random.default_rng([3, len(name)]).normal(size=out.shape)
    want_f, want_x = vjp(jnp.asarray(g, jnp.float32))
    inputs = [tf.requires_grad_(True)] + [x.requires_grad_(True) for x in tx]
    got = torch.autograd.grad(
        pyramid.refine_pyramid(inputs[0], inputs[1:], tm, tg,
                               sample_axis=True),
        inputs, torch.tensor(g, dtype=torch.float32))
    for a, w in zip(got, [want_f, *want_x]):
        assert rel(t2n(a), j2n(w)) < TOL["float32"], name


@pytest.mark.parametrize("name", ["1d-charted", "2d-charted-reflect",
                                  "3d-dust-reflect"])
def test_pyramid_matrix_cotangents_match_reference(name):
    """Learned θ: the factors' cotangents through the port's replay (the
    per-level kernel routes, nd-axes on N-D charts) against jax.vjp of the
    reference pyramid in the factors."""
    (jg, jm, jf, jx), (tg, tm, tf, tx) = _case(name, "float32", [4, len(name)],
                                              batch=2)
    out, vjp = jax.vjp(lambda ms: jpyramid.refine_pyramid(
        jf, jx, ms, jg, interpret=True, sample_axis=True), jm)
    g = np.random.default_rng([5, len(name)]).normal(size=out.shape)
    (want,) = vjp(jnp.asarray(g, jnp.float32))
    tm = [([r.requires_grad_(True) for r in rs],
           [d.requires_grad_(True) for d in ds]) for rs, ds in tm]
    leaves = [t for rs, ds in tm for t in (*rs, *ds)]
    got = torch.autograd.grad(
        pyramid.refine_pyramid(tf, tx, tm, tg, sample_axis=True), leaves,
        torch.tensor(g, dtype=torch.float32))
    wleaves = [w for rs, ds in want for w in (*rs, *ds)]
    assert len(got) == len(wleaves)
    for a, w in zip(got, wleaves):
        assert a.shape == w.shape
        assert rel(t2n(a), j2n(w)) < MAT_TOL, name


# -- ICR with the pyramid on --------------------------------------------------------
ICR_CHARTS = {
    "tod": (lambda m: m.regular_chart(64, 3, boundary="reflect"), 8.0),
    "log": (lambda m: m.log_chart(12, 3, n_csz=5, n_fsz=4, delta0=0.05),
            0.3),
    "image": (lambda m: m.regular_chart((16, 16), 2, boundary="reflect"),
              4.0),
    "dust": (lambda m: m.galactic_dust_chart((6, 8, 8), n_levels=2), 0.5),
    "log_polar": (lambda m: m.log_polar_chart((8, 8), 2), 1.0),
}


@pytest.mark.parametrize("pol", [None, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(ICR_CHARTS))
def test_icr_with_pyramid_matches_reference(name, pol):
    """apply_sqrt_batch with the pyramid on (the default: its cover on the
    1-D stationary chart, per level on the others) and apply_sqrt_T_batch
    on the kernel route, against the reference ICR(use_pallas=True), whose
    pyramid is on by default too and covers every chart here."""
    build, rho = ICR_CHARTS[name]
    jicr = JICR(build(jcharts), jkernels.matern32.with_defaults(rho=rho),
                use_pallas=True, dtype_policy=pol)
    ticr = ICR(build(tcharts), tkernels.matern32.with_defaults(rho=rho),
               use_pallas=True, dtype_policy=pol, device="cpu")
    assert ticr.use_pyramid and jicr.use_pyramid
    n = ticr.chart.n_levels
    assert dispatch.pyramid_prefix(ticr.chart, samples=2) == n
    assert dispatch.pyramid_cover(ticr.chart, samples=2) == (
        n if name == "tod" else None)
    storage = jicr.policy.storage_dtype
    mats = jax.jit(jicr.matrices)()
    tmats = matrices_to_torch(jax.tree.map(np.asarray, mats), device="cpu")
    rng = np.random.default_rng(9)
    xi = [jnp.asarray(rng.normal(size=(2,) + s), storage)
          for s in jicr.xi_shapes()]
    want = jax.jit(jicr.apply_sqrt_batch)(mats, xi)
    got = ticr.apply_sqrt_batch(tmats, xi_to_torch([np.asarray(x)
                                                    for x in xi],
                                                   device="cpu"))
    tol = TOL["float32" if pol is None else "bfloat16"]
    assert got.dtype == ticr.policy.storage_dtype
    assert rel(t2n(got), j2n(want)) < tol
    v = jnp.asarray(rng.normal(size=(2,) + jicr.out_shape), storage)
    want_t = [jicr.apply_sqrt_T(mats, v[i]) for i in range(2)]
    got_t = ticr.apply_sqrt_T_batch(tmats,
                                    to_torch(np.asarray(v), device="cpu"))
    for lvl, g_ in enumerate(got_t):
        w = np.stack([j2n(wt[lvl]) for wt in want_t])
        assert rel(t2n(g_), w) < tol, lvl


# -- the cover rule -------------------------------------------------------------------
def test_cover_is_a_prefix_monotone_in_the_budget():
    deep = tcharts.galactic_dust_chart((8, 16, 16), n_levels=4)
    covers = [dispatch.pyramid_prefix(deep, samples=8, budget=b) or 0
              for b in (2**10, 2**20, 8 * 2**20, 40 * 2**20, 2**40)]
    # an N-D chart gets no cover, whatever the budget
    assert dispatch.pyramid_cover(deep, samples=8, budget=2**40) is None
    assert covers == sorted(covers)
    assert covers[0] == 0 and covers[-1] == 4
    # the budget bounds the fields handed between covered levels
    for b, k in zip((2**20, 8 * 2**20, 40 * 2**20), covers[1:4]):
        handed = sum(8 * 4 * int(np.prod(deep.shape(lvl)))
                     for lvl in range(1, k))
        assert handed <= b
        if k < deep.n_levels:
            assert handed + 8 * 4 * int(np.prod(deep.shape(k))) > b


def test_one_level_is_no_pyramid():
    assert dispatch.pyramid_prefix(
        tcharts.galactic_dust_chart((6, 8, 8), 1)) is None
    c = tcharts.galactic_dust_chart((6, 8, 8), 2)
    assert dispatch.pyramid_prefix(c) == 2
    # a budget that holds no handed field leaves one level: no pyramid
    assert dispatch.pyramid_prefix(c, budget=1) is None
    assert dispatch.pyramid_cover(tcharts.regular_chart(32, 1)) is None
    r = tcharts.regular_chart(32, 2)
    assert dispatch.pyramid_cover(r) == 2
    assert dispatch.pyramid_cover(r, budget=1) is None


def test_level_without_factors_ends_the_prefix():
    c = tcharts.galactic_dust_chart((6, 8, 8), n_levels=2)
    assert dispatch.pyramid_prefix(c, have_axis_mats=False) is None
    assert dispatch.pyramid_prefix(c) == 2
    assert dispatch.pyramid_cover(tcharts.regular_chart(32, 3)) == 3


def test_covers_of_the_chip_charts():
    """The prefixes and covers at S=8 that PERF.md lists, float32 and
    bfloat16: the residency rule takes the whole dust, log and log-polar
    charts, and 9 of regular's 10 levels at float32 (its last handed field
    would pass the 25 MiB); the cover rule keeps regular's alone, the one
    1-D stationary chart."""
    charts = {
        "dust": tcharts.galactic_dust_chart((8, 16, 16), 3),
        "regular": tcharts.regular_chart(1024, 10, boundary="reflect"),
        "log": tcharts.log_chart(1024, 8, n_csz=5, n_fsz=4,
                                 delta0=0.0197 / 16),
        "log_polar": tcharts.log_polar_chart((64, 64), 3),
    }
    for rule, want32, want16 in (
            (dispatch.pyramid_prefix,
             {"dust": 3, "regular": 9, "log": 8, "log_polar": 3},
             {"dust": 3, "regular": 10, "log": 8, "log_polar": 3}),
            (dispatch.pyramid_cover,
             {"dust": None, "regular": 9, "log": None, "log_polar": None},
             {"dust": None, "regular": 10, "log": None, "log_polar": None})):
        f32 = {n: rule(c, samples=8, itemsize=4) for n, c in charts.items()}
        bf16 = {n: rule(c, samples=8, itemsize=2) for n, c in charts.items()}
        assert f32 == want32
        assert bf16 == want16


def test_plan_reports_the_pyramid():
    c = tcharts.regular_chart(1024, 10, boundary="reflect")
    p = dispatch.plan(c, pyramid=True, samples=8, dtype=torch.float32)
    assert [e["route"] for e in p] == ["pyramid"] * 9 + ["stationary-1d"]
    assert [e["launches"] for e in p] == [1] + [0] * 8 + [1]
    assert {e["kernel"] for e in p[:9]} == {"refine_pyramid"}
    # the default shows the per-level routes underneath
    assert {e["route"] for e in dispatch.plan(c)} == {"stationary-1d"}


def test_icr_defaults_to_the_pyramid():
    icr = ICR(tcharts.regular_chart(16, 2), tkernels.matern32, device="cpu")
    assert icr.use_pyramid
