"""The port's nd-axes route held against the JAX package's.

* The noise-free 1-D forward (``refine_stationary_nn`` /
  ``refine_charted_nn``; on CPU tensors their plain versions) against the
  Pallas ``noise=False`` kernels in interpret mode, and its backward in
  the coarse field and the stencils against ``jax.vjp``.
* ``nd.refine_axes`` against ``repro.kernels.nd.refine_axes`` in interpret
  mode on 2-D and 3-D levels with every mix of stationary and charted
  axes, reflect and shrink, float32 and bfloat16 storage, with and
  without the sample axis; its VJP in the field, ξ and every factor.
* ``dispatch.refine`` takes nd-axes exactly when a factor requires grad.
* The θ-gradient of the sign-free ``vᵀ K_ICR(θ) v`` on a small 2-D and a
  small 3-D shrink chart, through the port's kernel route (the pyramid's
  replay over nd-axes) against ``jax.grad`` of the reference's kernel
  route, each package building its own matrices.
* dρ of a loss through that route in float32 against float64, itself held
  against a central difference (the port's symmetric square root).

Operands come from numpy seeds; the kernels are linear in their factors,
so random factors serve the mixes no chart has. Tolerances are relative to
the largest magnitude: 1e-5 at float32 and 5e-2 with bfloat16 storage for
fields and input cotangents, 1e-4 for matrix cotangents and θ-gradients.
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
from repro.kernels import nd as jnd
from repro.kernels.icr_refine import (
    refine_charted_pallas,
    refine_stationary_pallas,
)
from repro_torch import ICR
from repro_torch.convert import to_torch
from repro_torch.core import charts as tcharts
from repro_torch.core import kernels as tkernels
from repro_torch.core import refine as trefine
from repro_torch.kernels import dispatch, icr_refine, nd

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


def pair(arr, dname="float32"):
    """The same numpy array as a JAX array and a torch tensor of dtype."""
    jdt, tdt = DTYPES[dname]
    j = jnp.asarray(arr, jdt)
    return j, to_torch(np.asarray(j), device="cpu").to(tdt)


# -- the noise-free 1-D kernels --------------------------------------------------
@pytest.mark.parametrize("dname", sorted(TOL))
@pytest.mark.parametrize("charted", [False, True],
                         ids=["stationary", "charted"])
@pytest.mark.parametrize("n_csz,n_fsz", [(3, 2), (5, 4)])
def test_noise_free_1d_matches_reference(n_csz, n_fsz, charted, dname):
    """At a family count that is not a multiple of the reference's block,
    and a coarse row longer than the windows need."""
    rng = np.random.default_rng([n_csz, int(charted), 11])
    t, s = 37, n_fsz // 2
    lead = (t,) if charted else ()
    jc, tc = pair(rng.normal(size=(3, (t - 1) * s + n_csz + 3)), dname)
    jr, tr = pair(rng.normal(size=lead + (n_fsz, n_csz)) / n_csz, dname)
    kern = refine_charted_pallas if charted else refine_stationary_pallas
    want = kern(jc, None, jr, None, n_csz=n_csz, n_fsz=n_fsz,
                block_families=16, batch_block=2, interpret=True,
                noise=False, t=t)
    got = (icr_refine.refine_charted_nn(tc, tr) if charted
           else icr_refine.refine_stationary_nn(tc, tr, t))
    assert got.dtype == tc.dtype
    assert tuple(got.shape) == tuple(want.shape)
    assert rel(t2n(got), j2n(want)) < TOL[dname]

    # the backward: the _nn adjoint and the stencil cotangent
    g = rng.normal(size=want.shape)
    _, vjp = jax.vjp(lambda c, r: kern(
        c, None, r, None, n_csz=n_csz, n_fsz=n_fsz, block_families=16,
        interpret=True, noise=False, t=t), jnp.asarray(jc, jnp.float32),
        jnp.asarray(jr, jnp.float32))
    wc, wr = vjp(jnp.asarray(g, jnp.float32))
    tc32 = tc.float().requires_grad_(True)
    tr32 = tr.float().requires_grad_(True)
    fine = (icr_refine.refine_charted_nn(tc32, tr32) if charted
            else icr_refine.refine_stationary_nn(tc32, tr32, t))
    gc, gr = torch.autograd.grad(fine, (tc32, tr32),
                                 torch.tensor(g, dtype=torch.float32))
    assert rel(t2n(gc), j2n(wc)) < TOL["float32"]
    assert rel(t2n(gr), j2n(wr)) < MAT_TOL


# -- refine_axes -------------------------------------------------------------------
GEOMS = {
    "2d-shrink": lambda m: m.regular_chart((12, 10), 1),
    "2d-reflect": lambda m: m.regular_chart((12, 16), 1, boundary="reflect"),
    "3d-shrink": lambda m: m.regular_chart((7, 6, 9), 1, n_csz=5, n_fsz=4),
    "3d-reflect": lambda m: m.galactic_dust_chart((6, 8, 8), 1),
}
# which axes carry per-family factors (c: charted, s: stationary)
MIXES = {2: [(False, True), (True, False), (True, True)],
         3: [(True, False, False), (False, True, False), (True, True, True)]}
CASES = [(g, mix) for g in GEOMS
         for mix in MIXES[3 if g.startswith("3d") else 2]]


def _axes_operands(name, charted, dname, seed, *, batch):
    jg = jrefine.LevelGeom.for_level(GEOMS[name](jcharts), 0)
    tg = trefine.LevelGeom.for_level(GEOMS[name](tcharts), 0)
    rng = np.random.default_rng(seed)
    f, c = jg.n_fsz, jg.n_csz
    lead = () if batch is None else (batch,)
    arrs = {"field": rng.normal(size=lead + tuple(jg.coarse_shape)),
            "xi": rng.normal(size=lead + (int(np.prod(jg.T)),
                                          f ** len(jg.T)))}
    for a, ch in enumerate(charted):
        mat = (jg.T[a],) if ch else ()
        arrs[f"r{a}"] = rng.normal(size=mat + (f, c)) / c
        arrs[f"d{a}"] = rng.normal(size=mat + (f, f)) / f
    pairs = {k: pair(v, dname) for k, v in arrs.items()}
    nd_ = len(charted)
    j = {k: v[0] for k, v in pairs.items()}
    t = {k: v[1] for k, v in pairs.items()}
    return jg, tg, j, t, nd_


def _axes_args(ops, nd_):
    return ([ops[f"r{a}"] for a in range(nd_)],
            [ops[f"d{a}"] for a in range(nd_)])


CASE_IDS = [f"{g}-{''.join('c' if ch else 's' for ch in mix)}"
            for g, mix in CASES]


@pytest.mark.parametrize("batch", [None, 2], ids=["no-sample-axis", "S=2"])
@pytest.mark.parametrize("dname", sorted(TOL))
@pytest.mark.parametrize("name,charted", CASES, ids=CASE_IDS)
def test_refine_axes_matches_reference(name, charted, dname, batch):
    jg, tg, j, t, nd_ = _axes_operands(name, charted, dname,
                                       [len(name), *charted], batch=batch)
    want = jnd.refine_axes(j["field"], j["xi"], *_axes_args(j, nd_), jg,
                           interpret=True, sample_axis=batch is not None)
    got = nd.refine_axes(t["field"], t["xi"], *_axes_args(t, nd_), tg,
                         sample_axis=batch is not None)
    assert got.dtype == DTYPES[dname][1]
    assert tuple(got.shape) == tuple(want.shape)
    assert rel(t2n(got), j2n(want)) < TOL[dname]


@pytest.mark.parametrize("name,charted", CASES, ids=CASE_IDS)
def test_refine_axes_vjp_matches_reference(name, charted):
    """The cotangents of the field, ξ and every factor through the 1-D
    Functions' adjoints against jax.vjp of the reference."""
    jg, tg, j, t, nd_ = _axes_operands(name, charted, "float32",
                                       [7, len(name), *charted], batch=2)
    keys = ["field", "xi"] + [f"{m}{a}" for a in range(nd_)
                              for m in ("r", "d")]

    def jfun(*vals):
        ops = dict(zip(keys, vals))
        return jnd.refine_axes(ops["field"], ops["xi"], *_axes_args(ops, nd_),
                               jg, interpret=True, sample_axis=True)

    out, vjp = jax.vjp(jfun, *[j[k] for k in keys])
    g = np.random.default_rng([8, len(name)]).normal(size=out.shape)
    want = vjp(jnp.asarray(g, jnp.float32))
    tops = {k: t[k].requires_grad_(True) for k in keys}
    fine = nd.refine_axes(tops["field"], tops["xi"], *_axes_args(tops, nd_),
                          tg, sample_axis=True)
    got = torch.autograd.grad(fine, [tops[k] for k in keys],
                              torch.tensor(g, dtype=torch.float32))
    for k, a, w in zip(keys, got, want):
        tol = TOL["float32"] if k in ("field", "xi") else MAT_TOL
        assert rel(t2n(a), j2n(w)) < tol, k


def test_dispatch_takes_nd_axes_for_learned_factors(monkeypatch):
    """dispatch.refine runs the fused level at fixed factors and refine_axes
    when a factor requires grad (with grad enabled); the two agree."""
    geom = trefine.LevelGeom.for_level(tcharts.regular_chart((12, 10), 1), 0)
    rng = np.random.default_rng(12)
    f, c = geom.n_fsz, geom.n_csz
    field = torch.tensor(rng.normal(size=(2,) + geom.coarse_shape),
                         dtype=torch.float32)
    xi = torch.tensor(rng.normal(size=(2, int(np.prod(geom.T)), f * f)),
                      dtype=torch.float32)
    rs = [torch.tensor(rng.normal(size=(f, c)), dtype=torch.float32)
          for _ in range(2)]
    ds = [torch.tensor(rng.normal(size=(f, f)), dtype=torch.float32)
          for _ in range(2)]
    calls = []
    real = nd.refine_axes
    monkeypatch.setattr(nd, "refine_axes",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fixed = dispatch.refine(field, xi, None, None, geom, axis_mats=(rs, ds),
                            sample_axis=True)
    assert not calls
    rs[1].requires_grad_(True)
    with torch.no_grad():
        dispatch.refine(field, xi, None, None, geom, axis_mats=(rs, ds),
                        sample_axis=True)
    assert not calls
    learned = dispatch.refine(field, xi, None, None, geom,
                              axis_mats=(rs, ds), sample_axis=True)
    assert calls and learned.requires_grad
    assert rel(t2n(learned), t2n(fixed)) < TOL["float32"]
    assert dispatch.learns((rs, ds)) and dispatch.route_for(
        geom, have_axis_mats=True,
        learn=dispatch.learns((rs, ds))) == dispatch.ROUTE_AXES_ND
    with torch.no_grad():
        assert not dispatch.learns((rs, ds))


@pytest.mark.parametrize("name", ["2d", "3d"])
def test_theta_gradient_of_quadratic_form_nd(name):
    """d/dρ of vᵀ K_ICR(ρ) v = ‖sqrt(K_ICR)ᵀ v‖² on a shrink N-D chart:
    through ``implicit_sqrt`` on the port's kernel route (no pyramid cover
    on an N-D chart: every level on nd-axes, the noise-free kernels
    included) against jax.grad of the reference's kernel route, whose
    pyramid covers both levels."""
    build = {"2d": lambda m: m.regular_chart((6, 7), 2),
             "3d": lambda m: m.regular_chart((5, 6, 7), 2)}[name]
    rho0 = {"2d": 3.0, "3d": 2.0}[name]
    jicr = JICR(build(jcharts), jkernels.matern32, use_pallas=True)
    ticr = ICR(build(tcharts), tkernels.matern32, use_pallas=True,
               device="cpu")
    assert dispatch.pyramid_prefix(ticr.chart, samples=ticr.xi_size()) == 2
    assert dispatch.pyramid_cover(ticr.chart,
                                  samples=ticr.xi_size()) is None
    v = np.random.default_rng(7).normal(size=jicr.out_shape)

    def jq(rho):
        mats = jicr.matrices({"rho": rho, "sigma": 1.0})
        xi = jicr.apply_sqrt_T(mats, jnp.asarray(v, jnp.float32))
        return sum(jnp.sum(x ** 2) for x in xi)

    want = float(jax.jit(jax.grad(jq))(jnp.float32(rho0)))
    rho = torch.tensor(rho0, requires_grad=True)
    sq = ticr.implicit_sqrt({"rho": rho, "sigma": 1.0})
    q = torch.sum((sq.T @ torch.tensor(v.reshape(-1), dtype=torch.float32))
                  ** 2)
    (got,) = torch.autograd.grad(q, rho)
    assert abs(float(got) - want) <= MAT_TOL * abs(want)


@pytest.mark.parametrize("name", ["dust", "log_polar"])
def test_theta_gradient_float32_against_float64(name):
    """dρ of a Gaussian loss through the port's kernel route (nd-axes on
    every level) with the matrices built in float32, against the
    same route in float64 (``ICR.matrices(dtype=torch.float64)``), which
    a central difference holds at 1e-5. What float32 leaves is the
    rounding of the level-0 eigenvalues near the clip, which the square
    root's derivative amplifies (PERF.md); through eigh's own backward it
    was unbounded at near-ties and NaN at the exact ties of log_polar."""
    chart, rho = {"dust": (tcharts.galactic_dust_chart((6, 8, 8), 2), 0.5),
                  "log_polar": (tcharts.log_polar_chart((16, 16), 2),
                                2.0)}[name]
    icr = ICR(chart, tkernels.matern32, use_pallas=True, device="cpu")
    gen = torch.Generator().manual_seed(23)
    xi = [0.5 * x for x in icr.init_xi(gen)]
    y = torch.randn(icr.out_shape, generator=gen)

    def loss(r):
        mats = icr.matrices({"rho": r, "sigma": 1.0}, dtype=r.dtype)
        field = icr.apply_sqrt(mats, [x.to(r.dtype) for x in xi])
        return 0.5 * torch.sum(torch.square(field - y.to(r.dtype)) / 0.01)

    def grad(dtype):
        r = torch.tensor(rho, dtype=dtype, requires_grad=True)
        return float(torch.autograd.grad(loss(r), r)[0])

    g32, g64 = grad(torch.float32), grad(torch.float64)
    h = 1e-5 * rho
    with torch.no_grad():
        fd = (float(loss(torch.tensor(rho + h, dtype=torch.float64)))
              - float(loss(torch.tensor(rho - h, dtype=torch.float64)))) / (
                  2 * h)
    assert abs(g64 - fd) <= 1e-5 * abs(fd)
    assert abs(g32 - g64) <= 1e-2 * abs(g64)
