"""The port's backward held against the JAX package's.

* The adjoint oracles of ``repro_torch.kernels.ref`` against
  ``repro.kernels.ref.*_vjp_ref``, and the adjoint wrappers (on CPU
  tensors: their plain versions) against the Pallas adjoint kernels in
  interpret mode, at a family count that leaves a ragged last block and
  at ``q_max = 2`` (n_csz=5, n_fsz=4).
* Each autograd Function's backward against ``jax.vjp`` of the JAX entry
  point: all four cotangents on the 1-D routes, (field, ξ) at fixed
  matrices on the fused N-D route.
* ``ICR.apply_sqrt_T`` against the JAX package's, with its matrices handed
  across, and the θ-gradient of the sign-free ``vᵀ K_ICR(θ) v``.

Operands come from numpy seeds. Tolerances are relative to the largest
magnitude: 1e-5 at float32 and 5e-2 with bfloat16 storage for input
cotangents, 1e-4 for matrix cotangents and θ-gradients (sums over every
family and sample, taken in another order).
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
from repro.kernels import nd_fused as jnd
from repro.kernels import ref as jref
from repro.kernels.icr_refine import (
    refine_charted_adjoint_pallas,
    refine_charted_pallas,
    refine_stationary_adjoint_pallas,
    refine_stationary_pallas,
)
from repro_torch import ICR
from repro_torch.convert import matrices_to_torch, to_torch
from repro_torch.core import charts as tcharts
from repro_torch.core import kernels as tkernels
from repro_torch.core import refine as trefine
from repro_torch.kernels import icr_refine, nd_fused, ref

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


def _1d_operands(rng, *, batch, t, n_csz, n_fsz, charted):
    """coarse, xi, r, d and a fine cotangent g."""
    s = n_fsz // 2
    lead = (t,) if charted else ()
    return (rng.normal(size=(batch, (t - 1) * s + n_csz)),
            rng.normal(size=(batch, t, n_fsz)),
            rng.normal(size=lead + (n_fsz, n_csz)) / n_csz,
            rng.normal(size=lead + (n_fsz, n_fsz)) / n_fsz,
            rng.normal(size=(batch, t * n_fsz)))


STENCILS = pytest.mark.parametrize("n_csz,n_fsz", [(3, 2), (5, 4)])
ROUTES = pytest.mark.parametrize("charted", [False, True],
                                 ids=["stationary", "charted"])


# -- oracles -----------------------------------------------------------------------
@STENCILS
@ROUTES
def test_adjoint_oracles_match_reference(charted, n_csz, n_fsz):
    rng = np.random.default_rng([n_csz, int(charted), 1])
    ops = _1d_operands(rng, batch=3, t=37, n_csz=n_csz, n_fsz=n_fsz,
                       charted=charted)
    jops = [jnp.asarray(a, jnp.float32) for a in ops]
    tops = [torch.tensor(a, dtype=torch.float32) for a in ops]
    jfn = jref.refine_charted_vjp_ref if charted else \
        jref.refine_stationary_vjp_ref
    tfn = ref.refine_charted_vjp_ref if charted else \
        ref.refine_stationary_vjp_ref
    want = jfn(*jops)
    got = tfn(*tops)
    for name, g, w, tol in zip(("dcoarse", "dxi", "dr", "dd"), got, want,
                               (TOL["float32"],) * 2 + (MAT_TOL,) * 2):
        assert g.shape == w.shape, name
        assert rel(t2n(g), j2n(w)) < tol, name
    # sqrt_d=None: the noise-free variant drops dxi and dd
    dc, dxi, dr, dd = tfn(tops[0], tops[1], tops[2], None, tops[4])
    assert dxi is None and dd is None
    assert rel(t2n(dc), j2n(want[0])) < TOL["float32"]
    assert rel(t2n(dr), j2n(want[2])) < MAT_TOL


def test_overlap_add_reaches_every_covered_entry():
    """Every window entry lands once; entries past the last window stay 0."""
    dw = torch.ones(2, 5, 5)
    dc = ref.overlap_add_1d(dw, 16, 2)
    np.testing.assert_array_equal(
        t2n(dc[0]), [1, 1, 2, 2, 3, 2, 3, 2, 3, 2, 2, 1, 1, 0, 0, 0])


# -- adjoint wrappers against the Pallas adjoint kernels ---------------------------------
@pytest.mark.parametrize("charted,n_csz,n_fsz,noise,dname", [
    (charted, n_csz, n_fsz, noise, dname) for charted in (False, True)
    for noise in (True, False) for n_csz, n_fsz, dname in (
        (3, 2, "float32"), (5, 4, "float32"), (5, 4, "bfloat16"))])
def test_adjoint_plain_matches_pallas(charted, n_csz, n_fsz, noise, dname):
    """refine_*_adjoint on CPU tensors (the plain version) against
    refine_*_adjoint_pallas in interpret mode, 37 families in blocks of 8,
    with one coarse entry past the last window."""
    rng = np.random.default_rng([n_csz, int(charted), int(noise), 2])
    _, _, r, d, g = _1d_operands(rng, batch=3, t=37, n_csz=n_csz,
                                 n_fsz=n_fsz, charted=charted)
    (jg, tg), (jr, tr), (jd, td) = (pair(a, dname) for a in (g, r, d))
    length = 36 * (n_fsz // 2) + n_csz + 1
    jfn = refine_charted_adjoint_pallas if charted else \
        refine_stationary_adjoint_pallas
    tfn = icr_refine.refine_charted_adjoint if charted else \
        icr_refine.refine_stationary_adjoint
    want = jfn(jg, jr, jd if noise else None, coarse_len=length,
               n_csz=n_csz, n_fsz=n_fsz, block_families=8, interpret=True,
               noise=noise)
    got = tfn(tg, tr, td if noise else None, coarse_len=length)
    if not noise:
        want, got = (want,), (got,)
    for g_, w_ in zip(got, want):
        assert g_.dtype == DTYPES[dname][1]
        assert tuple(g_.shape) == tuple(w_.shape)
        assert rel(t2n(g_), j2n(w_)) < TOL[dname]
    assert float(got[0][:, -1].abs().max()) == 0.0


# -- autograd Functions against jax.vjp ----------------------------------------------
@pytest.mark.parametrize("charted,n_csz,n_fsz,dname", [
    (charted, n_csz, n_fsz, "float32") for charted in (False, True)
    for n_csz, n_fsz in ((3, 2), (5, 4))] + [
    (charted, 5, 4, "bfloat16") for charted in (False, True)])
def test_1d_function_backward_matches_jax_vjp(charted, n_csz, n_fsz, dname):
    """All four cotangents of refine_stationary / refine_charted."""
    rng = np.random.default_rng([n_csz, int(charted), 3])
    ops = _1d_operands(rng, batch=3, t=37, n_csz=n_csz, n_fsz=n_fsz,
                       charted=charted)
    pairs = [pair(a, dname) for a in ops]
    jops = [p[0] for p in pairs[:4]]
    jg, tg = pairs[4]
    tops = [p[1].requires_grad_(True) for p in pairs[:4]]
    jfn = refine_charted_pallas if charted else refine_stationary_pallas
    out, vjp = jax.vjp(
        lambda *a: jfn(*a, n_csz=n_csz, n_fsz=n_fsz, block_families=8,
                       interpret=True), *jops)
    want = vjp(jg.astype(out.dtype))
    tfn = icr_refine.refine_charted if charted else \
        icr_refine.refine_stationary
    got = torch.autograd.grad(tfn(*tops), tops, tg)
    mat_tol = MAT_TOL if dname == "float32" else TOL[dname]
    tols = (TOL[dname],) * 2 + (mat_tol,) * 2
    for name, g_, w_, tol in zip(("dcoarse", "dxi", "dr", "dd"), got, want,
                                 tols):
        assert g_.dtype == DTYPES[dname][1], name
        assert rel(t2n(g_), j2n(w_)) < tol, name


def test_1d_function_skips_unneeded_cotangents(monkeypatch):
    """At fixed matrices no matrix cotangent is built, and a level whose ξ
    needs no grad runs the noise-free adjoint."""
    rng = np.random.default_rng(4)
    coarse, xi, r, d, g = (torch.tensor(a, dtype=torch.float32) for a in
                           _1d_operands(rng, batch=2, t=9, n_csz=3, n_fsz=2,
                                        charted=False))
    calls = []
    plain = icr_refine.refine_stationary_adjoint_plain

    def spy(g, r, d=None, *, coarse_len):
        calls.append(d is None)
        return plain(g, r, d, coarse_len=coarse_len)

    def refuse(*args, **kw):
        raise AssertionError("matrix cotangents built at fixed matrices")

    monkeypatch.setattr(icr_refine, "refine_stationary_adjoint_plain", spy)
    monkeypatch.setattr(icr_refine, "matrix_cotangents_1d", refuse)
    coarse.requires_grad_(True)
    out = icr_refine.refine_stationary(coarse, xi, r, d)
    (dc,) = torch.autograd.grad(out, (coarse,), g)
    assert calls == [True]
    want = ref.refine_stationary_vjp_ref(None, None, r, None, g,
                                         coarse_len=coarse.shape[-1])[0]
    torch.testing.assert_close(dc, want)


# small dust and log-polar charts: every level, with the port's factors
# (the level is linear in field and ξ, so any factors serve)
ND_CHARTS = {
    "dust": (lambda m: m.galactic_dust_chart((6, 8, 8), 2), 0.5),
    "log_polar": (lambda m: m.log_polar_chart((8, 8), 2), 1.0),
}


@pytest.mark.parametrize("name", sorted(ND_CHARTS))
def test_nd_function_backward_matches_jax_vjp(name, dname="float32"):
    build_chart, rho = ND_CHARTS[name]
    jc, tc = build_chart(jcharts), build_chart(tcharts)
    k = tkernels.matern32.with_defaults(rho=rho)()
    rng = np.random.default_rng([len(name), 5])
    for lvl in range(jc.n_levels):
        geom = jrefine.LevelGeom.for_level(jc, lvl)
        rs, ds = trefine.axis_refinement_matrices_level(tc, k, lvl,
                                                        device="cpu")
        n_fine = int(np.prod(geom.fine_shape))
        field, tfield = pair(rng.normal(size=(1,) + geom.coarse_shape), dname)
        xi, txi = pair(rng.normal(size=(1, int(np.prod(geom.T)),
                                        geom.n_fsz ** len(geom.T))), dname)
        g, tg = pair(rng.normal(size=(1, n_fine)), dname)
        jrs = [jnp.asarray(m.numpy(), DTYPES[dname][0]) for m in rs]
        jds = [jnp.asarray(m.numpy(), DTYPES[dname][0]) for m in ds]
        out, vjp = jax.vjp(
            lambda f, x: jnd.refine_nd_fused(f, x, jrs, jds, geom,
                                             sample_axis=True,
                                             interpret=True), field, xi)
        want = vjp(g.reshape(out.shape))
        tfield.requires_grad_(True)
        txi.requires_grad_(True)
        tout = nd_fused.refine_nd_fused(
            tfield, txi, [to_torch(np.asarray(m), device="cpu") for m in jrs],
            [to_torch(np.asarray(m), device="cpu") for m in jds],
            trefine.LevelGeom.for_level(tc, lvl), sample_axis=True)
        got = torch.autograd.grad(tout, (tfield, txi), tg.reshape(tout.shape))
        for g_, w_ in zip(got, want):
            assert g_.dtype == DTYPES[dname][1]
            assert rel(t2n(g_), j2n(w_)) < TOL[dname], (name, lvl)


def test_nd_learned_factors_raise():
    c = tcharts.regular_chart((8, 8), 1)
    geom = trefine.LevelGeom.for_level(c, 0)
    rs = [torch.randn(2, 3, requires_grad=True), torch.randn(2, 3)]
    ds = [torch.randn(2, 2), torch.randn(2, 2)]
    with pytest.raises(NotImplementedError, match="learned θ"):
        nd_fused.refine_nd_fused(torch.randn(8, 8), torch.randn(36, 4), rs,
                                 ds, geom)


def test_reflect_pad_transpose():
    """⟨pad(x), y⟩ = ⟨x, padᵀ(y)⟩ on a 2-D field."""
    x = torch.randn(3, 7, 9, dtype=torch.float64)
    y = torch.randn(3, 11, 13, dtype=torch.float64)
    lhs = (trefine.reflect_pad(x, 2, 2) * y).sum()
    rhs = (x * trefine.reflect_pad_T(y, 2, 2)).sum()
    torch.testing.assert_close(lhs, rhs)


# -- ICR.apply_sqrt_T -------------------------------------------------------------
T_CHARTS = {
    "regular": (lambda m: m.regular_chart(64, 3, boundary="reflect"), 8.0),
    "log": (lambda m: m.log_chart(12, 3, n_csz=5, n_fsz=4, delta0=0.05),
            0.3),
    "dust": (lambda m: m.galactic_dust_chart((6, 8, 8), n_levels=2), 0.5),
    "log_polar": (lambda m: m.log_polar_chart((8, 8), 2), 1.0),
}


@pytest.mark.parametrize("name,pol", [
    ("regular", None), ("log", None), ("dust", None), ("log_polar", None),
    ("dust", "bf16"), ("log_polar", "bf16")])
def test_apply_sqrt_T_matches_reference(name, pol):
    build_chart, rho = T_CHARTS[name]
    jicr = JICR(build_chart(jcharts), jkernels.matern32.with_defaults(rho=rho),
                use_pallas=True, dtype_policy=pol)
    ticr = ICR(build_chart(tcharts), tkernels.matern32.with_defaults(rho=rho),
               use_pallas=True, dtype_policy=pol, device="cpu")
    mats = jax.jit(jicr.matrices)()
    storage = jicr.policy.storage_dtype
    v = np.random.default_rng(6).normal(size=jicr.out_shape)
    want = jicr.apply_sqrt_T(mats, jnp.asarray(v, storage))
    got = ticr.apply_sqrt_T(
        matrices_to_torch(jax.tree.map(np.asarray, mats), device="cpu"),
        to_torch(np.asarray(jnp.asarray(v, storage)), device="cpu"))
    assert [tuple(x.shape) for x in got] == [tuple(s)
                                             for s in ticr.xi_shapes()]
    for g_, w_ in zip(got, want):
        assert g_.dtype == ticr.policy.storage_dtype
        assert rel(t2n(g_), j2n(w_)) < (TOL["float32"] if pol is None
                                        else TOL["bfloat16"])


@pytest.mark.parametrize("name", ["regular", "log"])
def test_theta_gradient_of_quadratic_form(name):
    """d/dρ of vᵀ K_ICR(ρ) v = ‖sqrt(K_ICR)ᵀ v‖², sign-free, on a shrink
    1-D chart: through ``implicit_sqrt`` on the kernel route (the matrix
    cotangents of the 1-D Functions) against jax.grad on the reference."""
    build = {"regular": lambda m: m.regular_chart(12, 2),
             "log": lambda m: m.log_chart(12, 2, n_csz=5, n_fsz=4,
                                          delta0=0.05)}[name]
    rho0 = {"regular": 6.0, "log": 0.4}[name]
    jicr = JICR(build(jcharts), jkernels.matern32, use_pallas=False)
    ticr = ICR(build(tcharts), tkernels.matern32, use_pallas=True,
               device="cpu")
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
