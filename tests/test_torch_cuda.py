"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA card: the kernels are compiled by ``nvcc``
and run only there, so without one each test skips with that reason. The
file imports torch and the port only (no JAX), so that it also runs where
the JAX package is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, relative to the largest magnitude of the plain version: 1e-5
at float32 (the sums run in another order), 5e-2 with bfloat16 storage
(one rounding of the output may land on the other side).
"""
import itertools
import json

import numpy as np
import pytest
import torch

from repro_torch import ICR
from repro_torch.core import charts, graphs, kernels
from repro_torch.core import icr as icr_core
from repro_torch.core import refine as trefine
from repro_torch.kernels import (build, dispatch, icr_refine, nd_fused,
                                 pyramid)
from repro_torch.kernels.policy import tree_leaves

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rel(got, want) -> float:
    diff = (got.double() - want.double()).abs().max()
    return float(diff / want.double().abs().max().clamp_min(1e-30))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled and run "
                    "only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def to_device(tree, device):
    """Every tensor of a nested dict/list on `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def on_card_at(a, dt, device, offset=0):
    """`a` on the card in storage dtype `dt`, as a contiguous view that
    starts `offset` elements into its allocation (so, for offset > 0, off
    a 16-byte boundary)."""
    flat = torch.empty(offset + a.size, dtype=dt, device=device)
    view = flat[offset:].view(a.shape)
    view.copy_(torch.tensor(a, dtype=torch.float32))
    return view


# (batch, families, extra coarse entries, storage offset) of the 1-D card
# tests: a ragged last block of a long row; short rows packed several to a
# block, with a batch that is no multiple of the rows per block; row
# lengths and operand starts off a 16-byte boundary; one family
ROW_CASES = ((5, 1001, 3, 0), (300, 33, 3, 0), (1, 1, 3, 0), (37, 32, 0, 1),
             (37, 32, 1, 3), (64, 17, 2, 2))
# the adjoints also at the charted adjoint's two main-path shapes, where a
# thread holds its families' stencils for several rows: 8 long rows, and
# very many short ones
ADJOINT_ROW_CASES = ROW_CASES + ((8, 70001, 3, 1), (40000, 16, 4, 2))
# the charted forward also at its two main-path shapes: the log chart's
# last level (8 long rows, several a thread) and the nd-axes route's
# axis-0 pass (very many short rows)
CHARTED_ROW_CASES = ROW_CASES + ((8, 65026, 3, 1), (16384, 16, 4, 2))


def _1d_operands(rng, *, batch, t, n_csz, n_fsz, charted):
    s = n_fsz // 2
    lead = (t,) if charted else ()
    return (rng.normal(size=(batch, (t - 1) * s + n_csz)),
            rng.normal(size=(batch, t, n_fsz)),
            rng.normal(size=lead + (n_fsz, n_csz)) / n_csz,
            rng.normal(size=lead + (n_fsz, n_fsz)) / n_fsz)


@pytest.mark.cuda
@pytest.mark.parametrize("dname", sorted(TOL))
def test_cuda_kernels_match_plain(cuda, dname):
    """Each CUDA kernel against its plain version on the same card: the
    stationary one at a family count that leaves a ragged last block, the
    charted one (#3) at every ``CHARTED_ROW_CASES`` entry (extra coarse
    entries, operands off a 16-byte boundary, its main-path shapes) and
    the runtime-size stencil (3, 8) besides the charts' two."""
    rng = np.random.default_rng(9)
    dt = DTYPES[dname]
    cases = [(False, stencil, (batch, t, 0, offset))
             for stencil, (batch, t, _, offset) in itertools.product(
                 ((5, 4), (3, 2)), ((5, 1001, 0, 0), ROW_CASES[4]))]
    cases += [(True, stencil, case) for stencil, case in itertools.product(
        ((5, 4), (3, 2), (3, 8)), CHARTED_ROW_CASES)]
    for charted, (n_csz, n_fsz), (batch, t, extra, offset) in cases:
        coarse, xi, r, d = _1d_operands(rng, batch=batch, t=t, n_csz=n_csz,
                                        n_fsz=n_fsz, charted=charted)
        coarse = np.concatenate([coarse, rng.normal(size=(batch, extra))],
                                axis=1)
        ops = [on_card_at(a, dt, cuda, offset) for a in (coarse, xi, r, d)]
        route = "charted-1d" if charted else "stationary-1d"
        before = build.LAUNCHES[dispatch.KERNEL_OF_ROUTE[route]]
        got = dispatch.KERNELS[route](*ops)
        assert build.LAUNCHES[dispatch.KERNEL_OF_ROUTE[route]] == before + 1
        want = dispatch.PLAIN[route](*ops)
        assert got.dtype == dt and got.shape == (batch, t * n_fsz)
        assert rel(got, want) < TOL[dname], (charted, n_fsz, batch, t)
    c = charts.galactic_dust_chart((8, 16, 16), 2)
    geom = trefine.LevelGeom.for_level(c, 1)
    rs, ds = trefine.axis_refinement_matrices_level(
        c, kernels.matern32.with_defaults(rho=0.5)(), 1, device=cuda)
    field = torch.randn((3,) + geom.coarse_shape, device=cuda).to(dt)
    xi = torch.randn(3, int(np.prod(geom.T)), 64, device=cuda).to(dt)
    args = nd_fused.nd_operands(field, xi, [r.to(dt) for r in rs],
                                [d.to(dt) for d in ds], geom,
                                sample_axis=True)
    got = nd_fused.refine_nd_fused_core(*args)
    want = nd_fused.refine_nd_fused_plain(*args)
    assert rel(got, want) < TOL[dname]


@pytest.mark.cuda
@pytest.mark.parametrize("pol", [None, "bf16"], ids=["fp32", "bf16"])
def test_whole_slice_on_the_card(cuda, pol):
    """The kernel route on the card against the plain path on the CPU,
    with the same matrices and ξ."""
    cases = [
        (charts.regular_chart(64, 3, boundary="reflect"), 8.0),
        (charts.regular_chart((16, 16), 2, boundary="reflect"), 4.0),
        (charts.galactic_dust_chart((6, 8, 8), n_levels=2), 0.5),
        (charts.log_chart(12, 3, n_csz=5, n_fsz=4, delta0=0.05), 0.3),
    ]
    for chart, rho in cases:
        kern = kernels.matern32.with_defaults(rho=rho)
        cpu = ICR(chart, kern, use_pallas=True, dtype_policy=pol,
                  device="cpu")
        gpu = ICR(chart, kern, use_pallas=True, dtype_policy=pol)
        mats = cpu.matrices()
        xi = cpu.init_xi(torch.Generator().manual_seed(0), batch=4)
        want = cpu.apply_sqrt_batch(mats, xi)
        build.LAUNCHES.clear()
        got = gpu.apply_sqrt_batch(to_device(mats, cuda),
                                   to_device(xi, cuda))
        # one pyramid launch for the covered prefix, one per other level
        cover = dispatch.pyramid_cover(
            chart, samples=4, itemsize=gpu.policy.storage_dtype.itemsize)
        assert build.LAUNCHES["refine_pyramid"] == int(cover is not None)
        assert sum(build.LAUNCHES.values()) == (
            chart.n_levels - (cover or 1) + 1)
        assert rel(got.cpu(), want) < TOL["float32" if pol is None
                                          else "bfloat16"]


def shifted(t, offset):
    """`t` copied into a contiguous view that starts `offset` elements
    into its allocation (off a 16-byte boundary for offset > 0)."""
    flat = torch.empty(offset + t.numel(), dtype=t.dtype, device=t.device)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


# N-D card cases: (chart, samples). Ragged last tiles; a fine trailing
# extent that is no multiple of 4 (n_fsz = 2 and an odd family count), in
# 2-D and 3-D; reflect padding on every axis; a batch of 37
ND_CASES = [
    (charts.regular_chart((300, 260), 1), 3),
    (charts.regular_chart((12, 14), 1, boundary="reflect"), 3),
    (charts.regular_chart((9, 21, 40), 1, n_csz=5, n_fsz=4), 3),
    (charts.regular_chart((10, 21), 1), 37),
    (charts.regular_chart((7, 9, 11), 1), 3),
    (charts.regular_chart((6, 8, 10), 1, n_csz=5, n_fsz=4,
                          boundary="reflect"), 37),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dname", sorted(TOL))
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_nd_fused_charted_axes_on_the_card(cuda, dname, offset):
    """2-D and 3-D levels with per-family factors on every axis (random
    factors: the kernel is linear in them) at the ``ND_CASES``, every
    operand starting `offset` elements into its allocation."""
    rng = np.random.default_rng(10)
    dt = DTYPES[dname]
    for chart, n_s in ND_CASES:
        geom = trefine.LevelGeom.for_level(chart, 0)
        f, c = geom.n_fsz, geom.n_csz
        rs = [rng.normal(size=(t, f, c)) / c for t in geom.T]
        ds = [rng.normal(size=(t, f, f)) / f for t in geom.T]
        field = rng.normal(size=(n_s,) + geom.coarse_shape)
        xi = rng.normal(size=(n_s, int(np.prod(geom.T)), f ** len(geom.T)))

        def on_card(a):
            return torch.tensor(a, dtype=torch.float32, device=cuda).to(dt)

        field, xi0, r0, d0, rts, T = nd_fused.nd_operands(
            on_card(field), on_card(xi), [on_card(r) for r in rs],
            [on_card(d) for d in ds], geom, sample_axis=True)
        args = (shifted(field, offset), shifted(xi0, offset),
                shifted(r0, offset), shifted(d0, offset),
                tuple(shifted(r, offset) for r in rts), T)
        got = nd_fused.refine_nd_fused_core(*args)
        want = nd_fused.refine_nd_fused_plain(*args)
        assert rel(got, want) < TOL[dname], (chart.shape0, n_s)


ADJOINTS = {
    False: (icr_refine.refine_stationary_adjoint,
            icr_refine.refine_stationary_adjoint_plain),
    True: (icr_refine.refine_charted_adjoint,
           icr_refine.refine_charted_adjoint_plain),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dname", sorted(TOL))
@pytest.mark.parametrize("n_csz,n_fsz", [(3, 2), (5, 4), (3, 8)])
def test_cuda_adjoint_kernels_match_plain(cuda, n_csz, n_fsz, dname):
    """The four adjoint kernels (stationary/charted, with and without ξ)
    against their plain versions, at the ``ROW_CASES``: ragged last
    blocks, short rows packed several to a block, rows and operands that
    start off a 16-byte boundary, and a coarse tail past the last window
    that must come back zero; and (``ADJOINT_ROW_CASES``) the charted
    adjoint's long and many short rows, several rows to a thread."""
    rng = np.random.default_rng([n_csz, n_fsz, 12])
    dt = DTYPES[dname]
    s = n_fsz // 2

    for charted in (False, True):
        kern, plain = ADJOINTS[charted]
        for batch, t, extra, offset in ADJOINT_ROW_CASES:
            lead = (t,) if charted else ()

            def on_card(a):
                return on_card_at(a, dt, cuda, offset)

            g = on_card(rng.normal(size=(batch, t * n_fsz)))
            r = on_card(rng.normal(size=lead + (n_fsz, n_csz)) / n_csz)
            d = on_card(rng.normal(size=lead + (n_fsz, n_fsz)) / n_fsz)
            length = (t - 1) * s + n_csz + extra
            for noise in (True, False):
                name = (("refine_charted_adjoint" if charted
                         else "refine_stationary_adjoint")
                        + ("" if noise else "_nn"))
                before = build.LAUNCHES[name]
                got = kern(g, r, d if noise else None, coarse_len=length)
                assert build.LAUNCHES[name] == before + 1
                want = plain(g, r, d if noise else None, coarse_len=length)
                if not noise:
                    got, want = (got,), (want,)
                for a, b in zip(got, want):
                    assert a.dtype == dt
                    assert rel(a, b) < TOL[dname], (charted, batch, t, noise)
                if extra:
                    assert float(got[0][:, -extra:].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("pol", [None, "bf16"], ids=["fp32", "bf16"])
def test_transpose_on_the_card(cuda, pol):
    """⟨A x, y⟩ = ⟨x, Aᵀ y⟩ of apply_sqrt_batch and apply_sqrt_T_batch on
    the kernel route, on every route (1-D stationary and charted, N-D with
    invariant and charted trailing axes), and gradients of a loss through
    the kernels against the same through the plain path on the CPU."""
    cases = [
        (charts.regular_chart(64, 3, boundary="reflect"), 8.0),
        (charts.log_chart(12, 3, n_csz=5, n_fsz=4, delta0=0.05), 0.3),
        (charts.galactic_dust_chart((6, 8, 8), n_levels=2), 0.5),
        (charts.log_polar_chart((8, 8), 2), 1.0),
    ]
    tol = TOL["float32" if pol is None else "bfloat16"]
    for chart, rho in cases:
        kern = kernels.matern32.with_defaults(rho=rho)
        gpu = ICR(chart, kern, use_pallas=True, dtype_policy=pol)
        mats = gpu.matrices()
        gen = torch.Generator(device=cuda).manual_seed(0)
        x = gpu.init_xi(gen, batch=3)
        y = torch.randn((3,) + gpu.out_shape, generator=gen,
                        device=cuda).to(gpu.policy.storage_dtype)
        ax = gpu.apply_sqrt_batch(mats, x)
        aty = gpu.apply_sqrt_T_batch(mats, y)
        lhs = float((ax.double() * y.double()).sum())
        rhs = sum(float((a.double() * b.double()).sum())
                  for a, b in zip(x, aty))
        # relative to the sum of the products' magnitudes: the inner
        # products cancel
        scale = float((ax.double().abs() * y.double().abs()).sum())
        assert abs(lhs - rhs) <= tol * scale, chart
        cpu = ICR(chart, kern, use_pallas=True, dtype_policy=pol,
                  device="cpu")
        xc = [t.cpu().requires_grad_(True) for t in x]
        xg = [t.clone().requires_grad_(True) for t in x]
        want = torch.autograd.grad(
            (cpu.apply_sqrt_batch(to_device(mats, "cpu"), xc).float() ** 2)
            .sum(), xc)
        build.LAUNCHES.clear()
        got = torch.autograd.grad(
            (gpu.apply_sqrt_batch(mats, xg).float() ** 2).sum(), xg)
        assert sum(v for k, v in build.LAUNCHES.items()
                   if "adjoint" in k) >= chart.n_levels
        for a, b in zip(got, want):
            assert rel(a.cpu(), b) < tol, chart


@pytest.mark.cuda
@pytest.mark.parametrize("dname", sorted(TOL))
@pytest.mark.parametrize("n_csz,n_fsz", [(3, 2), (5, 4), (3, 8)])
def test_cuda_noise_free_kernels_match_plain(cuda, n_csz, n_fsz, dname):
    """The noise-free forward kernels (#2 stationary, #4 charted) against
    their plain versions, at the ``ROW_CASES``: ragged last blocks, short
    rows packed several to a block, rows and operands that start off a
    16-byte boundary, and one family; #4 also at the charted forward's
    main-path shapes (``CHARTED_ROW_CASES``)."""
    rng = np.random.default_rng([n_csz, n_fsz, 13])
    dt = DTYPES[dname]
    s = n_fsz // 2

    for charted in (False, True):
        for batch, t, extra, offset in (CHARTED_ROW_CASES if charted
                                        else ROW_CASES):
            lead = (t,) if charted else ()

            def on_card(a):
                return on_card_at(a, dt, cuda, offset)

            coarse = on_card(rng.normal(
                size=(batch, (t - 1) * s + n_csz + extra)))
            r = on_card(rng.normal(size=lead + (n_fsz, n_csz)) / n_csz)
            name = "refine_charted_nn" if charted else "refine_stationary_nn"
            before = build.LAUNCHES[name]
            if charted:
                got = icr_refine.refine_charted_nn(coarse, r)
                want = icr_refine.refine_charted_nn_plain(coarse, r)
            else:
                got = icr_refine.refine_stationary_nn(coarse, r, t)
                want = icr_refine.refine_stationary_nn_plain(coarse, r, t)
            assert build.LAUNCHES[name] == before + 1
            assert got.dtype == dt and got.shape == (batch, t * n_fsz)
            assert rel(got, want) < TOL[dname], (charted, batch, t)


# small charts with ragged levels: 1-D stationary at every stencil the
# pyramid has an instance for ((2, 3), (4, 5), and (8, 3) on the runtime-size
# one) with ragged last runs, 1-D charted, 2-D with charted axes, 3-D with a
# charted axis 0; reflect and shrink boundaries
PYRAMID_CHARTS = [
    (charts.regular_chart(100, 3, boundary="reflect"), 8.0),
    (charts.regular_chart(38, 3, n_csz=5, n_fsz=4, boundary="reflect"), 8.0),
    (charts.regular_chart(28, 3, n_csz=3, n_fsz=8, boundary="reflect"), 6.0),
    (charts.log_chart(12, 3, n_csz=5, n_fsz=4, delta0=0.05), 0.3),
    (charts.log_polar_chart((8, 8), 2), 1.0),
    (charts.regular_chart((12, 14), 2, boundary="reflect"), 4.0),
    (charts.galactic_dust_chart((6, 8, 12), 2, delta_logr=0.2), 0.5),
    (charts.regular_chart((6, 8, 10), 2, n_csz=5, n_fsz=4,
                          boundary="reflect"), 3.0),
]


def _pyramid_case(chart, rho, dt, device, n_s=3):
    """Every level of `chart` as one pyramid: geometries, operands and the
    per-level factors, with seeded ξ, on `device` in storage dtype `dt`."""
    icr = ICR(chart, kernels.matern32.with_defaults(rho=rho),
              use_pallas=True, device="cpu")
    mats = icr.matrices()
    geoms = [trefine.LevelGeom.for_level(chart, lvl)
             for lvl in range(chart.n_levels)]
    pmats = [((mats["Rax"][lvl], mats["sqrtDax"][lvl]) if "Rax" in mats
              else icr_core._pyramid_mats(mats, g, lvl))
             for lvl, g in enumerate(geoms)]
    pmats = [([r.to(device, dt) for r in rs], [d.to(device, dt) for d in ds])
             for rs, ds in pmats]
    gen = torch.Generator().manual_seed(4)
    field = torch.randn((n_s,) + geoms[0].coarse_shape, generator=gen)
    xis = [torch.randn((n_s,) + s, generator=gen)
           for s in icr.xi_shapes()[1:]]
    field, xis = field.to(device, dt), [x.to(device, dt) for x in xis]
    return geoms, field, xis, pmats


@pytest.mark.cuda
@pytest.mark.parametrize("dname", sorted(TOL))
def test_cuda_pyramid_matches_plain(cuda, dname):
    """The pyramid (#10) against its plain version at every level of
    small charts with ragged levels and edge tiles that reflect on every
    axis, on the co-resident grid and on grids of 3 blocks and of 1 that
    must stride over the tiles; a two-level cover too."""
    dt = DTYPES[dname]
    for chart, rho in PYRAMID_CHARTS:
        geoms, field, xis, pmats = _pyramid_case(chart, rho, dt, cuda)
        for k in sorted({2, len(geoms)}):
            f, levels = pyramid.pyramid_operands(field, xis[:k], pmats[:k],
                                                 geoms[:k], sample_axis=True)
            want = pyramid.refine_pyramid_plain(f, geoms[:k], levels)
            for max_blocks in (0, 3, 1):
                before = build.LAUNCHES["refine_pyramid"]
                got = pyramid.refine_pyramid_core(f, geoms[:k], levels,
                                                  max_blocks=max_blocks)
                assert build.LAUNCHES["refine_pyramid"] == before + 1
                assert 0 < pyramid.last_grid <= (max_blocks or 10**6)
                assert got.dtype == dt and got.shape == want.shape
                assert rel(got, want) < TOL[dname], (chart, k, max_blocks)


# charted 1-D charts at the three pyramid instances' stencils ((4, 5),
# (2, 3) and the runtime-size (8, 3)), shrink and reflect boundaries
CHARTED_1D_CHARTS = [
    charts.log_chart(12, 3, n_csz=5, n_fsz=4, delta0=0.05),
    charts.log_chart(30, 3, delta0=0.05, boundary="reflect"),
    charts.log_chart(16, 2, n_csz=3, n_fsz=8, delta0=0.05,
                     boundary="reflect"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dname", sorted(TOL))
@pytest.mark.parametrize("threads", [None, 8], ids=["default", "few"])
def test_cuda_pyramid_charted_levels_equal_per_level_kernel(
        cuda, dname, threads, monkeypatch):
    """A charted 1-D chart's pyramid levels run #3's streaming body, as the
    per-level kernel does: the same sums in the same order, so the pyramid
    equals the per-level kernels on the same operands bit for bit, also
    when a thread takes several rows (few threads aimed for)."""
    if threads:
        monkeypatch.setattr(icr_refine, "CHARTED_THREADS", threads)
    dt = DTYPES[dname]
    n_s = 5
    for chart in CHARTED_1D_CHARTS:
        geoms, field, xis, pmats = _pyramid_case(chart, 0.3, dt, cuda, n_s)
        f, levels = pyramid.pyramid_operands(field, xis, pmats, geoms,
                                             sample_axis=True)
        got = pyramid.refine_pyramid_core(f, geoms, levels)
        x = f
        for geom, (xi0, rs, d0) in zip(geoms, levels):
            if geom.boundary == "reflect":
                x = trefine.reflect_pad(x, geom.b, 1)
            x = icr_refine.refine_charted(
                x.contiguous(), xi0.reshape(n_s, geom.T[0], geom.n_fsz),
                rs[0], d0)
        assert torch.equal(got, x.reshape(got.shape)), chart


@pytest.mark.cuda
@pytest.mark.parametrize("pol", [None, "bf16"], ids=["fp32", "bf16"])
def test_cuda_pyramid_matches_per_level_chain(cuda, pol):
    """ICR with the pyramid against the per-level kernels on the card:
    the same bodies, so the same fields; the pyramid launches where the
    cover rule takes the chart (1-D stationary levels)."""
    tol = TOL["float32" if pol is None else "bfloat16"]
    for chart, rho in PYRAMID_CHARTS:
        kern = kernels.matern32.with_defaults(rho=rho)
        on = ICR(chart, kern, use_pallas=True, dtype_policy=pol)
        off = ICR(chart, kern, use_pallas=True, dtype_policy=pol,
                  use_pyramid=False)
        mats = on.matrices()
        xi = on.init_xi(torch.Generator(device=cuda).manual_seed(1), batch=4)
        build.LAUNCHES.clear()
        got = on.apply_sqrt_batch(mats, xi)
        cover = dispatch.pyramid_cover(
            chart, samples=4, itemsize=on.policy.storage_dtype.itemsize)
        assert build.LAUNCHES["refine_pyramid"] == int(cover is not None)
        want = off.apply_sqrt_batch(mats, xi)
        assert rel(got, want) < tol, chart


@pytest.mark.cuda
def test_cuda_pyramid_transpose(cuda):
    """⟨A x, y⟩ = ⟨x, Aᵀ y⟩ of the pyramid at fixed matrices, A its
    launch and Aᵀ its backward (the adjoint kernels over its levels), in
    (field, ξ0), at float32."""
    for chart, rho in PYRAMID_CHARTS:
        geoms, field, xis, pmats = _pyramid_case(chart, rho, torch.float32,
                                                 cuda)
        f, levels = pyramid.pyramid_operands(field, xis, pmats, geoms,
                                             sample_axis=True)
        inputs = [f.requires_grad_(True)] + [
            lv[0].detach().requires_grad_(True) for lv in levels]
        levels = [(x,) + lv[1:] for x, lv in zip(inputs[1:], levels)]
        ax = pyramid.refine_pyramid_core(inputs[0], geoms, levels)
        y = torch.randn_like(ax)
        build.LAUNCHES.clear()
        aty = torch.autograd.grad(ax, inputs, y)
        assert build.LAUNCHES["refine_pyramid"] == 0
        assert sum(v for k, v in build.LAUNCHES.items()
                   if "adjoint" in k) >= len(geoms)
        lhs = float((ax.double() * y.double()).sum())
        rhs = sum(float((a.double() * b.double()).sum())
                  for a, b in zip(inputs, aty))
        scale = float((ax.double().abs() * y.double().abs()).sum())
        assert abs(lhs - rhs) <= 1e-5 * scale, chart


@pytest.mark.cuda
def test_cuda_learned_theta_through_kernels(cuda):
    """The factors' cotangents through the pyramid's replay (nd-axes on
    N-D charts, the noise-free kernels included) on the card, against the
    same loss through the plain path on the CPU, with the same matrices."""
    for chart, rho in PYRAMID_CHARTS:
        kern = kernels.matern32.with_defaults(rho=rho)
        cpu = ICR(chart, kern, use_pallas=True, device="cpu")
        gpu = ICR(chart, kern, use_pallas=True)
        mats = cpu.matrices()
        xi = cpu.init_xi(torch.Generator().manual_seed(2), batch=2)
        grads = []
        for icr, dev in ((cpu, "cpu"), (gpu, cuda)):
            m = {k: [[t.detach().to(dev).requires_grad_(True) for t in lvl]
                     if isinstance(lvl, list) else
                     lvl.detach().to(dev).requires_grad_(True) for lvl in v]
                 if isinstance(v, list) else v.to(dev)
                 for k, v in mats.items()}
            leaves = tree_leaves({k: v for k, v in m.items()
                                  if k != "sqrt0"})
            build.LAUNCHES.clear()
            out = icr.apply_sqrt_batch(m, to_device(xi, dev))
            grads.append(torch.autograd.grad((out ** 2).sum(), leaves))
        nn = ("refine_charted_nn", "refine_stationary_nn")
        assert chart.ndim == 1 or sum(build.LAUNCHES[k] for k in nn) > 0
        for a, b in zip(grads[1], grads[0]):
            assert rel(a.cpu(), b) < 1e-4, chart


@pytest.mark.cuda
def test_cuda_theta_gradient_matches_float64(cuda):
    """dρ of a Gaussian loss, matrices built from ρ on the card and the
    field through the kernels in float32, against the same loss on the
    CPU in float64 (matrices and plain versions). The symmetric square
    root's divided-difference backward keeps it reproducible; float32
    leaves the rounding of the level-0 eigenvalues near the clip."""
    for chart, rho in PYRAMID_CHARTS:
        got = []
        for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
            icr = ICR(chart, kernels.matern32, use_pallas=True, device=dev)
            gen = torch.Generator().manual_seed(3)
            xi = [0.5 * x.to(dev, dtype) for x in ICR(
                chart, kernels.matern32, device="cpu").init_xi(gen)]
            y = torch.randn(icr.out_shape, generator=gen).to(dev, dtype)
            r = torch.tensor(rho, dtype=dtype, device=dev,
                             requires_grad=True)
            mats = icr.matrices({"rho": r, "sigma": 1.0}, dtype=dtype)
            loss = 0.5 * torch.sum(torch.square(icr.apply_sqrt(mats, xi) - y)
                                   / 0.01)
            got.append(float(torch.autograd.grad(loss, r)[0]))
        assert abs(got[0] - got[1]) <= 1e-2 * abs(got[1]), (chart, got)


@pytest.mark.cuda
def test_cuda_pyramid_reads_fields_through_l2(cuda, tmp_path):
    """Every pyramid instance (1-D and N-D levels, three stencils, both
    storage dtypes) loads the fields that other blocks wrote before
    ``grid.sync()`` through the L2 only: ``ld.cg`` (SASS
    ``LDG.E[.64|.128|.U16].STRONG.GPU``, or ``LD.E...STRONG.GPU`` where
    nvcc keeps the address generic), or an asynchronous copy that bypasses
    L1 (``LDGSTS...BYPASS``). Since SASS does not say which
    pointer a load reads, every global load of the kernel must take such a
    path: the read-only path (``LDG.E.CONSTANT``, which ``__restrict__``
    lets nvcc pick) and L1-cached loads are undefined for data written
    during the launch."""
    import re
    import subprocess
    from pathlib import Path

    cubin = tmp_path / "pyramid.cubin"
    nvcc = build.nvcc()
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-cubin", "-o", str(cubin),
                    str(build.CSRC / "pyramid.cu")], check=True)
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    loads = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"\b(LDGSTS|LDG|LD)(?![A-Z])(\.[A-Z0-9_]+)*", line)
        if m and fn and "refine_pyramid_kernel" in fn:
            loads.setdefault(fn, []).append(m.group(0))
    assert len(loads) == 12, sorted(loads)
    for fn, kinds in loads.items():
        assert kinds, fn
        for k in kinds:
            assert (k.startswith(("LDG.", "LD.")) and ".STRONG.GPU" in k) \
                or (k.startswith("LDGSTS.") and ".BYPASS" in k), (fn, k)


# -- serving: one captured CUDA graph per slab ----------------------------------
SERVE_CHARTS = ((charts.regular_chart(1024, 10, boundary="reflect"), 5000.0),
                (charts.galactic_dust_chart((8, 16, 16), 3), 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("pol", [None, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", [0, 1], ids=["regular", "dust"])
def test_cuda_served_slab_is_one_graph_equal_to_eager(cuda, case, pol):
    """A slab of ``GPFieldServer`` on the card is one replay of its
    captured graph, whose kernel nodes (counted by name at capture) are
    the plan's launches (the pyramid's cooperative launch among them on
    regular); every replay counts them once. The replay equals bit for
    bit the eager slab on the same buffers and the eager kernel route on
    the same ξ; warm traffic captures no graph."""
    import collections

    from repro_torch.kernels import build
    from repro_torch.launch import serve_gp as sg

    chart, rho = SERVE_CHARTS[case]
    post = sg.demo_posterior(chart, rho, dtype_policy=pol)
    build.LAUNCHES.clear()
    srv = sg.GPFieldServer(post, slab=4)
    entry = srv._entry
    assert entry["fn"].graph is not None
    want = collections.Counter()
    for e in entry["plan"]:
        want[e["kernel"]] += e["launches"]
    assert entry["fn"].launches == +want
    srv.run(sg.mixed_requests(2, 5))
    srv.run(sg.mixed_requests(2, 5))
    m = srv.metrics()
    assert (m["graph_captures"], m["cache_misses"], m["cache_hits"]) \
        == (1, 1, 2)
    # the capture's eager warm-up, then one replay per slab attempt; the
    # posterior's matrix build, before, launched the eigensolver
    runs = 1 + m["slabs_attempted"]
    built = build.LAUNCHES.pop("sym_eig", 0)
    assert built > 0
    assert +build.LAUNCHES == {k: n * runs for k, n in want.items() if n}
    assert m["mode"] == "single:cuda-graph"
    graph = entry["fn"]().clone()
    eager = entry["slab_fn"](*entry["args"])
    assert torch.equal(graph, eager)
    xi = entry["draw"](*entry["args"])
    icr = srv.posterior.icr
    assert torch.equal(graph, icr.apply_sqrt_batch(entry["mats"], xi).float())


@pytest.mark.cuda
def test_cuda_cache_hit_copies_the_new_q_parameters(cuda):
    """The graph baked in the addresses of the entry's mean/std buffers: a
    hit after ``set_posterior`` with a new mean serves that mean (it was
    copied into the buffers, not rebound)."""
    import dataclasses

    from repro_torch.launch import serve_gp as sg

    chart, rho = SERVE_CHARTS[0]
    post = sg.demo_posterior(chart, rho)
    srv = sg.GPFieldServer(post, slab=4)
    new = dataclasses.replace(post, mean=[m + 0.5 for m in post.mean],
                              log_std=None)
    srv.set_posterior(new)
    req = sg.GPRequest(kind="moments", n=3, seed=2)
    srv.run([req])
    assert (srv.cache_misses, srv.cache_hits, srv.graph_captures) \
        == (1, 2, 1)
    want = post.icr.apply_sqrt(post.icr.matrices_cached(), new.mean)
    assert rel(torch.from_numpy(req.mean), want.float().cpu()) < TOL[
        "float32"]
    assert float(abs(req.std).max()) <= 1e-5 * float(want.abs().max())


# -- data-conditioned solves ------------------------------------------------------
# small charts of the condition path: 1-D stationary (the pyramid, then
# #1; adjoint #5) and N-D charted (#9; adjoints #7 and #6)
CONDITION_CHARTS = ((charts.regular_chart(32, 3, boundary="reflect"), 8.0),
                    (charts.galactic_dust_chart((6, 8, 8), 2), 0.5))


def _to_cpu_icr(icr, mats):
    """The same model on the CPU, where the kernels' plain versions run,
    on the card's matrices (its ``matrices()`` returns them)."""
    import dataclasses

    mats_c = to_device(mats, "cpu")

    @dataclasses.dataclass(frozen=True)
    class OnCardMatrices(ICR):
        def matrices(self, theta=None, **kw):
            return mats_c

    fields = {f.name: getattr(icr, f.name) for f in dataclasses.fields(ICR)}
    return OnCardMatrices(**{**fields, "device": "cpu"}), mats_c


@pytest.mark.cuda
@pytest.mark.parametrize("pol", [None, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", [0, 1], ids=["regular", "dust"])
def test_cuda_condition_matvec_matches_plain(cuda, case, pol):
    """``condition_matvec`` on the kernel route (Sᵀ through the adjoint
    kernels, S through the forward ones) against the plain versions on the
    same matrices, k = 17 columns."""
    from repro_torch.solvers import condition_matvec, obs_operator

    chart, rho = CONDITION_CHARTS[case]
    icr = ICR(chart, kernels.matern32.with_defaults(rho=rho),
              use_pallas=True, dtype_policy=pol)
    mats = icr.matrices()
    rng = np.random.default_rng(0)
    obs = np.sort(rng.choice(chart.size, size=chart.size // 3,
                             replace=False))
    op = obs_operator(icr, obs_idx=obs)
    v = rng.standard_normal((17, obs.size)).astype(np.float32)
    build.LAUNCHES.clear()
    got = condition_matvec(icr, mats, op, 0.0625, torch.tensor(v, device=cuda))
    assert sum(build.LAUNCHES.values()) > 0
    icr_c, mats_c = _to_cpu_icr(icr, mats)
    want = condition_matvec(icr_c, mats_c, op, 0.0625, torch.tensor(v))
    assert rel(got.cpu(), want) < TOL["float32" if pol is None
                                      else "bfloat16"]


@pytest.mark.cuda
def test_cuda_cg_posterior_matches_the_cpu(cuda):
    """``cg_posterior`` on the card against the same solve on the CPU
    (the JAX package's test data: y = (K truth)[obs] + 0.05 noise,
    σ = 0.25): the same ladder and status, the mean field at 1e-5."""
    from repro_torch import cg_posterior

    chart, rho = CONDITION_CHARTS[0]
    icr = ICR(chart, kernels.matern32.with_defaults(rho=rho),
              use_pallas=True)
    mats = icr.matrices_cached()
    icr_c, mats_c = _to_cpu_icr(icr, mats)
    rng = np.random.default_rng(1)
    obs = np.sort(rng.choice(chart.size, size=chart.size // 2,
                             replace=False))
    s = icr_c.implicit_sqrt(dtype=torch.float64)
    truth = rng.standard_normal(chart.size)
    y = ((s @ s.T).numpy() @ truth)[obs] + 0.05 * rng.standard_normal(
        obs.size)
    post, rep = cg_posterior(icr, obs, y, noise_std=0.25)
    post_c, rep_c = cg_posterior(icr_c, obs, y, noise_std=0.25)
    assert rep.ok and rep.rungs == rep_c.rungs and rep.status == rep_c.status
    mean = icr.apply_sqrt(mats, post.mean).cpu()
    want = icr_c.apply_sqrt(mats_c, post_c.mean)
    assert float((mean - want).norm() / want.norm()) < TOL["float32"]


@pytest.mark.cuda
def test_cuda_kissgp_matvec_matches_the_cpu(cuda):
    from repro_torch import KissGP

    xs = np.sort(np.random.default_rng(0).uniform(0, 10, 4096))
    kfn = kernels.matern32.with_defaults(rho=1.0)()
    card = KissGP(x=xs, kernel_fn=kfn, jitter=1e-1)
    cpu = KissGP(x=xs, kernel_fn=kfn, jitter=1e-1, device="cpu")
    v = np.random.default_rng(1).standard_normal((3, 4096)).astype(
        np.float32)
    got = card.matvec(torch.tensor(v, device=cuda))
    assert got.device.type == "cuda"
    assert rel(got.cpu(), cpu.matvec(torch.tensor(v))) < TOL["float32"]


# -- the compiled paths as CUDA graphs -------------------------------------------
GRAPH_CHARTS = CONDITION_CHARTS + (
    (charts.log_polar_chart((16, 16), 2), 2.0),)


def _same_bits(a, b) -> bool:
    a, b = tree_leaves(a), tree_leaves(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _fit_problem(case, device):
    from repro_torch import charted_gp_dataset, gaussian_log_likelihood

    chart, rho = GRAPH_CHARTS[case]
    icr = ICR(chart, kernels.matern32.with_defaults(rho=rho),
              use_pallas=True, device=device)
    mats = icr.matrices()
    _, obs, y = charted_gp_dataset(
        icr, torch.Generator(device=device).manual_seed(3), obs_frac=0.3,
        noise_std=0.05)
    return icr, mats, gaussian_log_likelihood(0.05, obs), y


@pytest.mark.cuda
@pytest.mark.parametrize("case", [0, 1, 2],
                         ids=["regular", "dust", "log_polar"])
def test_cuda_fits_as_graphs_equal_eager(cuda, case):
    """``map_fit(jit=True)`` (one captured step, replayed) against
    ``jit=False`` and the graphed ADVI fit against its eager twin from
    the same generator state: losses and parameters bit for bit, the
    replays' launches counted from the graph's kernel nodes."""
    from repro_torch import advi_fit, map_fit

    icr, mats, ll, y = _fit_problem(case, cuda)
    build.LAUNCHES.clear()
    fit_g, loss_g = map_fit(ll, lambda x: icr.apply_sqrt(mats, x),
                            icr.zero_xi(), y, steps=6)
    assert build.LAUNCHES["refine_charted_adjoint"] + build.LAUNCHES[
        "refine_stationary_adjoint"] >= 6
    fit_e, loss_e = map_fit(ll, lambda x: icr.apply_sqrt(mats, x),
                            icr.zero_xi(), y, steps=6, jit=False)
    assert _same_bits(loss_g, loss_e) and _same_bits(fit_g, fit_e)
    assert float(loss_g[-1]) < float(loss_g[0])
    def advi():
        gen = torch.Generator(device=cuda).manual_seed(5)
        return advi_fit(gen, ll, lambda x: icr.apply_sqrt_batch(mats, x),
                        icr.zero_xi(), y, steps=4)

    graphed = advi()
    with graphs.eager():
        assert _same_bits(graphed, advi())


def _learned_theta(icr, device):
    """A forward that learns ρ under a lognormal prior, rebuilding the
    matrices from θ, and its initial latents."""
    from repro_torch import StandardizedModel, lognormal_prior

    priors = StandardizedModel({"rho": lognormal_prior(8.0, 4.0)})

    def fwd(latent):
        theta = dict(priors(latent[1]))
        theta["sigma"] = 1.0
        return icr(latent[0], theta)

    return fwd, (icr.zero_xi(), priors.zero_xi(device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [0, 1, 2],
                         ids=["regular", "dust", "log_polar"])
def test_cuda_learned_theta_fit_refuses_a_graph(cuda, case):
    """(Once: the capture refused a forward that rebuilds the matrices.)
    A learned-θ step now captures with its matrix build (the Jacobi
    kernel, the float64 Cholesky root): ``map_fit(jit=True)`` equals
    ``jit=False`` and the learned-θ ``advi_fit`` (one build per draw)
    its eager twin, bit for bit; the eigensolver launches in the
    replays."""
    from repro_torch import advi_fit, map_fit, per_draw

    icr, _, ll, y = _fit_problem(case, cuda)
    fwd, latent0 = _learned_theta(icr, cuda)
    build.LAUNCHES.clear()
    compiled = map_fit(ll, fwd, latent0, y, steps=4)
    assert build.LAUNCHES["sym_eig"] > 0
    assert _same_bits(compiled, map_fit(ll, fwd, latent0, y, steps=4,
                                        jit=False))

    def advi():
        return advi_fit(torch.Generator(device=cuda).manual_seed(5), ll,
                        per_draw(fwd), latent0, y, steps=3)

    compiled = advi()
    with graphs.eager():
        assert _same_bits(compiled, advi())


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n", [(1, 3), (256, 3), (16, 5), (65536, 4),
                                     (65536, 5), (4096, 2), (37, 1),
                                     (300, 8), (300, 32)])
def test_cuda_sym_eig_equals_its_plain_version(cuda, batch, n):
    """The batched Jacobi against its plain version on the card, one
    launch for the whole batch (65,536 4x4 matrices too, which cuSOLVER's
    batched eigh refuses): eigenpairs bit for bit (both round every
    product and sum on its own, in the same order), the status under its
    bound, through a plan."""
    from repro_torch.kernels import launch, sym_eig

    gen = torch.Generator(device=cuda).manual_seed(batch + n)
    a = torch.randn((batch, n, n), generator=gen, device=cuda)
    a = a + a.mT
    build.LAUNCHES.clear()
    with launch.recording() as plans:
        got = sym_eig.sym_eig(a)
    want = sym_eig.sym_eig_plain(a)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sym_eig"] == 1 and len(plans) == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[2].max()) <= sym_eig.BOUND
    assert rel(got[2], want[2]) < 1e-5


@pytest.mark.cuda
def test_cuda_nan_theta_raises_after_the_fit(cuda):
    """A NaN in θ: the captured fit runs its steps, then the statuses
    read once after the last one raise, naming the level."""
    from repro_torch import map_fit

    icr, _, ll, y = _fit_problem(0, cuda)
    fwd, (xi0, _) = _learned_theta(icr, cuda)
    latent0 = (xi0, {"rho": torch.tensor(float("nan"), device=cuda)})
    with pytest.raises(trefine.BuildError, match="level-0 root"):
        map_fit(ll, fwd, latent0, y, steps=3)
    _, losses = map_fit(ll, fwd, (xi0, {"rho": torch.zeros((), device=cuda)}),
                        y, steps=3)
    assert bool(torch.isfinite(losses).all())


@pytest.mark.cuda
@pytest.mark.parametrize("pol", [None, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", [0, 1, 2],
                         ids=["regular", "dust", "log_polar"])
def test_cuda_apply_sqrt_T_graph_equals_eager(cuda, case, pol):
    """The cached, graphed transpose against its chain op by op, bit for
    bit, at S = 1 and 3; a new matrix tensor or an in-place change of one
    captures anew instead of replaying stale addresses."""
    chart, rho = GRAPH_CHARTS[case]
    icr = ICR(chart, kernels.matern32.with_defaults(rho=rho),
              use_pallas=True, dtype_policy=pol)
    mats = icr.matrices()
    dt = icr.policy.storage_dtype
    for n_s in (1, 3):
        v = torch.randn((n_s,) + icr.out_shape, device=cuda).to(dt)
        for _ in range(2):
            assert _same_bits(icr.apply_sqrt_T_batch(mats, v),
                              icr.apply_sqrt_T_batch(mats, v, cached=False))
    assert len(icr._sqrt_T_graphs) == 2
    mats["sqrt0"].mul_(2.0)
    got = icr.apply_sqrt_T_batch(mats, v)
    assert _same_bits(got, icr.apply_sqrt_T_batch(mats, v, cached=False))
    assert len(icr._sqrt_T_graphs) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("case", [0, 1], ids=["regular", "dust"])
def test_cuda_cg_segments_graph_equal_eager(cuda, case):
    """On-grid observations (the matvec's ``index_add_`` sees distinct
    indices, so it is deterministic): the ladder's solve with its CG
    segments replayed from the system's graphs equals the eager one in
    status, iterations and x, bit for bit, at the default config and at
    rtol 1e-7 (both CG rungs to their floor, then the dense rung)."""
    from repro_torch.solvers import (CGConfig, build_condition_system,
                                     obs_operator, solve_guarded)

    chart, rho = CONDITION_CHARTS[case]
    icr = ICR(chart, kernels.matern32.with_defaults(rho=rho),
              use_pallas=True)
    rng = np.random.default_rng(4)
    obs = np.sort(rng.choice(chart.size, size=chart.size // 3,
                             replace=False))
    system = build_condition_system(icr, obs_operator(icr, obs_idx=obs),
                                    0.0625)
    y = torch.tensor(rng.standard_normal((1, obs.size)), dtype=torch.float32,
                     device=cuda)
    ladder = [("icr", system.precond), ("none", None)]
    for cfg in (system.default_config(),
                CGConfig(rtol=1e-7, max_iters=4 * obs.size)):
        def solve():
            return solve_guarded(system.matvec, y, preconds=ladder, cfg=cfg,
                                 dense_solve=system.dense_solve,
                                 segment_graphs=system.graphs)

        xg, rg = solve()
        with graphs.eager():
            xe, re_ = solve()
        assert rg.status == re_.status and rg.iterations == re_.iterations
        assert _same_bits(xg, xe)
    assert system.graphs


@pytest.mark.cuda
def test_cuda_kissgp_segments_graph_against_eager(cuda):
    """Off-grid KISS-GP: ``index_add_`` adds colliding indices in no fixed
    order, so graph and eager iterates differ in their last bits. Both
    solves must converge with their true residual within 10·rtol (the
    solver's own bar), in iteration counts within 10 % of each other."""
    from repro_torch import KissGP
    from repro_torch.solvers import CGConfig, pcg_iterate

    xs = np.sort(np.random.default_rng(0).uniform(0, 10, 4096))
    kg = KissGP(x=xs, kernel_fn=kernels.matern32.with_defaults(rho=1.0)(),
                jitter=1e-1)
    p = kg.spectrum()
    y = torch.tensor(np.sin(xs), dtype=torch.float32, device=cuda)[None]
    cfg = CGConfig(rtol=1e-5, max_iters=400)
    out = [pcg_iterate(lambda v: kg.matvec(v, p), y, cfg=cfg)[:2]]
    with graphs.eager():
        out.append(pcg_iterate(lambda v: kg.matvec(v, p), y, cfg=cfg)[:2])
    for x, stats in out:
        assert int(stats["status"][0]) == 1   # converged
        res = float((y - kg.matvec(x, p)).norm() / y.norm())
        assert res <= 10 * cfg.rtol
    (_, sg), (_, se) = out
    assert abs(int(sg["iters"][0]) - int(se["iters"][0])) <= max(
        2, int(se["iters"][0]) // 10)


# -- distributed: a virtual mesh of 8 slots on the card ------------------------
# (chart, ρ, shard axis, the kernel its levels launch)
DIST_CASES = (
    (charts.regular_chart(32, 4, boundary="reflect"), 16.0, 0,
     "refine_stationary"),
    (charts.log_chart(32, 4, n_csz=5, n_fsz=4, delta0=0.01,
                      boundary="reflect"), 1.0, 0, "refine_charted"),
    (charts.galactic_dust_chart((8, 16, 16), 3), 0.5, 1, "refine_nd_fused"),
    (charts.log_polar_chart((64, 64), 3), 2.0, 1, "refine_nd_fused"),
)


def _card_mesh(cuda, n=8, axis="space"):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((n,), (axis,), devices=[cuda] * n)


@pytest.mark.cuda
@pytest.mark.parametrize("pol", [None, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", range(len(DIST_CASES)),
                         ids=["regular", "log", "dust", "log_polar"])
def test_cuda_sharded_apply_equals_the_unsharded_kernel_route(cuda, case,
                                                              pol):
    """``DistributedICR`` on 8 slots of the card: every sharded level
    launches its kernel once per slot (a replicated level once), and the
    gathered field equals the unsharded kernel route at the tolerances."""
    from repro_torch.core.distributed import DistributedICR

    chart, rho, axis, kname = DIST_CASES[case]
    icr = ICR(chart, kernels.matern32.with_defaults(rho=rho),
              use_pallas=True, dtype_policy=pol)
    dist = DistributedICR(icr, _card_mesh(cuda), shard_axis=axis)
    k = dist.first_sharded_level()
    mats = icr.matrices()
    xi = icr.init_xi(torch.Generator(device=cuda).manual_seed(0), batch=8)
    placed = dist.place(mats)
    build.LAUNCHES.clear()
    blocks = dist.apply_sqrt_batch(placed, xi)
    torch.cuda.synchronize()
    assert +build.LAUNCHES == {kname: k + 8 * (chart.n_levels - k)}
    got = dist.gather(blocks)
    want = icr.apply_sqrt_batch(mats, xi)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert rel(got, want) <= TOL[str(want.dtype).removeprefix("torch.")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [0, 1], ids=["regular", "dust"])
def test_cuda_samples_mode_equals_the_unsharded_slab(cuda, case):
    """Samples mode on 8 slots of the card: one graph captured per slot,
    and fields and moments bit for bit the unsharded server's."""
    from repro_torch.launch import serve_gp as sg

    chart, rho = SERVE_CHARTS[case]
    post = sg.demo_posterior(chart, rho)
    base, got = sg.mixed_requests(3, 8), sg.mixed_requests(3, 8)
    sg.GPFieldServer(post, slab=2).run(base)
    srv = sg.GPFieldServer(post, slab=2, mesh=_card_mesh(cuda, axis="data"))
    srv.run(got)
    m = srv.metrics()
    assert m["mode"] == "sharded-samples:cuda-graph"
    assert m["graph_captures"] == 8 and m["capacity"] == 16
    assert all(s["fn"].graph is not None for s in srv._entry["slots"])
    for a, b in zip(base, got):
        assert a.error is None and b.error is None
        pairs = (zip(a.fields, b.fields) if a.kind == "sample"
                 else [(a.mean, b.mean), (a.std, b.std)])
        for x, y in pairs:
            assert np.array_equal(x, y)


@pytest.mark.cuda
def test_cuda_kill_device_midstream_replays_bit_for_bit(cuda):
    """The chaos suite's kill mid-stream on 8 slots of the card: a mesh of
    7 after one re-plan, one cache miss, the replayed rows bit for bit the
    unfaulted run's and the unsharded server's."""
    from repro_torch.distributed import chaos

    msg = chaos.check_kill_midstream("cuda")
    assert "mesh 8->7" in msg


# -- launch plans and the static-analysis layer ----------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(SERVE_CHARTS)))
def test_cuda_slab_graph_nodes_equal_their_plans(cuda, case):
    """Every kernel node of the served slab's graph carries the grid,
    block and shared memory of the launch plan its wrapper launched
    through, and ``lowered_slab`` gives those nodes beside the slab's
    plans (the pyramid's grid the card's own co-resident count)."""
    import collections

    from repro_torch.launch import serve_gp as sg

    chart, rho = SERVE_CHARTS[case]
    srv = sg.GPFieldServer(sg.demo_posterior(chart, rho), slab=4)
    fn = srv._entry["fn"]
    assert fn.nodes and collections.Counter(fn.nodes) == collections.Counter(
        p.node for p in fn.plans)
    low = srv.lowered_slab()
    assert low["mode"] == "single:cuda-graph"
    assert low["graph"] == [[w, list(g), list(b), m] for w, g, b, m in
                            fn.nodes]
    planned = sorted(json.dumps([p["kernel"], p["grid"], p["block"],
                                 p["smem"]]) for p in low["launches"])
    assert planned == sorted(json.dumps(n) for n in low["graph"])


@pytest.mark.cuda
def test_cuda_launch_refuses_a_plan_it_does_not_match(cuda):
    """The C entries derive their grid and shared memory and refuse a plan
    that says otherwise: nothing launches."""
    import dataclasses

    from repro_torch.kernels import launch

    coarse = torch.randn(3, 42, device=cuda)
    xi = torch.randn(3, 40, 2, device=cuda)
    r, d = torch.randn(2, 3, device=cuda), torch.randn(2, 2, device=cuda)
    plan = icr_refine.refine_1d_plan(batch=3, t=40, coarse_len=42, n_fsz=2,
                                     n_csz=3, charted=False)
    out = torch.full((3, 80), float("nan"), device=cuda)
    args = (build.dtype_code(coarse.dtype), 1, coarse.data_ptr(),
            xi.data_ptr(), r.data_ptr(), d.data_ptr(), out.data_ptr(), 3, 42,
            40, 3, 2, plan.instance["families"], plan.instance["runs"])
    tensors = {"coarse": coarse, "xi": xi, "r": r, "d": d, "out": out}
    for bad in (dataclasses.replace(plan, grid=(2, 1, 1)),
                dataclasses.replace(plan, smem=16)):
        with pytest.raises(launch.PlanMismatchError):
            launch.run_plan(bad, tensors, *args)
    torch.cuda.synchronize()
    assert torch.isnan(out).all()
    launch.run_plan(plan, tensors, *args)
    torch.cuda.synchronize()
    want = icr_refine.refine_stationary_plain(coarse, xi, r, d)
    assert rel(out, want) < TOL["float32"]


# -- the LM port: the decode step as one CUDA graph --------------------------------
def _lm_server(name, device, slots=4, s_max=32, params=None):
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import BatchedServer

    return BatchedServer(get_arch(name).reduced(), batch_slots=slots,
                         s_max=s_max, seed=0, device=device, params=params)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gemma3-4b", "xlstm-1.3b"])
def test_cuda_lm_graph_step_equals_eager(cuda, name):
    """The server's captured decode step against ``Model.serve_step`` op
    by op from the same cache, every slot live at its own position: the
    logits and every cache leaf bit for bit."""
    from repro_torch.models.tree import tree_leaves, tree_map, tree_store

    srv = _lm_server(name, cuda)
    gen = torch.Generator(device="cuda").manual_seed(1)
    vocab = srv.cfg.vocab_size
    for i in range(10):   # past the reduced window of 8
        srv.decode(torch.randint(0, vocab, (4, 1), generator=gen,
                                 device=cuda, dtype=torch.int32),
                   torch.full((4,), i, dtype=torch.int32, device=cuda))
    tok = torch.randint(0, vocab, (4, 1), generator=gen, device=cuda,
                        dtype=torch.int32)
    pos = torch.tensor([10, 3, 10, 0], dtype=torch.int32, device=cuda)
    before = tree_map(torch.clone, srv.cache)
    graph = srv.decode(tok, pos).clone()
    graph_cache = [t.clone() for t in tree_leaves(srv.cache)]
    tree_store(srv.cache, before)
    eager = srv.model.serve_step(srv.params, srv.cache, tok, pos)
    assert torch.equal(graph, eager)
    assert all(torch.equal(a, b)
               for a, b in zip(graph_cache, tree_leaves(srv.cache)))


@pytest.mark.cuda
def test_cuda_lm_moe_matches_the_cpu(cuda):
    """Reduced llama4 (interleaved MoE) on the card at float32, TF32 off:
    prefill and 16 captured decode steps within 1e-4 of the same model
    and parameters on the CPU."""
    from repro_torch.models.tree import tree_map

    cpu = _lm_server("llama4-maverick-400b-a17b", "cpu", slots=2, s_max=16)
    card = _lm_server("llama4-maverick-400b-a17b", cuda, slots=2, s_max=16,
                      params=tree_map(lambda t: t.to(cuda), cpu.params))
    toks = torch.randint(0, cpu.cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    want = cpu.model.prefill_fn(cpu.params, {"tokens": toks})
    got = card.model.prefill_fn(card.params, {"tokens": toks.to(cuda)})
    assert rel(got.cpu(), want) <= 1e-4
    for i in range(16):
        pos = torch.full((2,), i, dtype=torch.int32)
        w = cpu.decode(toks[:, i:i + 1], pos)
        g = card.decode(toks[:, i:i + 1].to(cuda), pos.to(cuda))
        assert rel(g.cpu(), w) <= 1e-4, i


@pytest.mark.cuda
def test_cuda_lm_bf16_matmul_accumulates_in_float32(cuda):
    """``layers.dot_f32`` in bfloat16 at gemma3-4b's decode shape (4 rows,
    the MLP's 10240 -> 2560 down projection, where cuBLAS splits K) with
    cuBLAS allowed reduced-precision reductions: the float32 product of
    the widened operands up to float32's summation order (2^-14 of the
    largest value; a partial sum rounded to bfloat16 errs by ~2^-9 of
    it), and ``matmul`` that product rounded once to bfloat16."""
    from repro_torch.models.layers import dot_f32, matmul

    flag = torch.backends.cuda.matmul
    before = flag.allow_bf16_reduced_precision_reduction
    flag.allow_bf16_reduced_precision_reduction = True
    try:
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn((4, 1, 10240), generator=gen,
                        device=cuda).bfloat16()
        w = (torch.randn((10240, 2560), generator=gen, device=cuda)
             / 100).bfloat16()
        acc = dot_f32(x, w)
        got = matmul(x, w)
    finally:
        flag.allow_bf16_reduced_precision_reduction = before
    want = x.float() @ w.float()
    assert acc.dtype == torch.float32 and acc.shape == want.shape
    assert float((acc - want).abs().max()) <= \
        2.0 ** -14 * float(want.abs().max())
    assert got.dtype == torch.bfloat16 and torch.equal(got, acc.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("cotangent", ["through_matmul", "float32"])
def test_cuda_lm_bf16_backward_accumulates_in_float32(cuda, cotangent):
    """The bfloat16 products' backward at gemma3-4b's MLP down projection
    (1,024 rows, 10240 -> 2560): the float32 gradients
    (``dot_vjp_f32``) within the forward test's bound, 2^-14 of the
    largest value, of the product of the widened operands, for a
    cotangent that came through ``matmul``'s cast (bfloat16-exact, one
    product) and for a true float32 one (the logits': two bfloat16 terms,
    ``bf16_terms``); and autograd's gradients through ``matmul`` /
    ``dot_f32`` are those, cast to bfloat16, bit for bit."""
    from repro_torch.models.layers import (bf16_terms, dot_f32,
                                           dot_vjp_f32, matmul)

    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((1024, 10240), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((10240, 2560), generator=gen, device=cuda)
         / 100).bfloat16()
    g = torch.randn((1024, 2560), generator=gen, device=cuda)
    if cotangent == "through_matmul":
        g = g.bfloat16().float()
        parts = (g.bfloat16(),)
    else:
        parts = bf16_terms(g, torch.bfloat16)
    dx, dw = dot_vjp_f32(x, w, parts)
    want_dx = g @ w.float().t()
    want_dw = x.float().t() @ g
    for got, want in ((dx, want_dx), (dw, want_dw)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float((got - want).abs().max()) <= \
            2.0 ** -14 * float(want.abs().max())
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    if cotangent == "through_matmul":
        matmul(xs, ws).backward(g.bfloat16())
    else:
        dot_f32(xs, ws).backward(g)
    assert xs.grad.dtype == ws.grad.dtype == torch.bfloat16
    assert torch.equal(xs.grad, dx.bfloat16())
    assert torch.equal(ws.grad, dw.bfloat16())


@pytest.mark.cuda
def test_cuda_lm_remat_grads_equal_no_remat(cuda):
    """Reduced gemma3-4b at float32 on the card, 1,024 tokens (two query
    chunks, banded local layers): the gradients with ``remat=True`` (the
    layer groups, and inside them the chunks, checkpointed) equal those
    without, bit for bit."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.tree import tree_leaves

    cfg = get_arch("gemma3-4b").reduced()
    params = build_model(cfg).init_params(
        torch.Generator(device="cuda").manual_seed(0))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 1025), generator=gen,
                        device=cuda, dtype=torch.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    out = []
    for remat in (False, True):
        loss, _ = build_model(dataclasses.replace(cfg, remat=remat)).loss_fn(
            params, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.cuda
def test_cuda_lm_prefetched_batches_equal_host_batches(cuda):
    """The prefetch iterator on the card (pinned host memory, a side
    stream, an event the consumer's stream waits on): each batch, read at
    once by a step on the current stream, equals the host batch; the
    iterator's thread is joined by ``close``."""
    from repro_torch.data import SyntheticLMData, make_batch_iterator

    src = SyntheticLMData(vocab_size=262_144, seq_len=4096, global_batch=4,
                          seed=2)
    it = make_batch_iterator(src, start_step=5, device=cuda)
    try:
        for i in range(6):
            b = next(it)
            # the step: device work on the current stream, queued at once
            got = {k: (v.long() * 3 + 1) for k, v in b.items()}
            want = src.batch(5 + i)
            for k in ("tokens", "labels"):
                assert b[k].device.type == "cuda"
                np.testing.assert_array_equal(
                    ((got[k] - 1) // 3).cpu().numpy(), want[k])
    finally:
        it.close()
    assert not it._thread.is_alive()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (1, 8)])
def test_cuda_lm_sharded_step_equals_one_slot(cuda, shape):
    """Reduced gemma3-4b at float32 on a virtual mesh of the card ("head"
    with the kv heads split, repeated, and "key"): the sharded step's
    loss and gradients equal the one-slot step's on the card within
    1e-5 of each leaf's largest entry; its batch comes from the prefetch
    iterator, whole on the card, as ``train_loop`` hands it over."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLMData, make_batch_iterator
    from repro_torch.distributed import elastic
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.tree import tree_leaves, tree_map

    cfg = get_arch("gemma3-4b").reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    src = SyntheticLMData(cfg.vocab_size, 64, 4, seed=3)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in src.batch(0).items()}
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss1, _ = model.loss_fn(params, batch)
    grads1 = torch.autograd.grad(loss1, leaves)
    mesh = make_mesh(shape, ("data", "model"), devices=[cuda] * (
        shape[0] * shape[1]))
    ts = make_train_step(cfg, mesh)
    placed = ts.params_sh.place(tree_map(lambda t: t.detach().clone(),
                                         params))
    it = make_batch_iterator(src, device=cuda)
    try:
        pbatch = next(it)
    finally:
        it.close()
    assert pbatch["tokens"].is_cuda
    loss2, _, grads2 = ts.executor.grads(model.loss_fn, placed, pbatch)
    assert abs(float(loss2) - float(loss1)) <= 1e-5 * abs(float(loss1))
    got = [elastic.gather(x) for x in elastic.placed_leaves(grads2)]
    assert max(rel(a, b) for a, b in zip(got, grads1)) <= 1e-5


@pytest.mark.cuda
def test_cuda_compressed_psum_within_half_a_step(cuda):
    """``compressed_psum`` over 8 slots of the card: distinct gradients
    within scale/2 of the plain mean (scale = the max over the slots /
    127); equal gradients within max|g|/127 of themselves."""
    from repro_torch.distributed.compression import (
        compressed_psum, make_error_feedback_state)

    gen = torch.Generator(device="cuda").manual_seed(0)
    per = [{"w": torch.randn((256, 512), generator=gen, device=cuda)}
           for _ in range(8)]
    err = [make_error_feedback_state(per[0]) for _ in range(8)]
    mean, _ = compressed_psum(per, err)
    stack = torch.stack([p["w"] for p in per])
    scale = float(stack.abs().max()) / 127.0
    assert float((mean["w"] - stack.mean(0)).abs().max()) <= scale / 2 + 1e-6
    same, _ = compressed_psum([per[0]] * 8, err)
    bound = float(per[0]["w"].abs().max()) / 127.0
    assert float((same["w"] - per[0]["w"]).abs().max()) <= bound * 1.01
