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
import numpy as np
import pytest
import torch

from repro_torch import ICR
from repro_torch.core import charts, kernels
from repro_torch.core import refine as trefine
from repro_torch.kernels import build, dispatch, icr_refine, nd_fused

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
    """Each CUDA kernel against its plain version on the same card, at a
    family count that leaves a ragged last block."""
    rng = np.random.default_rng(9)
    dt = DTYPES[dname]
    for charted in (False, True):
        ops = [torch.tensor(a, dtype=torch.float32, device=cuda).to(dt)
               for a in _1d_operands(rng, batch=5, t=1001, n_csz=5,
                                     n_fsz=4, charted=charted)]
        route = "charted-1d" if charted else "stationary-1d"
        before = build.LAUNCHES[dispatch.KERNEL_OF_ROUTE[route]]
        got = dispatch.KERNELS[route](*ops)
        assert build.LAUNCHES[dispatch.KERNEL_OF_ROUTE[route]] == before + 1
        want = dispatch.PLAIN[route](*ops)
        assert rel(got, want) < TOL[dname]
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
        assert sum(build.LAUNCHES.values()) == chart.n_levels
        assert rel(got.cpu(), want) < TOL["float32" if pol is None
                                          else "bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("dname", sorted(TOL))
def test_nd_fused_charted_axes_on_the_card(cuda, dname):
    """2-D and 3-D levels with per-family factors on the trailing axes and
    ragged last tiles (random factors: the kernel is linear in them)."""
    rng = np.random.default_rng(10)
    dt = DTYPES[dname]
    for chart in (charts.regular_chart((300, 260), 1),
                  charts.regular_chart((12, 14), 1, boundary="reflect"),
                  charts.regular_chart((9, 21, 40), 1, n_csz=5, n_fsz=4)):
        geom = trefine.LevelGeom.for_level(chart, 0)
        f, c = geom.n_fsz, geom.n_csz
        rs = [rng.normal(size=(t, f, c)) / c for t in geom.T]
        ds = [rng.normal(size=(t, f, f)) / f for t in geom.T]
        field = rng.normal(size=(3,) + geom.coarse_shape)
        xi = rng.normal(size=(3, int(np.prod(geom.T)), f ** len(geom.T)))

        def on_card(a):
            return torch.tensor(a, dtype=torch.float32, device=cuda).to(dt)

        args = nd_fused.nd_operands(
            on_card(field), on_card(xi), [on_card(r) for r in rs],
            [on_card(d) for d in ds], geom, sample_axis=True)
        got = nd_fused.refine_nd_fused_core(*args)
        want = nd_fused.refine_nd_fused_plain(*args)
        assert rel(got, want) < TOL[dname]


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
    against their plain versions: family counts that leave a ragged last
    block, short rows staged several at once, and a coarse tail past the
    last window that must come back zero."""
    rng = np.random.default_rng([n_csz, n_fsz, 12])
    dt = DTYPES[dname]
    s = n_fsz // 2

    def on_card(a):
        return torch.tensor(a, dtype=torch.float32, device=cuda).to(dt)

    for charted in (False, True):
        kern, plain = ADJOINTS[charted]
        for batch, t in ((5, 1001), (300, 33), (1, 1)):
            lead = (t,) if charted else ()
            g = on_card(rng.normal(size=(batch, t * n_fsz)))
            r = on_card(rng.normal(size=lead + (n_fsz, n_csz)) / n_csz)
            d = on_card(rng.normal(size=lead + (n_fsz, n_fsz)) / n_fsz)
            length = (t - 1) * s + n_csz + 3
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
                assert float(got[0][:, -3:].abs().max()) == 0.0


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
