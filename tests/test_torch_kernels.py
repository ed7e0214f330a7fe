"""The port's kernel modules held against the JAX package's kernels.

Each kernel module of ``repro_torch.kernels`` — 1-D stationary, 1-D
charted, fused N-D level, and the dispatch around them — runs here on CPU
tensors, i.e. through its plain version, and is held against the JAX
package's Pallas kernel run in interpret mode on the same numpy-seeded
operands. Tolerances are the JAX package's own (DESIGN.md §11), relative
to the largest magnitude: 1e-5 at float32, 5e-2 with bfloat16 storage and
float32 accumulation.

The CUDA kernels themselves run only on a card: ``test_torch_cuda.py``
holds them against the plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import charts as jcharts
from repro.core import kernels as jkernels
from repro.core import refine as jrefine
from repro.kernels import dispatch as jdispatch
from repro.kernels import nd_fused as jnd
from repro.kernels import ref as jref
from repro.kernels.icr_refine import (
    refine_charted_pallas,
    refine_stationary_pallas,
)
from repro_torch.convert import to_torch
from repro_torch.core import charts as tcharts
from repro_torch.core import refine as trefine
from repro_torch.kernels import build, dispatch, icr_refine, nd_fused, ref

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
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


def pair(arr, dname):
    """The same numpy array as a JAX array and a torch tensor of dtype."""
    jdt, tdt = DTYPES[dname]
    j = jnp.asarray(arr, jdt)
    return j, to_torch(np.asarray(j), device="cpu").to(tdt)


def _1d_operands(rng, *, batch, t, n_csz, n_fsz, charted):
    s = n_fsz // 2
    lead = (t,) if charted else ()
    return (rng.normal(size=(batch, (t - 1) * s + n_csz)),
            rng.normal(size=(batch, t, n_fsz)),
            rng.normal(size=lead + (n_fsz, n_csz)) / n_csz,
            rng.normal(size=lead + (n_fsz, n_fsz)) / n_fsz)


# -- 1-D levels --------------------------------------------------------------------
@pytest.mark.parametrize("dname", sorted(TOL))
@pytest.mark.parametrize("charted", [False, True], ids=["stationary",
                                                        "charted"])
@pytest.mark.parametrize("n_csz,n_fsz", [(3, 2), (5, 4)])
def test_1d_plain_matches_reference_kernel(n_csz, n_fsz, charted, dname):
    """refine_stationary / refine_charted (CPU: the plain version) against
    the Pallas kernels in interpret mode, at a family count that is not a
    multiple of the reference's block."""
    rng = np.random.default_rng([n_csz, int(charted)])
    ops = _1d_operands(rng, batch=3, t=37, n_csz=n_csz, n_fsz=n_fsz,
                       charted=charted)
    jops, tops = zip(*(pair(a, dname) for a in ops))
    kern = refine_charted_pallas if charted else refine_stationary_pallas
    want = kern(*jops, n_csz=n_csz, n_fsz=n_fsz, block_families=16,
                batch_block=2, interpret=True)
    port = icr_refine.refine_charted if charted else \
        icr_refine.refine_stationary
    got = port(*tops)
    assert got.dtype == tops[0].dtype
    assert tuple(got.shape) == tuple(want.shape)
    assert rel(t2n(got), j2n(want)) < TOL[dname]


def test_windows_and_coarse_len_match_reference():
    x = np.arange(2 * 23, dtype=np.float32).reshape(2, 23)
    for t, n_csz, n_fsz in [(10, 5, 4), (21, 3, 2)]:
        s = n_fsz // 2
        np.testing.assert_array_equal(
            t2n(ref.windows_1d(torch.from_numpy(x), t, n_csz, s)),
            np.asarray(jref.windows_1d(jnp.asarray(x), t, n_csz, s)))
        assert ref.coarse_len(t, n_csz, n_fsz) == jref.coarse_len(
            t, n_csz, n_fsz)


@pytest.mark.parametrize("boundary", ["shrink", "reflect"])
def test_refine_axes_oracle_matches_reference(boundary):
    """The separable N-D oracle of ref.py, with a charted axis 0."""
    c = jcharts.galactic_dust_chart((6, 8, 8), 1, boundary=boundary)
    k = jkernels.matern32.with_defaults(rho=0.5)()
    geom = jrefine.LevelGeom.for_level(c, 0)
    rs, ds = jax.jit(lambda: jrefine.axis_refinement_matrices_level(
        c, k, 0))()
    rng = np.random.default_rng(4)
    field = rng.normal(size=geom.coarse_shape).astype(np.float32)
    xi = rng.normal(size=(int(np.prod(geom.T)), 64)).astype(np.float32)
    kw = dict(T=geom.T, n_fsz=geom.n_fsz, boundary=boundary, b=geom.b)
    want = jref.refine_axes_ref(jnp.asarray(field), jnp.asarray(xi), rs, ds,
                                **kw)
    got = ref.refine_axes_ref(
        torch.from_numpy(field), torch.from_numpy(xi),
        to_torch([np.asarray(r) for r in rs], device="cpu"),
        to_torch([np.asarray(d) for d in ds], device="cpu"), **kw)
    assert rel(t2n(got), want) < TOL["float32"]


# -- fused N-D level ---------------------------------------------------------------
def _nd_level(c, k, lvl, rng, n_s=2):
    geom = jrefine.LevelGeom.for_level(c, lvl)
    rs, ds = jax.jit(lambda: jrefine.axis_refinement_matrices_level(
        c, k, lvl))()
    field = rng.normal(size=(n_s,) + geom.coarse_shape)
    xi = rng.normal(size=(n_s, int(np.prod(geom.T)),
                          geom.n_fsz ** len(geom.T)))
    return geom, [np.asarray(r) for r in rs], [np.asarray(d) for d in ds], \
        field, xi


def _nd_check(geom, rs, ds, field, xi, dname):
    jf, tf = pair(field, dname)
    jx, tx = pair(xi, dname)
    jrs, trs = zip(*(pair(r, dname) for r in rs))
    jds, tds = zip(*(pair(d, dname) for d in ds))
    want = jnd.refine_nd_fused(jf, jx, list(jrs), list(jds), geom,
                               interpret=True, sample_axis=True)
    got = nd_fused.refine_nd_fused(
        tf, tx, list(trs), list(tds),
        trefine.LevelGeom(**geom.__dict__), sample_axis=True)
    assert got.dtype == tf.dtype
    assert tuple(got.shape) == tuple(want.shape)
    assert rel(t2n(got), j2n(want)) < TOL[dname]


@pytest.mark.parametrize("dname", sorted(TOL))
def test_nd_fused_plain_matches_reference_kernel_on_dust(dname):
    """galactic_dust_chart((6,8,8), 2): charted log-r axis 0, shared
    angular factors, reflect boundary; every level."""
    c = jcharts.galactic_dust_chart((6, 8, 8), 2)
    k = jkernels.matern32.with_defaults(rho=0.5)()
    rng = np.random.default_rng(5)
    for lvl in range(c.n_levels):
        _nd_check(*_nd_level(c, k, lvl, rng), dname)


@pytest.mark.parametrize("dname", sorted(TOL))
def test_nd_fused_plain_with_charted_trailing_axes(dname):
    """2-D shrink and 3-D levels whose trailing axes carry per-family
    factors (random matrices: the kernel math is linear in them)."""
    rng = np.random.default_rng(6)
    for c in (jcharts.regular_chart((12, 14), 1),
              jcharts.regular_chart((8, 10, 12), 1, n_csz=5, n_fsz=4)):
        geom = jrefine.LevelGeom.for_level(c, 0)
        f, cs = geom.n_fsz, geom.n_csz
        rs = [rng.normal(size=(t, f, cs)) / cs for t in geom.T]
        ds = [rng.normal(size=(t, f, f)) / f for t in geom.T]
        rs[0], ds[0] = rs[0][0], ds[0][0]          # shared axis 0
        field = rng.normal(size=(2,) + geom.coarse_shape)
        xi = rng.normal(size=(2, int(np.prod(geom.T)), f ** len(geom.T)))
        _nd_check(geom, rs, ds, field, xi, dname)


def test_nd_fused_single_field_without_sample_axis():
    c = tcharts.regular_chart((10, 10), 1, boundary="reflect")
    geom = trefine.LevelGeom.for_level(c, 0)
    g = torch.Generator().manual_seed(0)
    rs = [torch.randn(2, 3, generator=g), torch.randn(2, 3, generator=g)]
    ds = [torch.randn(2, 2, generator=g), torch.randn(2, 2, generator=g)]
    field = torch.randn(10, 10, generator=g)
    xi = torch.randn(100, 4, generator=g)
    one = nd_fused.refine_nd_fused(field, xi, rs, ds, geom)
    batch = nd_fused.refine_nd_fused(field[None], xi[None], rs, ds, geom,
                                     sample_axis=True)
    assert tuple(one.shape) == geom.fine_shape
    torch.testing.assert_close(one, batch[0], rtol=0, atol=0)


@pytest.mark.parametrize("T,fsz,csz,charted", [
    ((16, 32, 32), 4, 5, (True, False, False)),    # flagship, last level
    ((32, 64, 64), 4, 5, (True, False, False)),    # dust, 4 levels
    ((3, 4, 4), 4, 5, (True, False, False)),
    ((512, 512), 2, 3, (False, False)),
    ((40, 70), 2, 3, (True, True)),
    ((64, 64, 64), 2, 3, (True, True, True)),
])
def test_nd_tile_fits_shared_memory(T, fsz, csz, charted):
    """The tile fits the shared budget, and four blocks of it fit on an
    H100 SM (228 KB, 1 KB reserved per block), at one sample and at the
    serving slab's 8 (where small levels take smaller tiles)."""
    for samples in (1, 8):
        tile = nd_fused.nd_tile(T, csz, fsz, charted, samples)
        assert all(1 <= b <= t for b, t in zip(tile, T))
        floats = nd_fused._smem_floats(tile, T, len(T), csz, fsz, charted)
        assert floats * 4 <= nd_fused._SMEM_BUDGET
        assert nd_fused.BLOCKS_PER_SM * (floats * 4 + 1024) <= 228 * 1024
    # the flagship's levels at S=8: 2x8x8 on the last, 128 work items and
    # 512 tiles on the first two
    dust = [nd_fused.nd_tile(t, 5, 4, (True, False, False), 8)
            for t in ((4, 8, 8), (8, 16, 16), (16, 32, 32))]
    assert dust == [(2, 4, 4), (2, 4, 4), (2, 8, 8)]


def _stream_owners(batch, t, n_fsz, n_csz, itemsize, length, adjoint):
    """How many threads of the streaming launch own each fine output and,
    for the adjoint, each coarse output: the kernels' run numbering (run i
    is run i % runs of row i // runs; the adjoint's last run of a row
    writes dcoarse on to its end)."""
    nf, runs, blocks = icr_refine.stream_shape_1d(
        batch, t, n_fsz, n_csz, itemsize, adjoint=adjoint)
    s = n_fsz // 2
    fine = np.zeros((batch, t * n_fsz), dtype=int)
    coarse = np.zeros((batch, length), dtype=int)
    for run in range(blocks * icr_refine.THREADS):
        row, t0 = run // runs, run % runs * nf
        if row >= batch:
            continue
        fine[row, t0 * n_fsz:min(t0 + nf, t) * n_fsz] += 1
        end = length if t0 + nf >= t else (t0 + nf) * s
        coarse[row, min(t0 * s, length):end] += 1
    return (nf, runs, blocks), fine, coarse


@pytest.mark.parametrize("batch,t,n_fsz,n_csz,itemsize,extra", [
    (3, 37, 2, 3, 4, 0), (5, 16, 4, 5, 2, 1), (300, 32, 4, 5, 4, 4),
    (7, 33, 8, 3, 4, 0), (1, 1, 2, 3, 2, 3), (37, 32, 4, 5, 2, 4),
])
@pytest.mark.parametrize("adjoint", [False, True], ids=["fwd", "adj"])
def test_stream_shape_owns_every_output_once(batch, t, n_fsz, n_csz,
                                             itemsize, extra, adjoint):
    length = (t - 1) * (n_fsz // 2) + n_csz + extra
    (nf, runs, blocks), fine, coarse = _stream_owners(
        batch, t, n_fsz, n_csz, itemsize, length, adjoint)
    assert (fine == 1).all()
    if adjoint:
        assert (coarse == 1).all()
    assert (blocks - 1) * icr_refine.THREADS < batch * runs <= (
        blocks * icr_refine.THREADS)
    assert blocks <= 2**31 - 1


def _charted_owners(batch, t, n_fsz, n_csz, itemsize, length):
    """How many threads of a streaming charted launch own each fine output,
    each coarse output of the adjoint and each ξ family: thread i owns run
    i % runs of the rows [(i // runs)·SB, +SB), the adjoint's last run of a
    row dcoarse on to its end."""
    nf, rows, runs, blocks = icr_refine.charted_shape_1d(
        batch, t, n_fsz, n_csz, itemsize)
    s = n_fsz // 2
    fine = np.zeros((batch, t * n_fsz), dtype=int)
    coarse = np.zeros((batch, length), dtype=int)
    fam = np.zeros((batch, t), dtype=int)
    for i in range(blocks * icr_refine.THREADS):
        b0, t0 = i // runs * rows, i % runs * nf
        for b in range(b0, min(b0 + rows, batch)):
            fine[b, t0 * n_fsz:min(t0 + nf, t) * n_fsz] += 1
            fam[b, t0:min(t0 + nf, t)] += 1
            end = length if t0 + nf >= t else (t0 + nf) * s
            coarse[b, min(t0 * s, length):end] += 1
    return (nf, rows, runs, blocks), fine, coarse, fam


CHARTED_SHAPE_CASES = [
    (3, 37, 2, 3, 4, 0), (5, 16, 4, 5, 2, 1), (300, 17, 4, 5, 4, 4),
    (7, 33, 8, 3, 4, 0), (1, 1, 2, 3, 2, 3), (37, 32, 4, 5, 4, 4),
]


def _check_charted_shape(batch, t, n_fsz, n_csz, itemsize, extra, threads,
                         monkeypatch, *, adjoint):
    if threads:
        monkeypatch.setattr(icr_refine, "CHARTED_THREADS", threads)
    length = (t - 1) * (n_fsz // 2) + n_csz + extra
    (nf, rows, runs, blocks), fine, coarse, fam = _charted_owners(
        batch, t, n_fsz, n_csz, itemsize, length)
    assert (fam == 1).all()
    assert ((coarse if adjoint else fine) == 1).all()
    assert 1 <= rows <= icr_refine.CHARTED_MAX_ROWS
    assert (blocks - 1) * icr_refine.THREADS < -(-batch // rows) * runs <= (
        blocks * icr_refine.THREADS)
    if threads and (n_fsz, n_csz, itemsize) in icr_refine.CHARTED_FAMILIES:
        assert rows == min(batch, icr_refine.CHARTED_MAX_ROWS,
                           -(-batch // -(-batch // max(
                               1, batch * runs // threads))))


@pytest.mark.parametrize("batch,t,n_fsz,n_csz,itemsize,extra",
                         CHARTED_SHAPE_CASES)
@pytest.mark.parametrize("threads", [None, 64], ids=["default", "few"])
def test_charted_forward_shape_owns_every_output_once(
        batch, t, n_fsz, n_csz, itemsize, extra, threads, monkeypatch):
    """Every fine output and every ξ family of the charted forward #3/#4
    (``charted_shape_1d``) is owned by exactly one thread, also when a
    thread takes several rows (few threads aimed for)."""
    _check_charted_shape(batch, t, n_fsz, n_csz, itemsize, extra, threads,
                         monkeypatch, adjoint=False)


@pytest.mark.parametrize("batch,t,n_fsz,n_csz,itemsize,extra",
                         CHARTED_SHAPE_CASES)
@pytest.mark.parametrize("threads", [None, 64], ids=["default", "few"])
def test_charted_adjoint_shape_owns_every_output_once(
        batch, t, n_fsz, n_csz, itemsize, extra, threads, monkeypatch):
    """Every coarse output and every dxi family of the charted adjoint #7
    (the same ``charted_shape_1d``) is owned by exactly one thread, also
    when a thread takes several rows (few threads aimed for)."""
    _check_charted_shape(batch, t, n_fsz, n_csz, itemsize, extra, threads,
                         monkeypatch, adjoint=True)


def test_charted_forward_shape_of_the_main_path():
    """#3's two shapes: the log chart's last level at S=8 (8 rows of
    65 026 families: each thread reads its stencils once for 3 rows) and
    the nd-axes route's axis-0 pass at dust's last level in a learned-θ
    step (S=1: 16 384 rows of 16 families, one row a thread at 1024
    blocks, two a thread at fewer threads aimed for); #4 at log-polar's
    last level (axis 1); the pyramid's charted levels stream with the
    same geometry."""
    shape = icr_refine.charted_shape_1d
    assert shape(8, 65026, 4, 5, 4) == (1, 3, 65026, 763)
    assert shape(8, 65026, 4, 5, 2) == (1, 3, 65026, 763)
    assert shape(16384, 16, 4, 5, 4) == (1, 1, 16, 1024)
    assert shape(16384, 16, 4, 5, 2) == (1, 1, 16, 1024)
    assert shape(3, 37, 2, 3, 4) == (2, 1, 19, 1)
    with pytest.raises(ValueError, match="exceed one launch"):
        shape(2**20, 2**20, 4, 5, 4)


def test_charted_adjoint_shape_of_the_main_path():
    """#7's two shapes at S=8: the log chart's last level (8 rows of 65 026
    families: each thread reads its stencils once for 3 rows) and the dust
    backward's axis-0 pass (131 072 rows of 16 families, 8 rows a
    thread); the runtime-size stencil takes one family of one row."""
    shape = icr_refine.charted_shape_1d
    assert shape(8, 65026, 4, 5, 4) == (1, 3, 65026, 763)
    assert shape(131072, 16, 4, 5, 4) == (1, 8, 16, 1024)
    assert shape(8, 65026, 4, 5, 2)[:2] == (1, 3)
    assert shape(5, 1001, 8, 3, 4)[:2] == (1, 1)
    with pytest.raises(ValueError, match="exceed one launch"):
        shape(2**20, 2**20, 8, 3, 4)


def test_stream_shape_of_the_main_path():
    """The charts' largest stationary levels: regular's last level (#1,
    #5) and dust's trailing axes (#2, #6: rows of 32 families, several to
    a block); the pyramid's stationary levels stream with the same
    geometry."""
    shape = icr_refine.stream_shape_1d
    assert shape(8, 524288, 2, 3, 4) == (4, 131072, 4096)
    assert shape(8, 524288, 2, 3, 2) == (8, 65536, 2048)
    assert shape(8, 524288, 2, 3, 4, adjoint=True) == (2, 262144, 8192)
    assert shape(8, 524288, 2, 3, 2, adjoint=True) == (4, 131072, 4096)
    for itemsize in (4, 2):
        for adjoint in (False, True):
            nf, runs, blocks = shape(32768, 32, 4, 5, itemsize,
                                     adjoint=adjoint)
            assert (nf, runs) == (2, 16)
            assert icr_refine.THREADS // runs == 16     # rows per block
            assert blocks == 32768 // 16
    assert shape(5, 1001, 8, 3, 4)[0] == 1            # runtime-size instance
    with pytest.raises(ValueError, match="exceed one launch"):
        shape(2**20, 2**20, 2, 3, 4)
    # the pyramid's launch table: (families per run, runs per row) of each
    # stationary level in its last two columns (regular's cover at S=8;
    # they depend on shapes only)
    from repro_torch.kernels import pyramid as tpyramid

    chart = tcharts.regular_chart(1024, 10, boundary="reflect")
    geoms = [trefine.LevelGeom.for_level(chart, lvl) for lvl in range(9)]
    field = torch.zeros((8,) + geoms[0].coarse_shape)
    xis = [torch.zeros((8,) + tuple(g.T) + (g.n_fsz,)) for g in geoms]
    mats = [([torch.zeros(g.n_fsz, g.n_csz)], [torch.zeros(g.n_fsz,
                                                             g.n_fsz)])
            for g in geoms]
    field, levels = tpyramid.pyramid_operands(field, xis, mats, geoms,
                                              sample_axis=True)
    table = tpyramid._table(field, geoms, levels)
    assert [tuple(row[[18, 21]]) for row in table] == [
        (4, 256 * 2**lvl) for lvl in range(9)]


# -- dispatch ----------------------------------------------------------------------
@pytest.mark.parametrize("build_chart,route,n", [
    (lambda m: m.galactic_dust_chart((8, 16, 16), 3), "nd-fused", 3),
    (lambda m: m.regular_chart(1024, 10, boundary="reflect"),
     "stationary-1d", 10),
    (lambda m: m.log_chart(1024, 8, n_csz=5, n_fsz=4, delta0=0.0197 / 16),
     "charted-1d", 8),
    (lambda m: m.regular_chart((32, 32), 2, boundary="reflect"),
     "nd-fused", 2),
])
def test_plan_routes_match_reference(build_chart, route, n):
    """The routes of the serving charts; the JAX package's per-level
    routes (pyramid off) agree wherever its VMEM autotuner keeps the
    fused route."""
    p = dispatch.plan(build_chart(tcharts))
    assert [e["route"] for e in p] == [route] * n
    assert all(e["launches"] == 1 for e in p)
    assert {e["kernel"] for e in p} == {dispatch.KERNEL_OF_ROUTE[route]}
    jp = jdispatch.plan(build_chart(jcharts), pyramid=False)
    assert [e["route"] for e in jp] == [route] * n


def test_nd_level_needs_axis_factors():
    geom = trefine.LevelGeom.for_level(tcharts.regular_chart((8, 8), 1), 0)
    with pytest.raises(ValueError, match="per-axis factors"):
        dispatch.route_for(geom)


@pytest.mark.parametrize("dname", sorted(TOL))
@pytest.mark.parametrize("build_chart", [
    lambda m: m.regular_chart(40, 2, boundary="reflect"),
    lambda m: m.regular_chart(24, 2, n_csz=5, n_fsz=4),
    lambda m: m.log_chart(12, 2, n_csz=5, n_fsz=4, delta0=0.05),
], ids=["stationary-reflect", "stationary-5x4", "charted-log"])
def test_dispatch_refine_matches_reference(build_chart, dname, monkeypatch):
    """One 1-D level through each package's dispatch, with the policy
    cast, sample axis and reflect padding of the glue."""
    monkeypatch.setenv("REPRO_BACKEND", "interpret")
    jc, tc = build_chart(jcharts), build_chart(tcharts)
    k = jkernels.matern32.with_defaults(rho=2.0)()
    rng = np.random.default_rng(7)
    for lvl in range(jc.n_levels):
        geom = jrefine.LevelGeom.for_level(jc, lvl)
        r, d = jax.jit(lambda: jrefine.refinement_matrices_level(
            jc, k, lvl))()
        field = rng.normal(size=(3,) + geom.coarse_shape).astype(np.float32)
        xi = rng.normal(size=(3, geom.T[0], geom.n_fsz)).astype(np.float32)
        want = jdispatch.refine(jnp.asarray(field), jnp.asarray(xi), r, d,
                                geom, sample_axis=True, policy=dname)
        got = dispatch.refine(
            torch.from_numpy(field), torch.from_numpy(xi),
            to_torch(np.asarray(r), device="cpu"),
            to_torch(np.asarray(d), device="cpu"),
            trefine.LevelGeom.for_level(tc, lvl), sample_axis=True,
            policy=dname)
        assert got.dtype == DTYPES[dname][1]
        assert rel(t2n(got), j2n(want)) < TOL[dname]


# -- wrapper checks ----------------------------------------------------------------
def test_kernel_route_refuses_gradients():
    """The kernel route refuses only the gradients it has no kernel for:
    a 1-D level carries them through its adjoint, while N-D factors that
    require grad (learned θ through the N-D route) raise."""
    rng = np.random.default_rng(8)
    ops = [torch.tensor(a, dtype=torch.float32) for a in _1d_operands(
        rng, batch=1, t=5, n_csz=3, n_fsz=2, charted=False)]
    ops[1].requires_grad_(True)
    out = icr_refine.refine_stationary(*ops)
    (dxi,) = torch.autograd.grad(out.sum(), ops[1])
    assert dxi.shape == ops[1].shape
    with torch.no_grad():
        icr_refine.refine_stationary(*ops)
    c = tcharts.regular_chart((8, 8), 1)
    geom = trefine.LevelGeom.for_level(c, 0)
    rs = [torch.randn(2, 3, requires_grad=True), torch.randn(2, 3)]
    ds = [torch.randn(2, 2), torch.randn(2, 2)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        nd_fused.refine_nd_fused(torch.randn(8, 8), torch.randn(36, 4), rs,
                                 ds, geom)


def test_operand_checks_before_a_launch():
    """``launch.run_plan`` checks every tensor against its plan (shape,
    dtype) and takes CUDA tensors only, before any pointer goes to C."""
    from repro_torch.kernels import launch

    plan = icr_refine.refine_1d_plan(batch=2, t=3, coarse_len=5, n_fsz=2,
                                     n_csz=3, charted=False)
    with pytest.raises(ValueError, match="expected cuda"):
        launch.run_plan(plan, {"out": torch.zeros(2, 6)})
    with pytest.raises(launch.PlanMismatchError):
        launch.run_plan(plan, {"out": torch.zeros(2, 7)})
    with pytest.raises(launch.PlanMismatchError):
        launch.run_plan(plan, {"out": torch.zeros(2, 6,
                                                  dtype=torch.bfloat16)})
    with pytest.raises(TypeError):
        build.dtype_code(torch.float64)
    assert build.dtype_code(torch.bfloat16) == 1
    assert build.library_path("nd_fused").suffix == ".so"
