"""The port's ``DistributedICR`` (``repro_torch.core.distributed``) held to
the JAX package's, on the CPU.

* Geometry: ``first_sharded_level``, ``xi_structure``, ``xi_specs``, the
  joint ``mat_specs`` and ``_local_geom`` equal the JAX class's for rings
  of 1, 2, 4 and 8 (both read only ``mesh.shape``: a stand-in mesh
  object serves), raises included.
* Values: the port's sharded square root on an 8-slot ``cpu`` mesh (2x4
  for the multi-pod ring) equals the JAX package's **unsharded**
  ``ICR.apply_sqrt_batch`` on the same numpy ξ and the JAX package's own
  matrices (``convert.matrices_to_torch``: the two packages' roots differ
  by eigh column signs), for the six cases of ``_dist_icr_check`` and the
  charted N-D shard axes, with and without a sample axis (the dust
  chart at (6, 16, 8): its level-0 root, a dense eigh of prod(shape0),
  is most of the JAX build's time at (6, 32, 16); the first sharded level
  at 8 slots is level 1 at both sizes). Tolerance,
  relative to the largest magnitude: 1e-5 at float32, 5e-2 with bfloat16
  storage.
* The JAX ``DistributedICR`` on its in-process 1-device mesh equals the
  port on one slot; the halo at the ring's global edges is the chart's
  reflection.

XLA_FLAGS is never set here: the JAX side runs unsharded (or on its one
device).
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import use_mesh
from repro.core import ICR as JICR
from repro.core import charts as jcharts
from repro.core import kernels as jkernels
from repro.core.distributed import DistributedICR as JDistributedICR
from repro.launch.mesh import make_mesh as jmake_mesh
from repro_torch import ICR
from repro_torch.convert import matrices_to_torch
from repro_torch.core import charts as tcharts
from repro_torch.core import kernels as tkernels
from repro_torch.core.distributed import DistributedICR, reflect_edges
from repro_torch.core.refine import reflect_pad
from repro_torch.launch.mesh import P, make_mesh

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

TOL = {None: 1e-5, "bf16": 5e-2}
CPU8 = [torch.device("cpu")] * 8


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# (a function of a charts module that makes the chart, kernel ρ)
CHARTS = {
    "regular": (lambda m: m.regular_chart(32, 4, boundary="reflect"), 16.0),
    "regular64": (lambda m: m.regular_chart(64, 3, boundary="reflect"), 20.0),
    "log": (lambda m: m.log_chart(32, 4, n_csz=5, n_fsz=4, delta0=0.01,
                                  boundary="reflect"), 1.0),
    "dust": (lambda m: m.galactic_dust_chart((6, 32, 16), 2), 0.5),
    "dust_small": (lambda m: m.galactic_dust_chart((6, 16, 8), 2), 0.5),
    "dust_radial": (lambda m: m.galactic_dust_chart((16, 8, 8), 2), 0.5),
    "log_polar": (lambda m: m.log_polar_chart((16, 16), 2), 2.0),
}


# -- geometry ------------------------------------------------------------------
def _mesh_stub(n):
    return types.SimpleNamespace(shape={"space": n})


def _geometry(dist):
    """Everything the geometry tests compare, or the raise's message."""
    try:
        k = dist.first_sharded_level()
    except ValueError as e:
        return ("raises", str(e))
    c = dist.chart
    specs = dist.mat_specs()
    return (k, [tuple(s) for s in dist.xi_structure()],
            [tuple(s) for s in dist.xi_specs()],
            [tuple(s) for s in specs["R"]], [tuple(s) for s in specs["sqrtD"]],
            tuple(dist.out_spec()),
            [dataclasses.astuple(dist._local_geom(lvl, sharded))
             for lvl in range(c.n_levels) for sharded in (False, True)])


@pytest.mark.parametrize("name,axis", [
    ("regular", 0), ("log", 0), ("dust", 0), ("dust", 1), ("dust", 2),
    ("dust_radial", 0), ("log_polar", 0), ("log_polar", 1)])
def test_geometry_equals_the_jax_class(name, axis):
    build, rho = CHARTS[name]
    jicr = JICR(build(jcharts), jkernels.matern32.with_defaults(rho=rho))
    ticr = ICR(build(tcharts), tkernels.matern32.with_defaults(rho=rho),
               device="cpu")
    for n in (1, 2, 4, 8):
        want = _geometry(JDistributedICR(icr=jicr, mesh=_mesh_stub(n),
                                         axis_names=("space",),
                                         shard_axis=axis))
        got = _geometry(DistributedICR(ticr, _mesh_stub(n), ("space",),
                                       axis))
        assert got == want, (n, got, want)


def test_requires_reflect_and_prints_specs_as_jax():
    icr = ICR(tcharts.regular_chart(32, 2), tkernels.matern32, device="cpu")
    with pytest.raises(ValueError, match="reflect"):
        DistributedICR(icr, _mesh_stub(1))
    from jax.sharding import PartitionSpec as JP

    for dims in [(), (None, None), ("model",), (("pod", "space"), None)]:
        assert str(P(*dims)) == str(JP(*dims))


# -- values against the JAX package's unsharded square root --------------------
# name -> (chart, pallas, ring shape, ring axes, shard axis): the six cases
# of launch/_dist_icr_check.py, then the charted N-D shard axes
CASES = {
    "1d_regular": ("regular", False, (8,), ("space",), 0),
    "1d_log_charted": ("log", False, (8,), ("space",), 0),
    "1d_multipod_ring": ("regular64", False, (2, 4), ("pod", "space"), 0),
    "3d_dust_angular_shard": ("dust_small", False, (8,), ("space",), 1),
    "1d_regular_pallas": ("regular", True, (8,), ("space",), 0),
    "1d_log_charted_pallas": ("log", True, (8,), ("space",), 0),
    "3d_dust_radial_pallas": ("dust_radial", True, (8,), ("space",), 0),
    "3d_dust_angular_pallas": ("dust_small", True, (8,), ("space",), 1),
    "2d_log_polar_axis0_pallas": ("log_polar", True, (8,), ("space",), 0),
    "2d_log_polar_axis1_pallas": ("log_polar", True, (8,), ("space",), 1),
}


@functools.lru_cache(maxsize=None)
def _jax_matrices(chart, joint):
    """The JAX package's float32 matrices of `chart` (jitted build): the
    joint ones (the plain path, and every 1-D chart's kernel route) or an
    N-D chart's per-axis factors."""
    build, rho = CHARTS[chart]
    jicr = JICR(build(jcharts), jkernels.matern32.with_defaults(rho=rho),
                use_pallas=not joint)
    return jax.tree.map(np.asarray, jax.jit(jicr.matrices)())


def _jax_side(chart, pallas, pol):
    """The JAX ICR, its matrices at the policy's storage dtype (its
    bfloat16 matrices are the float32 ones rounded) and the port's ICR."""
    build, rho = CHARTS[chart]
    jicr = JICR(build(jcharts), jkernels.matern32.with_defaults(rho=rho),
                use_pallas=pallas, dtype_policy=pol)
    joint = not pallas or jicr.chart.ndim == 1
    mats = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jicr.policy.storage_dtype)),
        _jax_matrices(chart, joint))
    ticr = ICR(build(tcharts), tkernels.matern32.with_defaults(rho=rho),
               use_pallas=pallas, dtype_policy=pol, device="cpu")
    return jicr, mats, ticr


@functools.lru_cache(maxsize=None)
def _reference(case, pol):
    """Numpy ξ with a sample axis of 3 and the JAX package's unsharded
    square root of it."""
    chart, pallas, _, _, _ = CASES[case]
    jicr, mats, _ = _jax_side(chart, pallas, pol)
    rng = np.random.default_rng(7)
    xi = [rng.normal(size=(3,) + s).astype(np.float32)
          for s in jicr.xi_shapes()]
    want = jax.jit(jicr.apply_sqrt_batch)(
        mats, [jnp.asarray(x, jicr.policy.storage_dtype) for x in xi])
    return xi, np.asarray(want, np.float32)


def _sharded_vs_jax(case, pol, sample_axis):
    chart, pallas, shape, axes, shard_axis = CASES[case]
    _, mats, ticr = _jax_side(chart, pallas, pol)
    xi, want = _reference(case, pol)
    mesh = make_mesh(shape, axes, devices=CPU8)
    dist = DistributedICR(ticr, mesh, axes, shard_axis)
    tmats = matrices_to_torch(mats, device="cpu")
    txi = [torch.tensor(x).to(ticr.policy.storage_dtype) for x in xi]
    if sample_axis:
        blocks = dist.apply_sqrt_batch(tmats, txi)
    else:
        blocks = dist.apply_sqrt(tmats, [x[1] for x in txi])
        want = want[1]
    assert len(blocks) == dist.n_dev
    got = dist.gather(blocks)
    assert got.dtype == ticr.policy.storage_dtype
    assert tuple(got.shape) == want.shape
    return rel(got.float().numpy(), want)


@pytest.mark.parametrize("sample_axis", [False, True],
                         ids=["no-sample-axis", "S3"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_equals_the_jax_unsharded_sqrt(case, sample_axis):
    assert _sharded_vs_jax(case, None, sample_axis) <= TOL[None]


@pytest.mark.parametrize("case", ["1d_log_charted_pallas",
                                  "3d_dust_angular_pallas",
                                  "2d_log_polar_axis1_pallas"])
def test_sharded_bf16_equals_the_jax_unsharded_sqrt(case):
    assert _sharded_vs_jax(case, "bf16", True) <= TOL["bf16"]


# -- one slot against the JAX class on its one device --------------------------
@functools.lru_cache(maxsize=None)
def _jax_one_device():
    """The JAX ``DistributedICR`` on its in-process 1-device mesh (the
    jnp interior): its ξ, matrices and output, as numpy."""
    jicr = JICR(jcharts.regular_chart(32, 3, boundary="reflect"),
                jkernels.matern32.with_defaults(rho=10.0))
    jmesh = jmake_mesh((1,), ("space",))
    jdist = JDistributedICR(icr=jicr, mesh=jmesh, axis_names=("space",))
    rng = np.random.default_rng(0)
    # the class's own placement (``init_xi``/``matrices`` place by
    # ``shardings()``) on a numpy ξ and a jitted joint build
    mat_sh, xi_sh, _ = jdist.shardings()
    with use_mesh(jmesh):
        jxi = [jax.device_put(rng.normal(size=s).astype(np.float32), sh)
               for s, sh in zip(jdist.xi_structure(), xi_sh)]
        jmats = jax.tree.map(jax.device_put, jax.jit(
            lambda: jicr.matrices(joint=True, axes=False))(), mat_sh)
        want = np.asarray(jax.jit(jdist.apply_sqrt)(jmats, jxi))
    return ([np.asarray(x) for x in jxi], jax.tree.map(np.asarray, jmats),
            want)


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "kernels"])
def test_one_slot_equals_the_jax_distributed_icr(pallas):
    jxi, jmats, want = _jax_one_device()
    ticr = ICR(tcharts.regular_chart(32, 3, boundary="reflect"),
               tkernels.matern32.with_defaults(rho=10.0), use_pallas=pallas,
               device="cpu")
    dist = DistributedICR(ticr, make_mesh((1,), ("space",), devices=CPU8))
    blocks = dist.apply_sqrt(matrices_to_torch(jmats, device="cpu"),
                             [torch.tensor(x) for x in jxi])
    assert len(blocks) == 1
    assert rel(dist.gather(blocks).numpy(), want) <= 1e-5


def test_halo_at_the_global_edges_is_the_reflection():
    chart = tcharts.galactic_dust_chart((6, 32, 16), 2)
    icr = ICR(chart, tkernels.matern32, device="cpu")
    dist = DistributedICR(icr, make_mesh((4,), ("space",), devices=CPU8),
                          shard_axis=1)
    b = chart.b
    field = torch.randn((2,) + chart.shape(1), generator=torch.Generator()
                        .manual_seed(0))
    blocks = list(field.chunk(4, dim=2))
    padded = [dist._pad_unsharded_axes(p)
              for p in dist._halo_exchange(blocks, b)]
    whole = reflect_pad(field, b, 3)   # the unsharded level's padding
    step = blocks[0].shape[2]
    for i, p in enumerate(padded):
        assert torch.equal(p, whole[:, :, i * step:i * step + step + 2 * b])
        assert p.data_ptr() != blocks[i].data_ptr()
    # the two global edges alone: numpy's "reflect" on that axis
    one = reflect_edges(field, 2, b)
    assert torch.equal(one, torch.from_numpy(np.pad(
        field.numpy(), [(0, 0), (0, 0), (b, b), (0, 0)], mode="reflect")))


def test_sample_draws_and_places_the_excitations():
    """``init_xi`` draws the ``xi_structure`` leaves in order from the
    generator (the same normals ``ICR.init_xi`` draws) and places them;
    ``sample`` gathers the sharded field."""
    icr = ICR(tcharts.regular_chart(32, 3, boundary="reflect"),
              tkernels.matern32.with_defaults(rho=10.0), use_pallas=True,
              device="cpu")
    dist = DistributedICR(icr, make_mesh((4,), ("space",), devices=CPU8))
    xi = dist.init_xi(torch.Generator().manual_seed(3))
    assert [len(leaf) for leaf in xi] == [4] * len(xi)
    assert tuple(xi[1][0].shape) == (8, 2)     # 32 families over 4 slots
    got = dist.sample(torch.Generator().manual_seed(3))
    want = icr.apply_sqrt(icr.matrices(),
                          icr.init_xi(torch.Generator().manual_seed(3)))
    assert rel(got.numpy(), want.numpy()) <= 1e-5
