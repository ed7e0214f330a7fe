"""The port's mesh serving (``GPFieldServer(mesh=, shard=)``), elastic
re-meshing and the chaos suite, on the CPU (virtual meshes of slots on
``cpu``).

* Samples mode serves the unsharded server's fields and moments bit for
  bit (each slot runs a whole slab, the one the unsharded server packs);
  chart mode within 1e-5 relative to the largest magnitude.
* One slot against the JAX server on its one device, in both modes:
  requests carrying their own ξ on a MAP posterior, the port's server on
  the JAX package's matrices, at 1e-5 (as ``test_torch_serve_gp.py``
  holds the unsharded servers).
* Capacity pinning; the mesh in the cache key, the fingerprint and
  ``plan_cached``'s key.
* ``elastic``'s decisions (applied spec and reasons) against the JAX
  module's ``_fit_spec`` on the same specs (it reads only the mesh's
  ``shape``), its records against the JAX module's ``remesh_report`` on
  one CPU device, and ``shrink_mesh``.
* The seven chaos checks (``repro_torch.distributed.chaos``) on 8 slots.
* The RHS-sharded conditioning system and ``cg_posterior(mesh=)`` against
  the unsharded ones.
"""
import dataclasses
import types
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ICR as JICR
from repro.core import charts as jcharts
from repro.core import kernels as jkernels
from repro.core.vi import Posterior as JPosterior
from repro.distributed import elastic as jelastic
from repro.launch import serve_gp as jserve
from repro.launch.mesh import make_mesh as jmake_mesh
from repro_torch import ICR, cg_posterior
from repro_torch.convert import matrices_to_torch, posterior_to_torch
from repro_torch.core import charts as tcharts
from repro_torch.core import kernels as tkernels
from repro_torch.distributed import chaos, elastic
from repro_torch.kernels import dispatch
from repro_torch.launch import serve_gp as sg
from repro_torch.launch.mesh import P, make_mesh
from repro_torch.solvers import build_condition_system, obs_operator

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

CPU = torch.device("cpu")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _mesh(n, axis="data"):
    return make_mesh((n,), (axis,), devices=[CPU] * n)


def _post(name="tod", pol=None):
    return sg.demo_posterior(sg.scenario_chart(name, quick=True),
                             sg.SCENARIOS[name], dtype_policy=pol,
                             device="cpu")


def _requests(shapes=None):
    """``mixed_requests(3, 8)``, and with `shapes` (the xi_shapes) a
    request that brings its own ξ."""
    reqs = sg.mixed_requests(3, 8)
    if shapes is not None:
        rng = np.random.default_rng(3)
        reqs.append(sg.GPRequest(kind="sample", n=3, seed=9, xi=[
            rng.normal(size=s).astype(np.float32) for s in shapes]))
    return reqs


def _results(reqs):
    out = []
    for r in reqs:
        assert r.done and r.error is None, r.error
        out.extend(r.fields if r.kind == "sample" else [r.mean, r.std])
    return out


# -- samples mode and chart mode against the unsharded server ---------------------
@pytest.mark.parametrize("pol", [None, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", ["tod", "dust"])
def test_samples_mode_equals_the_unsharded_server_bit_for_bit(name, pol):
    post = _post(name, pol)
    shapes = post.icr.xi_shapes()
    base, got = _requests(shapes), _requests(shapes)
    sg.GPFieldServer(post, slab=2).run(base)
    srv = sg.GPFieldServer(post, slab=2, mesh=_mesh(8))
    srv.run(got)
    assert srv.serving_mode == "sharded-samples:cpu-eager"
    assert srv.capacity == 16 and len(srv._entry["slots"]) == 8
    for a, b in zip(_results(base), _results(got)):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name,slots", [("tod", 8), ("dust", 2)])
def test_chart_mode_matches_the_unsharded_server(name, slots):
    post = _post(name)
    base, got = _requests(), _requests()
    sg.GPFieldServer(post, slab=4).run(base)
    srv = sg.GPFieldServer(post, slab=4, mesh=_mesh(slots, "space"),
                           shard="chart")
    srv.run(got)
    assert srv.serving_mode == "sharded-chart:cpu-eager"
    assert srv.capacity == 4
    for a, b in zip(_results(base), _results(got)):
        assert rel(b, a) <= 1e-5


# -- one slot against the JAX server on its one device ----------------------------
@dataclasses.dataclass(frozen=True)
class CarriedICR(ICR):
    """The port's ICR on matrices carried across from the JAX package."""

    carried: Any = None

    def matrices(self, theta=None, **kw):
        return self.carried

    def matrices_cached(self, theta=None, **kw):
        return self.carried


@dataclasses.dataclass(frozen=True)
class JitICR(JICR):
    """The JAX package's ICR with its matrices built under ``jax.jit``."""

    def matrices(self, theta=None, **kw):
        return jax.jit(lambda: JICR.matrices(self, theta, **kw))()


@pytest.mark.parametrize("shard", ["samples", "chart"])
def test_one_slot_matches_the_jax_server(shard):
    rho = 8.0
    jicr = JitICR(jcharts.regular_chart(32, 3, boundary="reflect"),
                  jkernels.matern32.with_defaults(rho=rho), use_pallas=True)
    rng = np.random.default_rng(5)
    xi_hat = [rng.normal(size=s).astype(np.float32)
              for s in jicr.xi_shapes()]
    jpost = JPosterior(icr=jicr, mean=[jnp.asarray(x) for x in xi_hat])
    mats = matrices_to_torch(jax.tree.map(
        np.asarray, jicr.matrices_cached()), device="cpu")
    ticr = CarriedICR(tcharts.regular_chart(32, 3, boundary="reflect"),
                      tkernels.matern32.with_defaults(rho=rho),
                      use_pallas=True, device="cpu", carried=mats)
    tpost = posterior_to_torch(ticr, xi_hat, dtype=torch.float32)

    def reqs(make):
        r = np.random.default_rng(17)
        own = lambda: [r.normal(size=s).astype(np.float32)  # noqa: E731
                       for s in jicr.xi_shapes()]
        return [make(kind="sample", n=2, seed=1, xi=own()),
                make(kind="moments", n=3, seed=2, xi=own())]

    jreqs, treqs = reqs(jserve.GPRequest), reqs(sg.GPRequest)
    axis = "data" if shard == "samples" else "space"
    jsrv = jserve.GPFieldServer(jpost, slab=4, mesh=jmake_mesh((1,), (axis,)),
                                shard=shard)
    tsrv = sg.GPFieldServer(tpost, slab=4, mesh=_mesh(1, axis), shard=shard)
    jsrv.run(jreqs)
    tsrv.run(treqs)
    assert jsrv.serving_mode.startswith(f"sharded-{shard}")
    assert tsrv.serving_mode.startswith(f"sharded-{shard}")
    for j, t in zip(jreqs, treqs):
        assert j.error is None and t.error is None
        pairs = (zip(t.fields, j.fields) if t.kind == "sample"
                 else [(t.mean, j.mean)])
        for a, b in pairs:
            assert rel(a, b) <= 1e-5
        if t.kind == "moments":
            np.testing.assert_allclose(t.std, 0.0, atol=1e-5)


# -- capacity and the cache key -----------------------------------------------------
def test_capacity_is_pinned_per_slot_and_contracts_with_the_mesh():
    inj = chaos.ChaosInjector([chaos.KillDevice(at_slab=0,
                                                device_indices=(5,))])
    srv = sg.GPFieldServer(_post(), slab=3, mesh=_mesh(4), fault_injector=inj)
    assert (srv.capacity, srv._entry["local_rows"]) == (12, 3)
    assert all(tuple(s["bufs"]["meta"].shape) == (3, 3)
               for s in srv._entry["slots"])
    srv.run([sg.GPRequest(kind="sample", n=5, seed=1)])
    assert srv.mesh.size == 3 and srv.capacity == 9
    assert [s.id for s in srv.mesh.slots] == [0, 2, 3]
    assert all(tuple(s["bufs"]["meta"].shape) == (3, 3)
               for s in srv._entry["slots"])
    m = srv.metrics()
    assert (m["replans"], m["replayed_slabs"], m["dead_devices"]) == (1, 1,
                                                                      [1])
    assert m["mesh"] == "samples:3:data" and m["last_recovery_s"] > 0


def test_mesh_is_part_of_the_cache_key_and_fingerprint():
    post = _post()
    plain = sg.GPFieldServer(post, slab=4)
    meshed = sg.GPFieldServer(post, slab=4, mesh=_mesh(1))
    fp_plain = plain.cache_key_fingerprint()
    fp_mesh = meshed.cache_key_fingerprint()
    assert fp_plain["mesh"] == "unsharded"
    assert fp_mesh["mesh"].startswith("samples:1:")
    assert fp_plain["digest"] != fp_mesh["digest"]
    assert plain._cache_key(post) != meshed._cache_key(post)
    charted = sg.GPFieldServer(post, slab=4, mesh=_mesh(1, "space"),
                               shard="chart")
    assert charted.cache_key_fingerprint()["digest"] not in (
        fp_plain["digest"], fp_mesh["digest"])
    # equal-size meshes on other slots are other keys too
    other = make_mesh((1,), ("data",), devices=[CPU])
    object.__setattr__(other, "ids", np.asarray([7]))
    assert sg.GPFieldServer(post, slab=4, mesh=other).cache_key_fingerprint(
    )["digest"] != fp_mesh["digest"]
    with pytest.raises(ValueError, match="shard"):
        sg.GPFieldServer(post, slab=4, mesh=_mesh(1), shard="rows")


def test_plan_cached_mesh_key():
    chart = tcharts.regular_chart(32, 3, boundary="reflect")
    dispatch.plan_cache_clear()
    p1 = dispatch.plan_cached(chart, samples=4, device="cpu")
    p2 = dispatch.plan_cached(chart, samples=4, device="cpu",
                              mesh_key=("samples", ("data",), (8,)))
    assert p1 is not p2  # a re-mesh re-plans, never a stale hit
    assert p1 == p2      # ...but the per-slot routing is unchanged
    assert dispatch.plan_cache_stats["misses"] == 2


# -- elastic against the JAX module ----------------------------------------------
FIT_CASES = [  # (spec dims, leaf shape, mesh shape)
    (("model",), (8, 4), {"data": 1}),
    (("data",), (3,), {"data": 1}),
    (("data", None), (12, 5), {"data": 8}),
    ((None, ("pod", "data")), (4, 16), {"pod": 2, "data": 4}),
    ((("pod", "data"),), (6,), {"pod": 2, "data": 4}),
    (("data", "model"), (8, 3), {"data": 8}),
]


@pytest.mark.parametrize("case", range(len(FIT_CASES)))
def test_fit_spec_decides_as_the_jax_module(case):
    from jax.sharding import PartitionSpec as JP

    dims, shape, mesh_shape = FIT_CASES[case]
    stub = types.SimpleNamespace(shape=dict(mesh_shape))
    leaf = np.zeros(shape, np.float32)
    want_spec, want_reasons = jelastic._fit_spec(JP(*dims), leaf, stub)
    got_spec, got_reasons = elastic._fit_spec(P(*dims), leaf, stub)
    assert str(got_spec) == str(want_spec)
    assert got_reasons == want_reasons


def test_remesh_report_records_as_the_jax_module():
    from jax.sharding import PartitionSpec as JP

    tree = {"w": np.zeros((8, 4), np.float32), "b": np.zeros(3, np.float32),
            "R": [np.zeros((2, 2), np.float32)] * 2}
    jspecs = {"w": JP("model"), "b": JP("data"), "R": [JP(), JP("pod")]}
    tspecs = {"w": P("model"), "b": P("data"), "R": [P(), P("pod")]}
    _, jrep = jelastic.remesh_report(tree, jmake_mesh((1,), ("data",)),
                                     jspecs)
    placed, trep = elastic.remesh_report(
        {k: (torch.tensor(v) if not isinstance(v, list)
             else [torch.tensor(x) for x in v]) for k, v in tree.items()},
        _mesh(1), tspecs)
    assert sorted(dataclasses.astuple(d) for d in trep) == \
        sorted(dataclasses.astuple(d) for d in jrep)
    assert len(trep) == 2 and tuple(placed["w"][0].shape) == (8, 4)
    seen = []
    elastic.remesh({"w": torch.zeros(4)}, _mesh(1), {"w": P("model")},
                   on_degrade=seen.append)
    assert len(seen) == 1 and "model" in str(seen[0])
    # a split spec gives each slot its block, shared per (device, block)
    blocks = _mesh(4).shard(torch.arange(8.0), P("data"))
    assert [b.tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_shrink_mesh():
    mesh = _mesh(3)
    assert elastic.shrink_mesh(mesh, [0, 1]) is None  # one survivor
    with pytest.raises(RuntimeError, match="no devices survive"):
        elastic.shrink_mesh(mesh, [0, 1, 2])
    two = elastic.shrink_mesh(mesh, [1])
    assert [s.id for s in two.slots] == [0, 2] and two.axis_names == ("data",)
    jmesh = jmake_mesh((1,), ("data",))
    dev = int(np.asarray(jmesh.devices).flat[0].id)
    assert jelastic.shrink_mesh(jmesh, [dev + 999]) is None
    assert elastic.shrink_mesh(_mesh(1), [999]) is None
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        make_mesh((4,), ("data",), devices=[CPU] * 3)


# -- chaos on 8 slots ---------------------------------------------------------------
@pytest.mark.parametrize("check", chaos.CHECKS + chaos.SOLVER_CHECKS,
                         ids=lambda c: c.__name__)
def test_chaos_check_on_eight_cpu_slots(check):
    msg = check("cpu")
    assert isinstance(msg, str) and msg


# -- the RHS-sharded conditioning system ---------------------------------------------
def test_rhs_sharded_system_and_cg_posterior_match_the_unsharded():
    post = _post()
    icr = post.icr
    n = int(np.prod(icr.chart.final_shape))
    obs_idx = np.arange(0, n, 3)
    op = obs_operator(icr, obs_idx=obs_idx)
    plain = build_condition_system(icr, op, 0.05 ** 2)
    sharded = build_condition_system(icr, op, 0.05 ** 2, mesh=_mesh(4))
    assert sharded.mesh is not None and plain.mesh is None
    v = torch.randn((5, op.n_obs), generator=torch.Generator()
                    .manual_seed(0))
    assert rel(sharded.matvec(v), plain.matvec(v)) <= 1e-5
    y = np.sin(np.linspace(0, 4, obs_idx.size))
    want, rep0 = cg_posterior(icr, obs_idx, y, noise_std=0.1)
    got, rep1 = cg_posterior(icr, obs_idx, y, noise_std=0.1, mesh=_mesh(8))
    assert rep0.ok and rep1.ok
    for a, b in zip(got.mean, want.mean):
        assert rel(a, b) <= 1e-5
