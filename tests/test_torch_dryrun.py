"""The port's dry run held to the JAX package's on the CPU.

* ``configs.input_specs``: shapes and dtypes equal to the JAX package's
  ``ShapeDtypeStruct``s for the ten architectures × four cells.
* ``layers._low_on_card`` takes the card's branch on ``meta``: a bf16
  matmul's op list there has no float32 widening of its operands.
* ``roofline/op_cost.py``'s FLOPs equal ``repro.roofline.hlo_cost.
  module_costs(...)["flops"]`` of the same program compiled by JAX on the
  CPU: a chain of matmuls and einsums, and the reduced prefill of three
  architectures (gemma3-4b, starcoder2, deepseek-v2: MLA and MoE), all
  exactly.
* ``RooflineTerms``: the arithmetic and the dominant term of
  ``tests/test_roofline.py`` at the H100 constants; the per-device
  collective conversion on a hand-counted case; ``fits_hbm`` only where
  the fullest slot and the home slot both fit.
* The executor's representative-row mode equal to the full run on meshes
  (4, 2) and (2, 2, 2) of ``meta`` slots, for the train step (at accum 1
  and 2: one microbatch standing for both), the prefill and the serve
  step: FLOPs, bytes, collective calls and bytes, each slot's peak, and
  the home's (without accumulation).
* ``run_icr_cell``'s geometry against the JAX package's
  ``DistributedICR`` on a stand-in mesh (the rules read ``mesh.shape``):
  first sharded level, ξ structure, matrix specs, halo bytes and useful
  FLOPs for the three ICR architectures on both production meshes.
* ``all_cells()`` equal to the JAX dry run's list; one reduced LM row
  through ``run_cell`` with the JAX row's keys; the command line on an
  ICR cell.
"""
import ast
import collections
import contextlib
import io
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import input_specs as jinput_specs
from repro.configs.registry import ICR_ARCHS as JICR_ARCHS
from repro.core.distributed import DistributedICR as JDistributedICR
from repro.models import build_model as jbuild_model
from repro.roofline.hlo_cost import module_costs as jmodule_costs
from repro_torch.configs import ARCHS, SHAPES, ShapeCell, get_arch, input_specs
from repro_torch.configs.registry import ICR_ARCHS
from repro_torch.core.distributed import DistributedICR
from repro_torch.distributed.executor import Executor
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as hw
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import build_model, layers
from repro_torch.roofline import analysis
from repro_torch.roofline.op_cost import HOME, OpCounter

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

TORCH_DTYPE = {"int32": torch.int32, "float32": torch.float32,
               "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_input_specs_equal_the_jax_packages(name, shape):
    got = input_specs(get_arch(name), SHAPES[shape])
    want = jinput_specs(JARCHS[name], JSHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), (k, shape)
        assert got[k].dtype == TORCH_DTYPE[str(w.dtype)], (k, shape)


def test_meta_takes_the_cards_branch():
    """A bf16 ``matmul`` on ``meta``: one product with float32
    accumulation, no float32 copy of either operand."""
    ops = []

    class Ops(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ops.append((func._overloadpacket.__name__, out.dtype))
            return out

    x = torch.empty((2, 3, 8), dtype=torch.bfloat16, device="meta")
    w = torch.empty((8, 5), dtype=torch.bfloat16, device="meta")
    assert layers._low_on_card(x, w)
    with Ops():
        y = layers.matmul(x, w)
    assert y.dtype == torch.bfloat16
    products = [o for o in ops if o[0] == "mm"]
    assert products == [("mm", torch.float32)]
    widened = [o for o in ops if o[0] == "_to_copy" and o[1] == torch.float32]
    assert not widened, ops
    # the CPU path is unchanged: its operands widened, exactly
    xc, wc = torch.ones((2, 8), dtype=torch.bfloat16), torch.ones(
        (8, 5), dtype=torch.bfloat16)
    assert not layers._low_on_card(xc, wc)


def test_op_cost_flops_equal_hlo_cost_on_a_chain():
    a, b = np.ones((16, 32), np.float32), np.ones((32, 24), np.float32)
    c = np.ones((4, 24, 8), np.float32)

    def jfn(a, b, c):
        h = a @ b
        g = jnp.einsum("ij,bjk->bik", h, c)
        return jnp.einsum("bik,bjk->bij", g, g)

    def tfn(a, b, c):
        h = a @ b
        g = torch.einsum("ij,bjk->bik", h, c)
        return torch.einsum("bik,bjk->bij", g, g)

    text = jax.jit(jfn).lower(a, b, c).compile().as_text()
    with OpCounter() as counter:
        tfn(*(torch.empty(x.shape, device="meta") for x in (a, b, c)))
    want = jmodule_costs(text)["flops"]
    assert want > 0 and counter.flops == want


@pytest.mark.parametrize("name", ["gemma3-4b", "starcoder2-15b",
                                  "deepseek-v2-236b"])
def test_op_cost_flops_equal_hlo_cost_on_a_prefill(name):
    """No op family differs on these: every matmul, einsum and the
    unembedding count the same FLOPs in both models."""
    cfg = get_arch(name).reduced()
    jmodel = jbuild_model(JARCHS[name].reduced())
    b, s = 2, 32
    spec = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    text = jax.jit(jmodel.prefill_fn).lower(jmodel.params_spec(),
                                            spec).compile().as_text()
    model = build_model(cfg)
    with OpCounter() as counter, torch.no_grad():
        model.prefill_fn(model.params_spec(), {"tokens": torch.empty(
            (b, s), dtype=torch.int32, device="meta")})
    assert counter.flops == jmodule_costs(text)["flops"]
    assert set(counter.flops_by_op) <= {"mm", "bmm"}


def test_terms_and_dominance():
    t = analysis.RooflineTerms(
        flops=hw.PEAK_FLOPS_BF16, bytes_accessed=hw.HBM_BW * 2,
        coll_bytes=hw.NVLINK_BW * 0.5, coll_breakdown={}, coll_counts={},
        model_flops=hw.PEAK_FLOPS_BF16 * 0.5)
    assert t.t_compute == pytest.approx(1.0)
    assert t.t_memory == pytest.approx(2.0)
    assert t.t_collective == pytest.approx(0.5)
    assert t.dominant == "memory"
    assert t.bound_time == pytest.approx(2.0)
    assert t.flops_utilization == pytest.approx(0.25)
    s = t.summary()
    assert s["dominant"] == "memory"
    assert hw.bandwidth_of("NVIDIA H100 80GB HBM3") == hw.HBM_BW


def test_collective_conversion_per_device():
    """An executor on a (2, 4) mesh: an all-gather of 8 KiB per slot
    (summed 64 KiB), a reduce-scatter over the 2 data slots of 1 KiB
    blocks (summed 8 KiB), an all-reduce over the 4 model slots of 512 B
    (summed 4 KiB): per device 8 KiB, 1 KiB × 2, 512 B × 2."""
    ex = Executor(make_mesh((2, 4), ("data", "model"),
                            devices=["meta"] * 8))
    ex.count("all_gather", 8 * 8192, over=2)
    ex.count("reduce_scatter", 8 * 1024, over=2)
    ex.count("all_reduce", 8 * 512, over=4)
    ex.count("all_reduce", 8 * 512, over=1)       # one slot: no collective
    got = analysis.collective_bytes(ex.counts)
    assert got["all-gather"] == 8192
    assert got["reduce-scatter"] == 2 * 1024
    assert got["all-reduce"] == 2 * 512
    assert got["total"] == 8192 + 2048 + 1024
    counts = analysis.collective_counts(ex.counts)
    assert (counts["all-gather"], counts["reduce-scatter"],
            counts["all-reduce"]) == (1, 1, 1)


@pytest.mark.parametrize("home_fits", [True, False])
def test_fits_hbm_needs_the_home_to_fit(home_fits):
    """Two slots that fit beside a home whose whole-batch activations fit
    the card or pass it by one byte: the row fits only in the first case,
    the slot's own verdict in both."""
    home = hw.HBM_BYTES - 5 if home_fits else hw.HBM_BYTES - 4
    counter = types.SimpleNamespace(peak=collections.Counter(
        {(0, 0): 10, (0, 1): 20, HOME: home}))
    mem = analysis.memory_summary(counter, {(0, 0): 5}, [(0, 0), (0, 1)])
    assert (mem["slot"], mem["total_bytes"]) == ([0, 1], 20)
    assert mem["slot_fits_hbm"]
    assert mem["home_device"]["total_bytes"] == home + 5
    assert mem["home_device"]["fits_hbm"] is home_fits
    assert mem["fits_hbm"] is home_fits


def _meta_mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    return make_mesh(shape, axes, devices=["meta"] * int(np.prod(shape)))


def _counted(kind, cfg, mesh, repr_rows):
    """(FLOPs, bytes, collective counts, the data-index-0 slots' peak,
    the home's peak) of one step on `mesh`."""
    cell = ShapeCell(kind, 32, 8, {"serve": "decode", "accum2": "train"}
                     .get(kind, kind))
    specs = input_specs(cfg, cell)
    if cell.kind == "train":
        ts = make_train_step(cfg, mesh, repr_rows=repr_rows,
                             accum=2 if kind == "accum2" else 1)
        p = ts.model.params_spec()
        fn, ex = ts.fn, ts.executor
        args = (ts.params_sh.place(p), ts.opt_sh.place(ts.optimizer.init(p)),
                specs)
    elif kind == "prefill":
        model, p_sh, fn_for = make_prefill_step(cfg, mesh,
                                                repr_rows=repr_rows)
        fn = fn_for(specs)[0]
        ex, args = fn.executor, (p_sh.place(model.params_spec()), specs)
    else:
        model, fn, p_sh, c_sh, c_spec = make_serve_step(
            cfg, mesh, 8, 32, repr_rows=repr_rows)
        ex = fn.executor
        args = (p_sh.place(model.params_spec()), c_sh.place(c_spec),
                specs["tokens"], specs["positions"])
    with OpCounter() as c:
        fn(*args)
    per_slot = max(c.peak[(d, m)] for d in ex.lines() for m in range(ex.M))
    return (c.flops, c.bytes, {k: dict(v) for k, v in ex.counts.items()},
            per_slot, c.peak[HOME])


@pytest.mark.parametrize("kind", ["train", "accum2", "prefill", "serve"])
@pytest.mark.parametrize("shape", [(4, 2), (2, 2, 2)])
def test_representative_rows_equal_the_full_run(shape, kind):
    cfg = get_arch("starcoder2-15b").reduced()
    mesh = _meta_mesh(shape)
    full = _counted(kind, cfg, mesh, False)
    rows = _counted(kind, cfg, mesh, True)
    assert full[0] > 0 and full[1] > 0 and full[3] > 0
    assert rows == full


def test_representative_rows_refuse_real_tensors():
    with pytest.raises(ValueError, match="meta"):
        Executor(make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2),
                 repr_rows=True)


def _fake_mesh(kind):
    shape = {"pod": {"data": 16, "model": 16},
             "multipod": {"pod": 2, "data": 16, "model": 16}}[kind]
    return types.SimpleNamespace(shape=shape, axis_names=tuple(shape))


@pytest.mark.parametrize("mesh_kind", ["pod", "multipod"])
@pytest.mark.parametrize("arch", sorted(ICR_ARCHS))
def test_icr_geometry_equals_the_jax_packages(arch, mesh_kind):
    mesh = make_production_mesh(multi_pod=mesh_kind == "multipod",
                                devices=["meta"] * (512 if mesh_kind ==
                                                    "multipod" else 256))
    spec = ICR_ARCHS[arch]
    axis = 0 if spec.kind == "log1d" else 1
    dist = DistributedICR(icr=spec.build(device="meta"), mesh=mesh,
                          axis_names=mesh.axis_names, shard_axis=axis)
    fake = _fake_mesh(mesh_kind)
    jdist = JDistributedICR(icr=JICR_ARCHS[arch].build(), mesh=fake,
                            axis_names=fake.axis_names, shard_axis=axis)
    k = jdist.first_sharded_level()
    assert dist.first_sharded_level() == k
    assert dist.xi_structure() == jdist.xi_structure()
    jspecs, specs = jdist.mat_specs(), dist.mat_specs()
    for name in ("R", "sqrtD"):
        assert [tuple(s) for s in specs[name]] == \
            [tuple(s) for s in jspecs[name]]
    geo = dryrun.icr_geometry(dist)
    c = jdist.chart
    halos = [2 * (jdist.n_dev - 1) * c.b * int(np.prod(
        [n for a, n in enumerate(c.shape(lvl)) if a != axis])) * 4
        for lvl in range(k, c.n_levels)]
    assert geo["halo_bytes"] == halos
    row = dryrun.run_icr_cell(arch, mesh_kind, mesh=mesh)
    nd, fsz, csz = c.ndim, c.n_fsz ** c.ndim, c.n_csz ** c.ndim
    mf = sum(float(np.prod([c.family_count(lvl, a) for a in range(nd)]))
             * (2 * fsz * csz + 2 * fsz * fsz) for lvl in range(c.n_levels))
    assert row["status"] == "OK"
    assert row["model_flops"] == pytest.approx(mf / mesh.size, rel=1e-12)
    assert row["coll_bytes"] == pytest.approx(sum(halos) / jdist.n_dev)
    assert row["memory_per_device"]["fits_hbm"]


def _jax_all_cells():
    """The JAX dry run's ``all_cells``, read from its source (importing
    the module would force 512 host devices on this process)."""
    import repro.launch as jlaunch

    path = jlaunch.__path__[0] + "/dryrun.py"
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "all_cells")
    scope: dict = {}
    exec(compile(ast.Module([fn], []), path, "exec"), scope)
    return scope["all_cells"]()


def test_all_cells_equal_the_jax_dry_runs():
    assert dryrun.all_cells() == _jax_all_cells()


JAX_ROW_KEYS = {
    "arch", "shape", "mesh", "chips", "status", "params_total",
    "params_active", "accum", "optimizer", "lower_s", "compile_s", "flops",
    "bytes", "coll_bytes", "t_compute_s", "t_memory_s", "t_collective_s",
    "dominant", "bound_time_s", "model_flops", "useful_flops_ratio",
    "roofline_fraction", "coll_breakdown", "coll_counts",
    "memory_per_device", "raw_xla"}


def test_a_reduced_row_through_run_cell(monkeypatch):
    """``run_cell`` on a reduced gemma3-4b, a cut train cell and a (2, 4)
    mesh of ``meta`` slots: status OK, the JAX row's keys, and the roofline
    terms at the H100 constants."""
    import repro_torch.configs as configs

    small = {"gemma3-4b": get_arch("gemma3-4b").reduced()}
    monkeypatch.setattr(configs, "get_arch", small.__getitem__)
    monkeypatch.setitem(configs.SHAPES, "train_4k",
                        ShapeCell("train_4k", 32, 8, "train"))
    monkeypatch.setattr(dryrun, "_mesh_for", lambda kind: _meta_mesh((2, 4)))
    row = dryrun.run_cell("gemma3-4b:train_4k:pod")
    assert row["status"] == "OK", row
    assert JAX_ROW_KEYS <= set(row)
    assert row["repr_rows"] is True and "home_device" in row
    assert row["t_compute_s"] == pytest.approx(row["flops"]
                                               / hw.PEAK_FLOPS_BF16)
    mem = row["memory_per_device"]
    assert mem["fits_hbm"] and mem["slot_fits_hbm"]
    assert row["home_device"]["fits_hbm"]


def test_the_command_line_on_an_icr_cell():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dryrun.main(["--cell", "icr-dust122b:sample:multipod",
                          "--json-only"])
    row = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and row["status"] == "OK" and row["chips"] == 512
    assert {"flops", "bytes", "coll_bytes", "dominant",
            "memory_per_device"} <= set(row)
