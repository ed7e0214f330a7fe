"""The port's static-analysis layer (``repro_torch.analysis``), on the CPU.

Clean verdicts of verify, lint and shardcheck on the quick serving
scenarios; each pass flagging its own seeded fault; the port's
``plan_signature`` routes against the JAX package's (the divergences
``ROADMAP.md`` records, named); ``lowered_slab`` and the fingerprints
against ``tests/golden_torch/``; the profiler parser on a CPU trace.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import charts as jcharts
from repro.kernels import dispatch as jdispatch
from repro_torch.analysis import fingerprint, kernel_verify, lint, mesh_verify
from repro_torch.analysis.diff import diff_docs
from repro_torch.analysis.scenarios import SCENARIOS, Scenario
from repro_torch.core import charts as tcharts
from repro_torch.kernels import dispatch, icr_refine, launch, nd_fused
from repro_torch.launch import serve_gp
from repro_torch.roofline import analysis as roof

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

CELLS = [s for s in SCENARIOS(quick=True)]


@pytest.mark.parametrize("scn", CELLS, ids=[s.label for s in CELLS])
def test_clean_verdicts_of_verify_and_lint(scn):
    assert kernel_verify.verify_scenario(scn) == []
    assert lint.lint_scenario(scn) == []


@pytest.mark.parametrize("name", ["tod", "image", "dust"])
def test_clean_verdict_of_shardcheck(name):
    assert mesh_verify.shardcheck_scenario(name) == []


# -- seeded faults: each pass flags its own ------------------------------------------
def _plan():
    """A stationary forward plan of 3 rows of 40 families with a partial
    last run (40 = 10 runs of 4)."""
    return icr_refine.refine_1d_plan(batch=3, t=40, coarse_len=42, n_fsz=2,
                                     n_csz=3, charted=False)


def _with_maps(plan, edit):
    """``plan`` whose ownership maps pass through ``edit(group)``."""
    def maps():
        return (edit(plan.ownership()[0]),)
    return dataclasses.replace(plan, ownership=maps)


def _edited(boxes, unit, *, lo=None, hi=None):
    b = launch.Boxes(boxes.lo.copy(), boxes.hi.copy())
    if lo is not None:
        b.lo[unit] += lo
    if hi is not None:
        b.hi[unit] += hi
    return b


def _writes(grp, name, **kw):
    return dataclasses.replace(grp, writes={
        **grp.writes, name: _edited(grp.writes[name], 1, **kw)})


def _reads(grp, name, **kw):
    return dataclasses.replace(grp, reads={
        **grp.reads, name: _edited(grp.reads[name], 1, **kw)})


FAULTS = {
    # unit 1 writes one family less: a gap
    "gap": (lambda g: _writes(g, "out", hi=np.array([0, -2])), "coverage"),
    # unit 1 also writes unit 2's first family: a double write
    "double-write": (lambda g: _writes(g, "out", hi=np.array([0, 2])),
                     "coverage"),
    # unit 1 reads past the end of the coarse row
    "out-of-bounds-read": (lambda g: _reads(g, "coarse",
                                            hi=np.array([0, 40])), "bounds"),
    # unit 1's coarse window one short of its families' windows
    "halo-short-by-one": (lambda g: _reads(g, "coarse",
                                           hi=np.array([0, -1])), "halo"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_pass_flags_its_seeded_fault(fault):
    edit, pass_name = FAULTS[fault]
    assert kernel_verify.verify_plan(_plan()) == []
    found = kernel_verify.verify_plan(_with_maps(_plan(), edit))
    assert found and {f.pass_name for f in found} == {pass_name}, found


def test_bytes_pass_flags_shared_memory_over_budget():
    chart = serve_gp.scenario_chart("dust", quick=True)
    plan = dispatch.level_launch_plans(chart, 1)["forward"][0]
    assert plan.kernel == "refine_nd_fused" and plan.smem == plan.smem_budget
    assert kernel_verify.check_bytes(plan) == []
    over = dataclasses.replace(plan, smem=plan.smem + 16)
    assert "budgeted" in kernel_verify.check_bytes(over)[0].message
    huge = dataclasses.replace(plan, smem=300 * 1024, smem_budget=None)
    assert "exceed" in kernel_verify.check_bytes(huge)[0].message
    assert lint.lint_plan(huge)


def test_transpose_pass_flags_a_perturbed_adjoint():
    chart = serve_gp.scenario_chart("tod", quick=True)
    grp = dispatch.chart_launch_plans(chart, samples=2, pyramid=False)[1]
    gen = torch.Generator().manual_seed(0)
    pairs = kernel_verify.transpose_pairs(chart, grp, samples=2,
                                          dtype=torch.float64, device="cpu",
                                          gen=gen)
    label, fwd, adj, xs, y = pairs[0]
    rtol = kernel_verify.TRANSPOSE_RTOL[torch.float64]
    assert kernel_verify.check_transpose_pair(fwd, adj, xs, y,
                                              rtol=rtol) == []

    def perturbed(g):
        dc, dxi = adj(g)
        return dc, dxi * (1 + 1e-6)

    found = kernel_verify.check_transpose_pair(fwd, perturbed, xs, y,
                                               rtol=rtol)
    assert [f.pass_name for f in found] == ["transpose"]


def test_hygiene_flags_a_level_routed_to_a_plain_version():
    chart = serve_gp.scenario_chart("image", quick=True)
    groups = dispatch.chart_launch_plans(chart, samples=2)
    assert kernel_verify.check_routes(groups) == []
    groups[1] = {**groups[1], "route": "plain", "forward": [], "vjp": []}
    found = kernel_verify.check_routes(groups)
    assert [f.pass_name for f in found] == ["hygiene"]
    plan = groups[0]["forward"][0]
    assert kernel_verify.check_hygiene(plan) == []
    op = plan.operands[0]
    mixed = dataclasses.replace(plan, operands=(dataclasses.replace(
        op, dtype="bfloat16"),) + plan.operands[1:])
    assert [f.pass_name for f in kernel_verify.check_hygiene(mixed)] == [
        "hygiene"]


def test_cachekey_audit_flags_a_field_left_out(monkeypatch):
    assert mesh_verify.cachekey_audit("tod") == []
    keyed = serve_gp.GPFieldServer._cache_key

    def without_jitter(self, post):
        key = list(keyed(self, post))
        key[2] = None      # (chart, kernel, jitter, ...): jitter left out
        return tuple(key)

    monkeypatch.setattr(serve_gp.GPFieldServer, "_cache_key",
                        without_jitter)
    found = mesh_verify.cachekey_audit("tod")
    assert [f.location for f in found] == ["variant[jitter]"], found


# -- parity with the JAX package ----------------------------------------------------
PARITY_CHARTS = {
    "tod": lambda m: m.regular_chart(64, 3, boundary="reflect"),
    "image": lambda m: m.regular_chart((16, 16), 2, boundary="reflect"),
    "dust": lambda m: m.galactic_dust_chart((6, 8, 8), n_levels=2),
    "log": lambda m: m.log_chart(64, 3, n_csz=5, n_fsz=4, delta0=0.01),
    "log_polar": lambda m: m.log_polar_chart((8, 8), 2),
}
# the port's pyramid covers 1-D stationary levels only (ROADMAP.md,
# deliberate divergences: "the pyramid cover") and its backward runs the
# per-level adjoint kernels where the JAX package replays its reference
PYRAMID_COVER = "pyramid cover: 1-D stationary levels only"
PYRAMID_VJP = {"pyramid-ref": "pyramid-adjoint"}


@pytest.mark.parametrize("pyramid", [False, True], ids=["levels", "pyramid"])
@pytest.mark.parametrize("name", sorted(PARITY_CHARTS))
def test_plan_signature_routes_match_the_jax_package(name, pyramid):
    jc, tc = PARITY_CHARTS[name](jcharts), PARITY_CHARTS[name](tcharts)
    want = jdispatch.plan_signature(jc, samples=4, platform="tpu",
                                    pyramid=pyramid)
    got = dispatch.plan_signature(tc, samples=4, pyramid=pyramid)
    assert [e["level"] for e in got] == [e["level"] for e in want]
    for g, w in zip(got, want):
        if w["route"] == "pyramid" and g["route"] != "pyramid":
            # PYRAMID_COVER: the port runs such a level on its own route
            assert g["route"] != "stationary-1d", PYRAMID_COVER
            continue
        assert g["route"] == w["route"]
        assert g["vjp_route"] == PYRAMID_VJP.get(w["vjp"]["route"],
                                                 w["vjp"]["route"])


@pytest.mark.parametrize("name", sorted(PARITY_CHARTS))
def test_each_plan_writes_its_outputs_size(name):
    chart = PARITY_CHARTS[name](tcharts)
    for grp in dispatch.chart_launch_plans(chart, samples=3):
        for p in grp["forward"] + grp["vjp"]:
            for (label, out), (written, size) in \
                    kernel_verify.written_elements(p).items():
                assert written == size, (grp["level"], p.kernel, label, out)


def test_wrapper_plans_are_the_exported_plans():
    """The plan a wrapper builds from its operands' shapes is the record
    ``level_launch_plans`` rebuilds from the geometry."""
    chart = serve_gp.scenario_chart("dust", quick=True)
    geom = dispatch.LevelGeom.for_level(chart, 1)
    padded = tuple(n + 2 * geom.b for n in geom.coarse_shape)
    fwd = nd_fused.nd_fused_plan(samples=4, field_shape=padded,
                                 T=tuple(geom.T), n_fsz=geom.n_fsz,
                                 n_csz=geom.n_csz,
                                 charted=(True, False, False))
    assert fwd == dispatch.level_launch_plans(chart, 1, samples=4)[
        "forward"][0]
    with pytest.raises(ValueError, match="expected cuda"):
        launch.run_plan(fwd, {"field": torch.zeros((4,) + padded)})


def test_plans_follow_the_tuning_tables(monkeypatch):
    """A plan is cached per geometry, not per argument list: when the
    charted kernels aim for fewer threads (a thread then takes several
    rows), the 1-D plan and the pyramid's take the new geometry, as the
    launch table does."""
    from repro_torch.kernels import pyramid

    def plans():
        p = icr_refine.refine_1d_plan(batch=16, t=64, coarse_len=132,
                                      n_fsz=2, n_csz=3, charted=True)
        chart = tcharts.log_chart(64, 3, n_csz=5, n_fsz=4, delta0=0.01)
        geoms = [dispatch.LevelGeom.for_level(chart, lvl) for lvl in range(3)]
        q = pyramid.pyramid_plan(samples=16, geoms=geoms,
                                 charted=[(True,)] * 3)
        return p, q

    p0, q0 = plans()
    monkeypatch.setattr(icr_refine, "CHARTED_THREADS", 8)
    p1, q1 = plans()
    assert p1.instance["rows"] == icr_refine.charted_shape_1d(
        16, 64, 2, 3, 4)[1] == 8 != p0.instance["rows"]
    assert q1.instance["tiles"] != q0.instance["tiles"]
    assert kernel_verify.verify_plan(p1) == kernel_verify.verify_plan(q1) \
        == []


# -- lowered_slab and the fingerprints ------------------------------------------------
def test_lowered_slab_on_the_cpu():
    chart = serve_gp.scenario_chart("tod", quick=True)
    srv = serve_gp.GPFieldServer(
        serve_gp.demo_posterior(chart, 8.0, device="cpu"), slab=4)
    low = srv.lowered_slab()
    assert low["graph"] is None and low["mode"] == "single:cpu-eager"
    assert [e["route"] for e in low["plan"]] == ["pyramid"] * 3
    assert [p["kernel"] for p in low["launches"]] == ["refine_pyramid"]
    assert low["plan"] == dispatch.plan_signature(chart, samples=4)


@pytest.mark.parametrize("scn", CELLS, ids=[s.label for s in CELLS])
def test_fingerprint_round_trips_against_its_golden(scn):
    doc = json.loads(fingerprint.canonical_json(
        fingerprint.fingerprint_scenario(scn)))
    golden = json.loads(fingerprint.golden_path(scn.label).read_text())
    assert diff_docs(golden, doc) == []
    moved = json.loads(json.dumps(doc))
    moved["plan_signature"][0]["route"] = "charted-1d"
    assert [p for p, *_ in diff_docs(golden, moved)] == [
        "plan_signature[0].route"]


# -- the profiler roofline -------------------------------------------------------------
def test_the_trace_parser_on_a_cpu_trace():
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    events = roof.profile(lambda: torch.mm(a, b).relu(), calls=3, cuda=False)
    att = roof.attribute(events, device_cats=("cpu_op",))
    assert att["kernels"] == {}
    assert "aten::mm" in att["other"] and att["device_ms"] > 0
    # the port's kernels by symbol, mangled or demangled, beside other work
    plan = _plan()
    fake = [
        {"name": "_ZN5repro27refine_1d_stationary_kernelIfLb1ELi2ELi3ELi4E"
                 "EEvPKT_S3_S3_S3_PS1_iiiiii", "cat": "kernel", "dur": 4.0},
        {"name": "void repro::refine_1d_charted_adj_kernel<__nv_bfloat16, "
                 "false, 4, 5, 1>(...)", "cat": "kernel", "dur": 2.0},
        {"name": "void at::native::elementwise_kernel<128, 2>(int, F)",
         "cat": "kernel", "dur": 1.0},
        {"name": "aten::mm", "cat": "cpu_op", "dur": 9.0},
    ]
    att = roof.attribute(fake)
    assert att["kernels"] == {
        "refine_stationary": {"ms": 4e-3, "events": 1},
        "refine_charted_adjoint_nn": {"ms": 2e-3, "events": 1}}
    assert att["other"] == {"at::native::elementwise_kernel": 1e-3}
    r = roof.roofline(att, [plan], calls=2)
    row = r["kernels"]["refine_stationary"]
    assert row["ms"] == pytest.approx(2e-3) and row["launches"] == 1
    assert row["bound_ms"] == pytest.approx(plan.hbm_bytes() / 3.35e9)
    assert r["device_ms"] == pytest.approx(3.5e-3)
    assert r["other"] == {"at::native::elementwise_kernel":
                          pytest.approx(5e-4)}


def test_scenario_labels():
    assert [s.label for s in CELLS] == [
        "tod-fp32", "tod-bf16", "image-fp32", "image-bf16", "dust-fp32",
        "dust-bf16"]
    assert Scenario("dust", "bf16", quick=False).label == "dust-bf16-full"
