"""The multi-pod dry run of the port: every (architecture × shape × mesh)
cell counted without a card.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles each cell's sharded step on 512 forced host devices and
reads the compiled module's memory and cost. The port compiles nothing:
it runs each cell's step (train, prefill or serve: ``launch/steps.py``)
once through the sharded executor on a mesh of ``meta`` slots
(``make_production_mesh(devices=["meta"] * n)``: 16x16 ``pod``, 2x16x16
``multipod``), so every tensor has its shape and dtype and nothing is
computed or allocated, under ``roofline/op_cost.py``'s counter. Each
cell gives one JSON row with the JAX row's keys: parameters, accum,
FLOPs, bytes, collective bytes and counts, the three roofline terms at
the H100 constants (``launch/mesh.py``), the dominant term, and memory
per device against the card's 80 GB (``fits_hbm`` where the fullest
slot and the home slot both fit, ``slot_fits_hbm`` for the slot alone);
besides, ``home_device`` (the home slot's memory: its blocks and what
the home owner still allocates: the loss's all-reduced statistics and
the optimizer's temporaries where its ops read no slot's tensor; every
activation lives on its line's slots, line d's on slot (d, 0), which the
counter charges) and
``repr_rows`` (the representative-row mode: line 0's slots run for all,
``Executor``). The batch is placed by the step's ``BatchShardings``
before the count, as the JAX dry run's inputs arrive placed by
``batch_sh``. ``lower_s`` is the set-up (build and placement),
``compile_s`` 0.0 (nothing is compiled), ``run_s`` the counting.

ICR cells (``icr-*:sample:*``) run nothing: ``run_icr_cell`` counts from
the geometry of ``DistributedICR`` on the mesh, per ring slot and level
(the launch plans of each slot's block, the halos as
collective-permutes, the JAX dry run's useful FLOPs). Nothing here touches
a card or forces a device count.

Run one cell:   python -m repro_torch.launch.dryrun --cell gemma3-4b:train_4k:pod
Run everything: python -m repro_torch.launch.dryrun --all --out build/dryrun
ICR cells:      python -m repro_torch.launch.dryrun --cell icr-dust122b:sample:pod
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["all_cells", "icr_geometry", "main", "run_cell", "run_icr_cell",
           "run_lm_cell", "slot_bytes"]


def _mesh_for(kind: str):
    from repro_torch.launch.mesh import make_production_mesh

    n = 512 if kind == "multipod" else 256
    return make_production_mesh(multi_pod=(kind == "multipod"),
                                devices=["meta"] * n)


def slot_bytes(placed_trees, mesh) -> dict:
    """Per slot ``(d, m)`` the bytes of its blocks of the placed trees
    (each slot counted as its own device, blocks shared on a virtual mesh
    counted for every slot holding them)."""
    from repro_torch.distributed.elastic import placed_leaves

    m_size = mesh.devices.shape[-1]
    out = collections.Counter()
    for tree in placed_trees:
        for pl in placed_leaves(tree):
            for flat, t in enumerate(pl):
                out[divmod(flat, m_size)] += t.numel() * t.element_size()
    return out


def run_lm_cell(arch: str, shape: str, mesh_kind: str, *,
                repr_rows: bool = True, mesh=None) -> dict:
    """One LM cell's row. ``mesh`` replaces the production mesh, and
    `arch` and `shape` may be an ``ArchConfig`` and a ``ShapeCell`` (tests:
    a reduced architecture on a small mesh of ``meta`` slots)."""
    import torch

    from repro_torch.configs import SHAPES, get_arch, input_specs
    from repro_torch.launch.steps import (active_param_count, choose_accum,
                                          make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models import build_model
    from repro_torch.roofline.analysis import (analyze_step,
                                               model_flops_decode,
                                               model_flops_train)

    cfg = get_arch(arch) if isinstance(arch, str) else arch
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    shape = cell.name
    mesh = mesh if mesh is not None else _mesh_for(mesh_kind)
    n_chips = mesh.size
    row = {"arch": cfg.name, "shape": shape, "mesh": mesh_kind,
           "chips": n_chips, "status": "?", "repr_rows": repr_rows}
    if shape not in cfg.shape_cells:
        row.update(status="SKIP", reason=cfg.notes)
        return row
    model = build_model(cfg)
    n_active = active_param_count(model)
    row["params_total"] = model.param_count()
    row["params_active"] = n_active
    t0 = time.time()
    specs = input_specs(cfg, cell)
    enc = cfg.encoder
    tokens = cell.global_batch * (min(cell.seq_len, enc.max_target)
                                  if enc else cell.seq_len)
    if cell.kind == "train":
        accum = choose_accum(model, cell, mesh)
        ts = make_train_step(cfg, mesh, accum=accum, repr_rows=repr_rows)
        row["accum"] = accum
        row["optimizer"] = ts.opt_name
        p_meta = ts.model.params_spec()
        params = ts.params_sh.place(p_meta)
        opt_state = ts.opt_sh.place(ts.optimizer.init(p_meta))
        # each slot also holds a gradient block per parameter block
        # (float32 sums under accumulation)
        grad_of = slot_bytes([params], mesh)
        static = slot_bytes([params, opt_state], mesh)
        for k, v in grad_of.items():
            static[k] += v * (2 if accum > 1 and cfg.param_dtype ==
                              "bfloat16" else 1)
        batch = ts.batch_shardings(specs).place(specs)
        fn, args, ex = ts.fn, (params, opt_state, batch), ts.executor
        mf = model_flops_train(n_active, tokens) / n_chips
    elif cell.kind == "prefill":
        model, params_sh, fn_for = make_prefill_step(cfg, mesh,
                                                     repr_rows=repr_rows)
        params = params_sh.place(model.params_spec())
        fn, batch_sh = fn_for(specs)
        static = slot_bytes([params], mesh)
        args, ex = (params, batch_sh.place(specs)), fn.executor
        mf = model_flops_decode(n_active, tokens) / n_chips
    else:
        s_max = min(cell.seq_len, enc.max_target) if enc else cell.seq_len
        model, fn, params_sh, cache_sh, c_spec = make_serve_step(
            cfg, mesh, cell.global_batch, s_max, repr_rows=repr_rows)
        params = params_sh.place(model.params_spec())
        cache = cache_sh.place(c_spec)
        static = slot_bytes([params, cache], mesh)
        batch = fn.batch_sh.place({k: specs[k] for k in ("tokens",
                                                         "positions")})
        args = (params, cache, batch["tokens"], batch["positions"])
        ex = fn.executor
        mf = model_flops_decode(n_active, cell.global_batch) / n_chips
    row["lower_s"] = round(time.time() - t0, 1)
    row["compile_s"] = 0.0
    t1 = time.time()
    slots = [(d, m) for d in ex.lines() for m in range(ex.M)]
    grad = contextlib.nullcontext() if cell.kind == "train" \
        else torch.no_grad()
    with grad:
        terms, _, counter = analyze_step(
            fn, *args, model_flops_per_device=mf, executor=ex,
            static=static, slots=slots, devices=n_chips)
    row["run_s"] = round(time.time() - t1, 1)
    row["ops"] = counter.ops
    summary = terms.summary()
    row["home_device"] = summary["memory_per_device"].pop("home_device")
    row.update(status="OK", **summary)
    return row


def icr_geometry(dist, samples: int = 1, dtype=None,
                 devices: int | None = None) -> dict:
    """What ``DistributedICR.apply_sqrt_batch`` runs on its ring, from the
    geometry alone: ``first_sharded_level``; per kernel its ``launches``
    (the replicated prologue once per distinct device of the ring, then
    one per ring slot and level) and their plans; ``halo_bytes`` per
    sharded level (a collective-permute); per slot the plans' ``bytes``,
    the useful ``flops`` (the JAX dry run's refinement einsums, a slot's
    families of a sharded level) and ``memory`` (its blocks of the
    matrices, its ξ block and the two largest fields it holds).
    ``devices``: the ring's distinct devices (default: one per slot)."""
    import torch

    from repro_torch.core.refine import LevelGeom
    from repro_torch.kernels import dispatch

    c = dist.chart
    n = dist.n_dev
    devices = n if devices is None else devices
    itemsize = 2 if dtype == torch.bfloat16 else 4
    k = dist.first_sharded_level()
    nd, fsz, csz = c.ndim, c.n_fsz ** c.ndim, c.n_csz ** c.ndim
    launches = collections.Counter()
    plans, slot_plans = [], []
    flops = 0.0
    mats = float(np.prod(c.shape0)) ** 2 * 4          # sqrt0, replicated
    fields = []
    halo = []
    for lvl in range(c.n_levels):
        sharded = lvl >= k
        geom = (dist._local_geom(lvl, sharded=True) if sharded
                else LevelGeom.for_level(c, lvl))
        fwd = dispatch.level_launch_plans(c, lvl, samples=samples,
                                          dtype=dtype, geom=geom)["forward"]
        times = n if sharded else devices
        for p in fwd:
            launches[p.kernel] += times
        plans += fwd * times
        slot_plans += fwd
        fam = float(np.prod(geom.T))
        flops += fam * (2 * fsz * csz + 2 * fsz * fsz) * samples
        kept = float(np.prod(geom.kept_T))
        mats += kept * (fsz * csz + fsz * fsz) * 4
        fields.append(float(np.prod(geom.fine_shape)) * samples * itemsize)
        if sharded:
            halo.append(dist.halo_bytes(lvl, samples, itemsize))
    xi = sum(float(np.prod(s)) for s in dist.xi_structure()[:k + 1])
    xi += sum(float(np.prod(s)) / n for s in dist.xi_structure()[k + 1:])
    two = sorted(fields)[-2:]
    return {"first_sharded_level": k, "launches": dict(launches),
            "plans": plans, "slot_plans": slot_plans, "halo_bytes": halo,
            "flops": flops,
            "bytes": float(sum(p.hbm_bytes() for p in slot_plans)),
            "memory": mats + xi * samples * itemsize + sum(two)}


def run_icr_cell(arch: str, mesh_kind: str, *, mesh=None) -> dict:
    """One ICR cell's row, counted from the geometry (``icr_geometry``):
    per device its launch plans' bytes, its useful FLOPs and halos, and
    the memory of its matrices, ξ block and two largest fields."""
    from repro_torch.configs.registry import ICR_ARCHS
    from repro_torch.core.distributed import DistributedICR
    from repro_torch.launch.mesh import HBM_BYTES
    from repro_torch.roofline.analysis import RooflineTerms
    from repro_torch.roofline.op_cost import module_costs, OpCounter

    spec = ICR_ARCHS[arch]
    mesh = mesh if mesh is not None else _mesh_for(mesh_kind)
    n_chips = mesh.size
    axes = tuple(mesh.axis_names)
    row = {"arch": arch, "shape": "sample", "mesh": mesh_kind,
           "chips": n_chips, "status": "?", "repr_rows": False}
    t0 = time.time()
    icr = spec.build(device="meta")
    dist = DistributedICR(icr=icr, mesh=mesh, axis_names=axes,
                          shard_axis=0 if spec.kind == "log1d" else 1)
    row["points"] = int(np.prod(icr.chart.final_shape))
    geo = icr_geometry(dist)
    row["lower_s"] = round(time.time() - t0, 1)
    row["compile_s"] = 0.0
    row["first_sharded_level"] = geo["first_sharded_level"]
    row["launches"] = geo["launches"]
    # the JAX dry run's useful flops: Σ_l F_l (2·fsz·csz + 2·fsz²), global
    c = icr.chart
    nd, fsz, csz = c.ndim, c.n_fsz ** c.ndim, c.n_csz ** c.ndim
    mf = sum(float(np.prod([c.family_count(lvl, a) for a in range(nd)]))
             * (2 * fsz * csz + 2 * fsz * fsz) for lvl in range(c.n_levels))
    halo = float(sum(geo["halo_bytes"])) / dist.n_dev
    costs = module_costs(OpCounter(), None, geo["slot_plans"])
    mem = {"argument_bytes": int(geo["memory"]), "temp_bytes": 0,
           "total_bytes": int(geo["memory"])}
    mem["fits_hbm"] = mem["slot_fits_hbm"] = mem["total_bytes"] <= HBM_BYTES
    terms = RooflineTerms(
        flops=geo["flops"], bytes_accessed=geo["bytes"], coll_bytes=halo,
        coll_breakdown={"collective-permute": halo, "total": halo},
        coll_counts={"collective-permute": 2 * len(geo["halo_bytes"])},
        memory_per_device=mem, model_flops=mf / n_chips)
    row.update(status="OK", **terms.summary())
    row["custom_calls"] = costs["custom_calls"]
    return row


def run_cell(cell_id: str, *, repr_rows: bool = True) -> dict:
    arch, shape, mesh_kind = cell_id.split(":")
    try:
        if arch.startswith("icr-"):
            return run_icr_cell(arch, mesh_kind)
        return run_lm_cell(arch, shape, mesh_kind, repr_rows=repr_rows)
    except Exception as exc:  # noqa: BLE001
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "FAIL", "error": f"{type(exc).__name__}: {exc}",
                "traceback": traceback.format_exc()[-2000:]}


def all_cells():
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.configs.registry import ICR_ARCHS

    cells = []
    for arch in sorted(ARCHS):
        for shape in SHAPES:
            for mesh_kind in ("pod", "multipod"):
                cells.append(f"{arch}:{shape}:{mesh_kind}")
    for arch in sorted(ICR_ARCHS):
        for mesh_kind in ("pod", "multipod"):
            cells.append(f"{arch}:sample:{mesh_kind}")
    return cells


def _run_in_subprocess(cell_id: str, timeout: int = 3600,
                       full: bool = False) -> dict:
    """Each cell in a fresh process: one pathological cell cannot take the
    sweep down, and its memory is returned when it ends."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell",
           cell_id, "--json-only"] + (["--full"] if full else [])
    env = dict(os.environ)
    env.setdefault("PYTHONPATH", "src")
    env.setdefault("OMP_NUM_THREADS", "1")
    arch, shape, mesh_kind = cell_id.split(":")
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=timeout, env=env)
        for line in reversed(out.stdout.strip().splitlines()):
            if line.startswith("{"):
                return json.loads(line)
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "FAIL",
                "error": (out.stderr or out.stdout)[-1500:]}
    except subprocess.TimeoutExpired:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "TIMEOUT"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", help="arch:shape:mesh — run one cell in-proc")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--arch", help="run all shapes/meshes for one arch")
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--json-only", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="every data index's slots run (no "
                         "representative-row mode)")
    args = ap.parse_args(argv)

    if args.cell:
        row = run_cell(args.cell, repr_rows=not args.full)
        if args.json_only:
            print(json.dumps(row))
        else:
            print(json.dumps(row, indent=2))
        return 0 if row["status"] in ("OK", "SKIP") else 1

    cells = all_cells()
    if args.arch:
        cells = [c for c in cells if c.startswith(args.arch + ":")]
    elif not args.all:
        ap.error("give --cell, --arch or --all")
    os.makedirs(args.out, exist_ok=True)
    results = []
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        for row in pool.map(lambda c: _run_in_subprocess(c, full=args.full),
                            cells):
            results.append(row)
            tag = f"{row['arch']}:{row.get('shape')}:{row['mesh']}"
            print(f"[{len(results)}/{len(cells)}] {tag}: {row['status']} "
                  f"dom={row.get('dominant', '-')} "
                  f"frac={row.get('roofline_fraction', 0):.3f}",
                  flush=True)
            with open(os.path.join(args.out, "dryrun.json"), "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    print(f"done: {n_ok} OK, {n_skip} SKIP, "
          f"{len(results) - n_ok - n_skip} FAIL")
    return 0 if n_ok + n_skip == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
