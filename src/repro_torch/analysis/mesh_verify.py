"""Mesh soundness of the port's sharded paths, and its cache keys.

The counterpart of the JAX package's ``analysis/mesh_verify.py``. The
port has no ``shard_map`` and no jaxpr to walk: one process drives a
mesh of slots (``launch/mesh.py``), so its passes are proofs over the
slots' geometry and probes of the caches:

* **halo** (:func:`halo_proof`) — for every slot and sharded level of
  ``DistributedICR``, the slot's block plus its ring halos (as
  ``_halo_exchange`` builds them: ``b`` entries from each neighbour, the
  reflected edge at the ring's ends) contain every window its families
  read, in global coordinates; the halos are single-hop (a block of at
  least ``b + 1``); the local geometry (``_local_geom``) is the block's;
  and the slots' fine blocks and the transition's coarse blocks tile
  their axes exactly once;
* **placement** (:func:`samples_placement`) — in samples mode each of a
  step's rows goes to exactly one slot, and ``local_rows == slab`` holds
  at three or more mesh sizes (the counterpart of ``check_remesh``);
* **cache keys** (:func:`cachekey_audit`, :func:`plan_key_audit`) — one
  field perturbed at a time (chart, kernel defaults, jitter, θ, policy,
  ``use_pallas``, ``use_pyramid``, device, slab, mesh):
  ``GPFieldServer._cache_key`` changes exactly when the slab's
  fingerprint (everything that reaches the slab executable but the
  q-parameters) changes, and the seed control (new q-parameters) keeps
  both; ``dispatch.plan_cached`` misses whenever the plan differs.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.launch import Boxes

from . import Finding
from .kernel_verify import coverage_counts

__all__ = ["halo_proof", "samples_placement", "slab_fingerprint",
           "cachekey_audit", "plan_key_audit", "shardcheck_scenario",
           "shardcheck_all", "CPU_MESH_SIZES"]

CPU_MESH_SIZES = (8, 4, 2)


def _tiles_once(lo, hi, n) -> bool:
    counts = coverage_counts(Boxes(np.asarray(lo)[:, None],
                                   np.asarray(hi)[:, None]), (n,))
    return bool((counts == 1).all())


def halo_proof(dist, *, scenario: str = "") -> list:
    """The halo pass over a ``DistributedICR`` (see the module
    docstring)."""
    c = dist.chart
    n, ax, b = dist.n_dev, dist.shard_axis, c.b
    s, csz, fsz = c.n_fsz // 2, c.n_csz, c.n_fsz
    k = dist.first_sharded_level()
    findings = []

    def find(where, msg):
        findings.append(Finding("mesh", scenario, where, msg))

    slots = np.arange(n)
    big = c.shape(k)[ax]
    if big % n or not _tiles_once(slots * (big // n), (slots + 1) *
                                  (big // n), big):
        find(f"level {k}", f"the transition's blocks of {big} over {n} "
                           "slots do not tile the axis")
    for lvl in range(k, c.n_levels):
        where = f"level {lvl}"
        N = c.shape(lvl)[ax]
        T = c.family_count(lvl, ax)
        blk, t_loc = N // n, T // n
        geom = dist._local_geom(lvl, sharded=True)
        if N % n or T % n:
            find(where, f"{N} entries / {T} families do not split over "
                        f"{n} slots")
            continue
        if blk < b + 1:
            find(where, f"a block of {blk} is shorter than the halo "
                        f"{b} + 1: the halos are not single-hop")
        if geom.coarse_shape[ax] != blk + 2 * b or geom.T[ax] != t_loc:
            find(where, f"the local geometry {geom.coarse_shape} / "
                        f"{geom.T} is not the block {blk} + 2·{b} with "
                        f"{t_loc} families")
        # global coordinates of slot i's padded block and of the windows
        # of its families t = i·t_loc + j, j < t_loc: [t·s - b, +C)
        have_lo, have_hi = slots * blk - b, (slots + 1) * blk + b
        need_lo = slots * t_loc * s - b
        need_hi = ((slots + 1) * t_loc - 1) * s - b + csz
        local_hi = (t_loc - 1) * s + csz
        if local_hi > blk + 2 * b:
            find(where, f"a slot's last window ends at {local_hi}, past "
                        f"its padded block of {blk + 2 * b}")
        short = (have_lo > need_lo) | (have_hi < need_hi)
        if short.any():
            i = int(np.flatnonzero(short)[0])
            find(where, f"slot {i}'s block and halos [{have_lo[i]}, "
                        f"{have_hi[i]}) miss its windows [{need_lo[i]}, "
                        f"{need_hi[i]})")
        # the slot's local window j starts at j·s of its padded block,
        # global i·blk - b + j·s: the global window of family i·t_loc + j
        if blk != t_loc * s:
            find(where, f"a block of {blk} entries holds {t_loc} families "
                        f"of stride {s}: local windows are not the global "
                        "ones")
        # the ends reflect locally: the reflected b entries exist
        if b and blk <= b:
            find(where, f"the edge slots reflect {b} of {blk} entries")
        if not _tiles_once(slots * t_loc * fsz, (slots + 1) * t_loc * fsz,
                           T * fsz):
            find(where, "the slots' fine blocks do not tile the axis")
    return findings


def samples_placement(make_server, sizes=CPU_MESH_SIZES, *,
                      scenario: str = "") -> list:
    """Samples mode at each mesh size: ``local_rows == slab``, one slab
    graph (or eager callable) per slot, and each of a full step's rows in
    exactly one slot's meta. ``make_server(k)`` builds a samples-mode
    server over a mesh of ``k`` slots."""
    from repro_torch.launch.serve_gp import _PAD_ROW, GPRequest

    findings = []
    if len(sizes) < 3:
        findings.append(Finding("mesh", scenario, "placement",
                                f"{len(sizes)} mesh sizes: three are needed"))
    for k in sizes:
        srv = make_server(k)
        entry = srv._entry
        where = f"mesh {k}"
        if entry["local_rows"] != srv.slab or srv.capacity != k * srv.slab:
            findings.append(Finding(
                "mesh", scenario, where,
                f"local_rows {entry['local_rows']} / capacity "
                f"{srv.capacity} for slab {srv.slab} on {k} slots"))
        if len(entry.get("slots", ())) != k:
            findings.append(Finding("mesh", scenario, where,
                                    f"{len(entry.get('slots', ()))} slot "
                                    f"executables for {k} slots"))
            continue
        req = GPRequest(kind="sample", n=srv.capacity, seed=7)
        rows = [(req, r) for r in range(srv.capacity)]
        metas = srv._slab_args(entry, rows)
        seen = np.concatenate([m[1].numpy() for m in metas])
        seen = seen[seen != _PAD_ROW]
        if sorted(seen.tolist()) != list(range(srv.capacity)):
            findings.append(Finding(
                "mesh", scenario, where,
                "a step's rows are not each on exactly one slot"))
    return findings


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True, default=str)
                          .encode()).hexdigest()[:16]


def _tensor_digest(tree) -> str:
    h = hashlib.sha256()
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for t in leaves:
        a = t.detach().to("cpu", torch.float32).contiguous().numpy()
        h.update(f"{t.shape}:{t.dtype}:{t.device.type}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def slab_fingerprint(srv) -> dict:
    """Per-component digests of everything that reaches the active slab
    executable but the q-parameters (they ride in its buffers by design:
    swapping them is what the cache is for): the matrices, the ICR's
    routing flags and storage dtype that the slab function closes over,
    the buffers' shapes, dtypes and devices, the slab's launches and the
    slots."""
    e = srv._entry
    icr = srv.posterior.icr
    holders = e["slots"] if "slots" in e else [e]
    bufs = [{k: (tuple(v.shape), str(v.dtype), str(v.device))
             for k, v in h["bufs"].items()} for h in holders]
    low = srv.lowered_slab()
    return {
        "mats": _tensor_digest([h["mats"] for h in holders]),
        "closure": _digest([icr.use_pallas, icr.use_pyramid,
                            str(icr.policy.storage_dtype)]),
        "buffers": _digest(bufs),
        "launches": _digest([low["plan"], low["launches"]]),
        "slots": _digest(None if srv.mesh is None else
                         [srv.shard] + [(sl.id, str(sl.device))
                                        for sl in srv.mesh.slots]),
    }


def _server(name: str, *, quick: bool = True, slab: int = 4, rho=None,
            policy=None, seed: int = 0, jitter=None, theta=None,
            use_pallas: bool = True, use_pyramid: bool = True,
            device="cpu", mesh=None, chart=None):
    from repro_torch.core import ICR, matern32
    from repro_torch.core.vi import Posterior
    from repro_torch.launch import serve_gp

    chart = chart or serve_gp.scenario_chart(name, quick=quick)
    rho = serve_gp.SCENARIOS[name] if rho is None else rho
    kw = {} if jitter is None else {"jitter": jitter}
    icr = ICR(chart, matern32.with_defaults(rho=rho), use_pallas=use_pallas,
              use_pyramid=use_pyramid, dtype_policy=policy, device=device,
              **kw)
    gen = torch.Generator(device=device).manual_seed(seed)
    mean = icr.init_xi(gen, dtype=torch.float32)
    post = Posterior(icr=icr, mean=mean,
                     log_std=[torch.full_like(m, -1.5) for m in mean],
                     theta=theta)
    return serve_gp.GPFieldServer(post, slab=slab, mesh=mesh)


def cachekey_audit(name: str = "tod", *, quick: bool = True, slab: int = 4,
                   devices=("cpu",), make_server=None,
                   scenario: str = "") -> list:
    """One field perturbed at a time: the cache key changes exactly when
    the slab's fingerprint does; the seed control keeps both.
    ``devices``: the devices to serve on (a second one adds the device
    variant); ``make_server`` replaces the server factory (tests)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve_gp import SCENARIOS, scenario_chart

    make = make_server or _server
    rho = SCENARIOS[name]
    dev = devices[0]
    other = scenario_chart("image" if name != "image" else "tod",
                           quick=True)
    variants = {
        "base": {},
        "seed": {"seed": 1},
        "chart": {"chart": other},
        "kernel": {"rho": 2.0 * rho},
        "jitter": {"jitter": 1e-4},
        "theta": {"theta": {"rho": 3.0 * rho}},
        "policy": {"policy": "bf16"},
        "use_pallas": {"use_pallas": False},
        "use_pyramid": {"use_pyramid": False},
        "slab": {"slab": slab + 4},
        "mesh": {"mesh": make_mesh((2,), ("data",),
                                   devices=[torch.device(dev)] * 2)},
    }
    if len(devices) > 1:
        variants["device"] = {"device": devices[1]}
    base = make(name, quick=quick, slab=slab, device=dev)
    key0 = base._cache_key(base.posterior)
    fp0 = slab_fingerprint(base)
    findings = []
    for label, kw in variants.items():
        if label == "base":
            continue
        kw = {"device": dev, "slab": slab, **kw}
        srv = make(name, quick=quick, **kw)
        key_moved = srv._cache_key(srv.posterior) != key0
        fp = slab_fingerprint(srv)
        moved = sorted(k for k in fp if fp[k] != fp0[k])
        where = f"variant[{label}]"
        if label == "seed":
            if key_moved or moved:
                findings.append(Finding(
                    "cachekey", scenario, where,
                    f"new q-parameters changed the key ({key_moved}) or "
                    f"the slab's fingerprint ({moved}): the control must "
                    "collide"))
        elif moved and not key_moved:
            findings.append(Finding(
                "cachekey", scenario, where,
                f"{label} changes the slab ({moved}) but not _cache_key: "
                "an unkeyed input (stale cache on a re-fit or re-mesh)"))
        elif key_moved and not moved:
            findings.append(Finding(
                "cachekey", scenario, where,
                f"{label} changes _cache_key but not the slab: a miss "
                "with nothing to rebuild"))
    return findings


def plan_key_audit(name: str = "tod", *, quick: bool = True,
                   scenario: str = "") -> list:
    """``dispatch.plan_cached`` misses for every keyword that changes the
    plan (chart, samples, dtype, pyramid) and for the device type and
    the mesh key (deliberate misses: a re-mesh re-plans); the same
    arguments hit."""
    from repro_torch.launch.serve_gp import scenario_chart

    chart = scenario_chart(name, quick=quick)
    base = dict(samples=4, dtype=torch.float32, pyramid=True, device="cpu",
                mesh_key=("shardcheck", 0))
    perturbed = dict(samples=8, dtype=torch.bfloat16, pyramid=False,
                     device="meta", mesh_key=("shardcheck", 1))
    findings = []
    p0 = dispatch.plan_cached(chart, **base)
    if dispatch.plan_cached(chart, **base) is not p0:
        findings.append(Finding("cachekey", scenario, "plan_cached",
                                "the same arguments missed"))
    other = scenario_chart("image" if name != "image" else "tod",
                           quick=True)
    if dispatch.plan_cached(other, **base) is p0:
        findings.append(Finding("cachekey", scenario, "kwarg[chart]",
                                "another chart hit the cached plan"))
    for kw, val in perturbed.items():
        p1 = dispatch.plan_cached(chart, **{**base, kw: val})
        if p1 is p0:
            findings.append(Finding(
                "cachekey", scenario, f"kwarg[{kw}]",
                f"plan_cached returned the cached plan for {kw}={val!r}: "
                "its key does not cover that input"))
    return findings


def _rings(icr, sizes) -> list:
    from repro_torch.core.distributed import DistributedICR
    from repro_torch.launch.mesh import make_mesh

    out = []
    for k in sizes:
        mesh = make_mesh((k,), ("space",),
                         devices=[torch.device("cpu")] * k)
        dist = DistributedICR(icr, mesh, axis_names=("space",))
        try:
            dist.first_sharded_level()
        except ValueError:
            continue
        out.append(dist)
    return out


def shardcheck_scenario(name: str, *, quick: bool = True, slab: int = 4,
                        sizes=CPU_MESH_SIZES) -> list:
    """Every mesh pass over one serving scenario on CPU slots: the halo
    proof at each ring size the chart shards over, samples-mode placement
    at three mesh sizes, and the two cache-key audits."""
    from repro_torch.core import ICR, matern32
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve_gp import SCENARIOS, scenario_chart

    label = f"{name}-{'quick' if quick else 'full'}"
    chart = scenario_chart(name, quick=quick)
    icr = ICR(chart, matern32.with_defaults(rho=SCENARIOS[name]),
              device="cpu")
    findings = []
    rings = _rings(icr, sizes)
    if not rings:
        findings.append(Finding("mesh", label, "halo",
                                f"no ring of {list(sizes)} shards the chart"))
    for dist in rings:
        findings += halo_proof(dist, scenario=f"{label}-ring{dist.n_dev}")

    def make(k):
        mesh = make_mesh((k,), ("data",), devices=[torch.device("cpu")] * k)
        return _server(name, quick=quick, slab=slab, mesh=mesh)

    findings += samples_placement(make, sizes, scenario=label)
    findings += cachekey_audit(name, quick=quick, slab=slab, scenario=label)
    findings += plan_key_audit(name, quick=quick, scenario=label)
    return findings


def shardcheck_all(names=("tod", "image", "dust"), **kw) -> list:
    findings = []
    for name in names:
        findings += shardcheck_scenario(name, **kw)
    return findings
