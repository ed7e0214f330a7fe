"""Structural fingerprints of the port's launches, per scenario.

The counterpart of the JAX package's ``analysis/fingerprint.py``. The JAX
package fingerprints its lowered HLO; the port has none, so its
fingerprint is the structure of its launches, from geometry alone:

* ``plan_signature``: per level its route, VJP route, kernel, dtype and
  modeled bytes, and its launches' (kernel, instance, grid, block,
  shared memory);
* the multiset of those launch signatures for the forward, the VJP and
  the served slab (``GPFieldServer.lowered_slab`` on a CPU server of the
  scenario: the launches one slab makes on the card);
* the dtype census: bytes through device memory by dtype.

It is canonical JSON (sorted keys), diffed (``diff.py``) against the
goldens under ``tests/golden_torch/``, which ``python -m
repro_torch.analysis fingerprint --update-goldens`` writes (and refuses
to while ``verify`` finds anything).
"""
from __future__ import annotations

import collections
import json
import pathlib

from repro_torch.kernels import dispatch

from .lint import dtype_census

__all__ = ["fingerprint_scenario", "canonical_json", "golden_path",
           "GOLDEN_DIR"]

GOLDEN_DIR = (pathlib.Path(__file__).resolve().parents[3] / "tests"
              / "golden_torch")


def golden_path(label: str, golden_dir=None) -> pathlib.Path:
    return pathlib.Path(golden_dir or GOLDEN_DIR) / f"{label}.json"


def _multiset(sigs) -> list:
    """Launch signatures as sorted ``[signature, count]`` pairs."""
    counts = collections.Counter(json.dumps(s, sort_keys=True) for s in sigs)
    return [[json.loads(k), n] for k, n in sorted(counts.items())]


def chart_summary(chart) -> dict:
    return {"ndim": chart.ndim, "shape0": list(chart.shape0),
            "n_levels": chart.n_levels, "final_shape":
            list(chart.final_shape), "n_csz": chart.n_csz,
            "n_fsz": chart.n_fsz, "boundary": chart.boundary,
            "invariant": list(chart.invariant)}


def fingerprint_scenario(scn, *, slab: bool = True) -> dict:
    """The fingerprint document of a scenario (``scenarios.Scenario``);
    ``slab`` adds the served slab's launches (a CPU server is built)."""
    chart = scn.chart()
    kw = dict(samples=scn.samples, dtype=scn.storage)
    groups = dispatch.chart_launch_plans(chart, pyramid=True, **kw)
    doc = {
        "scenario": scn.label,
        "chart": chart_summary(chart),
        "samples": scn.samples,
        "storage": scn.storage,
        "plan_signature": dispatch.plan_signature(chart, pyramid=True, **kw),
        "launches": {k: _multiset(dispatch.launch_signature(p)
                                  for g in groups for p in g[k])
                     for k in ("forward", "vjp")},
        "dtype_census": dtype_census(groups),
    }
    if slab:
        from repro_torch.launch.serve_gp import GPFieldServer, demo_posterior

        post = demo_posterior(chart, scn.rho,
                              dtype_policy=None if scn.dtype == "fp32"
                              else "bf16", device="cpu")
        low = GPFieldServer(post, slab=scn.samples).lowered_slab()
        doc["launches"]["slab"] = _multiset(low["launches"])
        doc["slab_mode"] = low["mode"]
    return doc


def canonical_json(doc: dict) -> str:
    """Byte-stable JSON of a fingerprint document."""
    return json.dumps(doc, sort_keys=True, indent=1) + "\n"
