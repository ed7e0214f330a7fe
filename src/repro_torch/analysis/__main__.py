"""``python -m repro_torch.analysis fingerprint|lint|verify|shardcheck|
roofline``: the port's static-analysis gate; exits 1 on any finding.

* ``fingerprint`` — each scenario's fingerprint against its golden under
  ``tests/golden_torch/`` (a structured diff); ``--update-goldens``
  rewrites them, and refuses while ``verify`` finds anything;
* ``lint`` — shared memory, residency, route coverage, dtype census;
* ``verify`` — coverage, bounds, halo, bytes, transpose and hygiene of
  every launch plan (transpose on the plain versions at float64 on the
  CPU, on the kernels with ``--device cuda``);
* ``shardcheck`` — the halo proof, samples-mode placement and the cache
  key audits on CPU slots;
* ``roofline`` — on the card, the per-kernel roofline of one scenario's
  apply (from a ``torch.profiler`` trace).

The quick serving scenarios by default; ``--full`` their full sizes,
``--chip`` the four charts of ``chip_smoke.py`` at full width.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import fingerprint, kernel_verify, lint, mesh_verify
from .diff import diff_docs, format_diff
from .scenarios import SCENARIOS, chip_scenarios


def _scenarios(args) -> list:
    scns = (chip_scenarios() if args.chip
            else SCENARIOS(quick=not args.full))
    if args.scenario:
        scns = [s for s in scns if s.name in args.scenario]
    return scns


def _report(findings) -> int:
    for f in findings:
        print(f"  {f}")
    return 1 if findings else 0


def run_fingerprint(args) -> int:
    scns = _scenarios(args)
    if args.update_goldens:
        found = kernel_verify.verify_all(scns)
        if found:
            print("refusing to update the goldens: verify finds "
                  f"{len(found)} finding(s)")
            return _report(found)
    rc = 0
    for scn in scns:
        doc = fingerprint.fingerprint_scenario(scn)
        path = fingerprint.golden_path(scn.label, args.golden_dir)
        if args.update_goldens:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(fingerprint.canonical_json(doc))
            print(f"[{scn.label}] wrote {path}")
            continue
        if not path.exists():
            print(f"[{scn.label}] no golden at {path}")
            rc = 1
            continue
        diffs = diff_docs(json.loads(path.read_text()),
                          json.loads(fingerprint.canonical_json(doc)))
        print(f"[{scn.label}] {'matches' if not diffs else 'DIFFERS'}")
        if diffs:
            print(format_diff(diffs))
            rc = 1
    return rc


def run_lint(args) -> int:
    found = []
    for scn in _scenarios(args):
        f = lint.lint_scenario(scn)
        print(f"[{scn.label}] {len(f)} finding(s)")
        found += f
    return _report(found)


def run_verify(args) -> int:
    found = []
    for scn in _scenarios(args):
        f = kernel_verify.verify_scenario(scn, device=args.device)
        print(f"[{scn.label}] {len(f)} finding(s)")
        found += f
    return _report(found)


def run_shardcheck(args) -> int:
    names = args.scenario or ["tod", "image", "dust"]
    found = []
    for name in names:
        f = mesh_verify.shardcheck_scenario(name, quick=not args.full)
        print(f"[{name}] {len(f)} finding(s)")
        found += f
    return _report(found)


def run_roofline(args) -> int:
    import torch

    from repro_torch.core import ICR, matern32
    from repro_torch.kernels import launch
    from repro_torch.roofline import analysis

    if not torch.cuda.is_available():
        print("roofline reads a trace of the card: no card here")
        return 1
    for scn in _scenarios(args):
        chart = scn.chart()
        icr = ICR(chart, matern32.with_defaults(rho=scn.rho),
                  use_pallas=True,
                  dtype_policy=None if scn.dtype == "fp32" else "bf16",
                  device="cuda")
        mats = icr.matrices()
        gen = torch.Generator(device="cuda").manual_seed(0)
        xi = icr.init_xi(gen, batch=scn.samples)
        with launch.recording() as plans:
            icr.apply_sqrt_batch(mats, xi)
        calls = 5
        events = analysis.profile(lambda: icr.apply_sqrt_batch(mats, xi),
                                  calls=calls)
        roof = analysis.roofline(analysis.attribute(events), plans,
                                 calls=calls)
        print(f"[{scn.label}] " + json.dumps(roof, sort_keys=True))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("command", choices=["fingerprint", "lint", "verify",
                                        "shardcheck", "roofline"])
    ap.add_argument("--scenario", action="append",
                    help="only this scenario (repeatable)")
    ap.add_argument("--full", action="store_true",
                    help="the serving scenarios at full size")
    ap.add_argument("--chip", action="store_true",
                    help="the four charts of chip_smoke.py at full width")
    ap.add_argument("--device", default=None,
                    help="verify's transpose pass on this device")
    ap.add_argument("--update-goldens", action="store_true")
    ap.add_argument("--golden-dir", default=None)
    args = ap.parse_args(argv)
    run = {"fingerprint": run_fingerprint, "lint": run_lint,
           "verify": run_verify, "shardcheck": run_shardcheck,
           "roofline": run_roofline}[args.command]
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
