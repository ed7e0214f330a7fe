"""Self-check: the sharded square root equals the unsharded one.

The counterpart of the JAX package's ``launch/_dist_icr_check.py``. Its
six cases run on a virtual mesh of 8 slots of one device (the multi-pod
ring on 2x4), each against the unsharded ``ICR.apply_sqrt`` on the same
device and the same ξ::

  PYTHONPATH=src python -m repro_torch.launch._dist_icr_check [--device cpu]

Prints one line per case, ``case max_abs_diff=… rel=…`` (rel: relative to
the largest magnitude), and exits 0 only if every rel < 1e-5.
"""
from __future__ import annotations

import argparse
import sys


def cases(device):
    """(name, ICR, mesh shape, ring axes, shard axis) of the six cases."""
    from repro_torch import ICR, log_chart, matern32, regular_chart
    from repro_torch.core.charts import galactic_dust_chart

    log = log_chart(32, 4, n_csz=5, n_fsz=4, delta0=0.01, boundary="reflect")
    return [
        # 1-D stationary (regular chart)
        ("1d_regular",
         ICR(regular_chart(32, 4, boundary="reflect"),
             matern32.with_defaults(rho=16.0), device=device),
         (8,), ("space",), 0),
        # 1-D charted (log chart, per-family matrices)
        ("1d_log_charted",
         ICR(log, matern32.with_defaults(rho=1.0), device=device),
         (8,), ("space",), 0),
        # a ring spanning two mesh axes (the multi-pod layout)
        ("1d_multipod_ring",
         ICR(regular_chart(64, 3, boundary="reflect"),
             matern32.with_defaults(rho=20.0), device=device),
         (2, 4), ("pod", "space"), 0),
        # 3-D dust chart: shard an invariant angular axis
        ("3d_dust_angular_shard",
         ICR(galactic_dust_chart((6, 32, 16), 2),
             matern32.with_defaults(rho=0.5), device=device),
         (8,), ("space",), 1),
        # the interior on the kernel route (#1, #3)
        ("1d_regular_pallas",
         ICR(regular_chart(32, 4, boundary="reflect"),
             matern32.with_defaults(rho=16.0), use_pallas=True,
             device=device),
         (8,), ("space",), 0),
        ("1d_log_charted_pallas",
         ICR(log, matern32.with_defaults(rho=1.0), use_pallas=True,
             device=device),
         (8,), ("space",), 0),
    ]


def main(argv=None) -> int:
    import torch

    from repro_torch.core.distributed import DistributedICR
    from repro_torch.launch.mesh import make_mesh

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="the device of the 8 virtual slots")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("_dist_icr_check: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    slots = [device] * 8
    ok = True
    for name, icr, shape, axes, shard_axis in cases(device):
        mesh = make_mesh(shape, axes, devices=slots)
        dist = DistributedICR(icr, mesh, axes, shard_axis)
        gen = torch.Generator(device=device).manual_seed(42)
        xi = icr.init_xi(gen)
        mats = icr.matrices()
        sharded = dist.gather(dist.apply_sqrt(mats, xi))
        ref = icr.apply_sqrt(mats, xi)
        diff = float((sharded.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        rel = diff / max(scale, 1e-30)
        print(f"{name} max_abs_diff={diff:.3e} rel={rel:.3e}")
        ok &= rel < 1e-5
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
