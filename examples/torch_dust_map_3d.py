"""The paper's flagship application on the PyTorch/CUDA port: a 3-D
'dust map' GP on a (log-r, u, v) chart (paper §6, ref [24], the
122-billion-DOF run), scaled to one card.

The twin of ``examples/dust_map_3d.py``. The radial axis is charted
(per-family refinement matrices), the angular axes translation-invariant
(matrices shared, the §4.3 symmetry). With ``use_pallas=True`` every
level runs the fused N-D kernel (#9, ``csrc/nd_fused.cu``) on the card;
the pyramid does not take N-D levels on the H100 (``dispatch.
pyramid_cover``), where the JAX package's example runs the whole forward
as one pyramid launch. The distributed sample shards the middle angular
axis over ``--shards`` slots (``DistributedICR``, halos between
neighbouring slots); one card, or ``cpu``, repeats its device over the
slots (a virtual mesh), several cards take the slots in turn.

``--device cpu`` runs the kernels' plain versions; ``--quick`` takes a
(6, 16, 8)-cell chart.

Run:  PYTHONPATH=src python examples/torch_dust_map_3d.py [--shards 8]
"""
import argparse

import numpy as np
import torch

from repro_torch import ICR, galactic_dust_chart, matern32
from repro_torch.core.distributed import DistributedICR
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_mesh, visible_devices


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=8,
                    help="slots of the distributed sample (0: skip it)")
    ap.add_argument("--quick", action="store_true",
                    help="a (6, 16, 8)-cell chart of 2 levels")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False

    chart = (galactic_dust_chart((6, 16, 8), n_levels=2) if args.quick
             else galactic_dust_chart((8, 16, 16), n_levels=3))
    kernel = matern32.with_defaults(rho=0.5)
    icr = ICR(chart, kernel, use_pallas=True, device=dev)
    shape = chart.final_shape
    print(f"dust chart: {shape} = {np.prod(shape):,} voxels, "
          f"{chart.n_levels} refinement levels")
    print("radial spacings (kpc-ish):",
          np.round(np.diff(np.exp(chart.axis_coords(chart.n_levels, 0)))[:5],
                   4))

    # every level on the fused N-D kernel, forward and (adjoint kernels)
    # backward; per level the modeled device bytes at both storage
    # dtypes: bf16 must halve every estimate
    plan = dispatch.plan(chart)
    plan16 = dispatch.plan(chart, dtype="bfloat16")
    for entry, e16 in zip(plan, plan16):
        hb, hb16 = entry["hbm_bytes"], e16["hbm_bytes"]
        print(f"  level {entry['level']}: route={entry['route']} "
              f"kernel={entry['kernel']} "
              f"vjp={[v['kernel'] for v in entry['vjp']]} "
              f"est {hb['selected']/1e6:.2f} MB f32 / "
              f"{hb16['selected']/1e6:.2f} MB bf16 "
              f"({hb['nd-axes']/hb['selected']:.1f}x less than per-axis)")
        assert entry["route"] == dispatch.ROUTE_ND_FUSED, (
            "dust-map level fell off the fused N-D route", entry)
        assert hb["selected"] >= 1.9 * hb16["selected"], (hb, hb16)

    gen = torch.Generator(device=dev)
    sample = icr.sample(gen.manual_seed(0))
    print(f"sample: shape={tuple(sample.shape)} "
          f"mean={float(sample.mean()):+.3f} std={float(sample.std()):.3f}")

    # the same model under the mixed-precision policy: bf16 storage, f32
    # accumulation, on the same excitation values (cast)
    icr16 = ICR(chart, kernel, use_pallas=True, dtype_policy="bf16",
                device=dev)
    xi = icr.init_xi(gen.manual_seed(0))
    s32 = icr.apply_sqrt(icr.matrices(), xi)
    s16 = icr16.apply_sqrt(icr16.matrices(),
                           [x.to(torch.bfloat16) for x in xi])
    rel = float((s16.float() - s32).abs().max() / s32.abs().max())
    print(f"bf16 sample: dtype={s16.dtype} rel-err vs f32 {rel:.3f} "
          "(bf16 rounding, fp32 accumulation)")
    assert s16.dtype == torch.bfloat16 and rel < 0.05

    # one inference-style gradient through the kernels: MAP/ADVI cost is
    # two square-root applications and the VJP (paper §1), the adjoint
    # kernels here (on a half-size chart, as the JAX package's example)
    small = galactic_dust_chart((6, 8, 8), n_levels=2)
    icr_s = ICR(small, kernel, use_pallas=True, device=dev)
    mats = icr_s.matrices()
    xs = [x.requires_grad_(True) for x in icr_s.init_xi(gen.manual_seed(1))]
    loss = 0.5 * torch.sum(icr_s.apply_sqrt(mats, xs) ** 2)
    grad = torch.autograd.grad(loss, xs)
    gnorm = float(sum(torch.sum(g**2) for g in grad)) ** 0.5
    print(f"fused VJP: |d loss/d xi| over {len(grad)} levels = {gnorm:.2f}")
    back = icr_s.apply_sqrt_T(mats, icr_s.sample(gen.manual_seed(2)))
    print(f"sqrt(K)^T residual map: level sizes = "
          f"{[b.numel() for b in back]}")

    # batched sampling: the sample batch rides inside the kernels
    batch = icr_s.sample_batch(gen.manual_seed(42), 3)
    print(f"sample_batch(3): shape={tuple(batch.shape)} "
          f"per-sample std={[round(float(b.std()), 3) for b in batch]}")

    # distributed sample over --shards slots: a ring over the middle
    # angular axis, halos between neighbouring slots
    if args.shards > 1:
        cards = visible_devices() if dev.type == "cuda" else [dev]
        slots = [cards[i % len(cards)] for i in range(args.shards)]
        mesh = make_mesh((args.shards,), ("space",), devices=slots)
        dist = DistributedICR(icr, mesh, axis_names=("space",), shard_axis=1)
        xi = icr.init_xi(gen.manual_seed(0))
        s2 = dist.gather(dist.apply_sqrt(icr.matrices(), xi))
        ref = icr.apply_sqrt(icr.matrices(), xi)
        rel = float((s2 - ref).abs().max() / ref.abs().max())
        print(f"distributed over {args.shards} slots "
              f"({len(set(slots))} device(s)): shape={tuple(s2.shape)}, "
              f"sharded along the angular axis from level "
              f"{dist.first_sharded_level()}, rel-err vs unsharded "
              f"{rel:.1e}")
        assert rel < 1e-5
    else:
        print("(pass --shards N to see the halo-exchange path)")

    # radial correlation structure: nearby shells correlate strongly
    v = sample.cpu().numpy()
    c01 = np.corrcoef(v[0].ravel(), v[1].ravel())[0, 1]
    c0n = np.corrcoef(v[0].ravel(), v[-1].ravel())[0, 1]
    print(f"corr(shell0, shell1)={c01:.2f}  corr(shell0, shell-1)={c0n:.2f} "
          "(decaying with distance, as the Matern kernel dictates)")


if __name__ == "__main__":
    main()
