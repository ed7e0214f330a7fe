"""Quickstart on the PyTorch/CUDA port: sample a GP with ICR and compare
against the exact GP.

The twin of ``examples/quickstart.py``: build a chart, pick a kernel,
draw O(N) GP samples with sqrt(K_ICR) on the kernel route, and check the
implied covariance against the dense kernel matrix (only possible at
small N). Runs on the card; ``--device cpu`` runs the kernels' plain
versions, and ``--n0``/``--levels`` shrink the large chart of step 4.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import (
    ICR,
    cov_errors,
    exact_cov,
    log_chart,
    matern32,
    regular_chart,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n0", type=int, default=1024,
                    help="coarse points of the large regular chart")
    ap.add_argument("--levels", type=int, default=10,
                    help="refinement levels of the large regular chart")
    args = ap.parse_args()
    dev = args.device

    # --- 1. a GP on log-spaced points (the paper's §5 setting) ------------
    chart = log_chart(11, 5, n_csz=5, n_fsz=4, delta0=0.0197)
    n = chart.final_shape[0]
    xs = chart.grid_positions(chart.n_levels, device="cpu",
                              dtype=torch.float64)[:, 0].numpy()
    rho = float(np.diff(xs).max())
    print(f"modeling {n} points; nearest-neighbor spacing spans "
          f"{np.diff(xs).min()/rho*100:.1f}%..100% of rho")

    icr = ICR(chart, matern32.with_defaults(rho=rho), use_pallas=True,
              device=dev)

    # --- 2. draw samples (O(N), no inversion, no log-det) ------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    samples = icr.sample_batch(gen, 3)    # one batched apply, 3 samples
    print("sample[0][:5] =", samples[0].reshape(-1)[:5].cpu().numpy())

    # --- 3. validate the implied covariance against the exact kernel -------
    cov_icr = icr.implicit_cov()
    cov_true = exact_cov(chart, matern32.with_defaults(rho=rho)(),
                         device=dev)
    errs = {k: float(v) for k, v in cov_errors(cov_icr, cov_true).items()}
    print(f"covariance errors vs exact GP: MAE={errs['mae']:.2e} "
          f"(paper: 5.8e-3), max={errs['max_abs_err']:.2e} (paper: 0.13)")

    # --- 4. the same API scales: a 1M-point regular chart -------------------
    big = ICR(regular_chart(args.n0, args.levels, boundary="reflect"),
              matern32.with_defaults(rho=5000.0 * args.n0 / 1024),
              use_pallas=True, device=dev)
    s = big.sample(gen)
    print(f"{s.numel():,}-point sample: shape={tuple(s.shape)}, "
          f"std={float(s.float().std()):.3f} (same O(N) code path)")


if __name__ == "__main__":
    main()
