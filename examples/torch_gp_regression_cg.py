"""Exact data-conditioned GP posteriors through the guarded CG path, on
the PyTorch/CUDA port.

The twin of ``examples/gp_regression_cg.py``. Two routes to the same
posterior, both matrix-free (the covariance only ever acts through ICR
square-root applications, on the kernels):

  direct      : ``cg_posterior`` — solve (W K Wᵀ + σ²I) α = y with the
                ICR-whitened preconditioner, whiten the correction and
                serve the exact posterior mean through the ordinary
                sampling path. The structured SolveReport (iterations,
                residuals, fallback rungs, quarantined RHS) rides back.
  serving     : a ``kind="condition"`` request against a GPFieldServer:
                the same solve batched with Matheron pathwise samples, so
                the response carries a predictive std too.

Runs on the card; ``--device cpu`` runs the kernels' plain versions.

Run:  PYTHONPATH=src python examples/torch_gp_regression_cg.py [--n0 32]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import ICR, cg_posterior, matern32, regular_chart
from repro_torch.launch.serve_gp import (GPFieldServer, GPRequest,
                                         demo_posterior)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n0", type=int, default=32)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--noise", type=float, default=0.25)
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device

    chart = regular_chart(args.n0, args.levels, boundary="reflect")
    n = int(np.prod(chart.final_shape))
    rho = 0.06 * n
    icr = ICR(chart, matern32.with_defaults(rho=rho), use_pallas=True,
              device=dev)

    # synthetic data: a prior draw observed at half the pixels
    rng = np.random.default_rng(0)
    mats = icr.matrices_cached(None)
    gen = torch.Generator(device=dev).manual_seed(7)
    truth = icr.apply_sqrt(mats, icr.init_xi(gen)).reshape(-1).cpu().numpy()
    # observe the left half of the domain only: the unobserved right half
    # shows the predictive std relaxing back toward the prior
    obs_idx = np.arange(n // 2)
    y = (truth[obs_idx]
         + args.noise * rng.standard_normal(obs_idx.size)).astype(np.float32)
    print(f"N={n} points, {obs_idx.size} noisy observations, "
          f"rho={rho:.0f}, sigma={args.noise}, device={dev}")

    # -- route 1: cg_posterior ------------------------------------------------
    t0 = time.perf_counter()
    post, report = cg_posterior(icr, obs_idx, y, noise_std=args.noise)
    mean = icr.apply_sqrt(mats, post.mean).reshape(-1).cpu().numpy()
    dt = time.perf_counter() - t0
    s = report.summary()
    print(f"cg_posterior: {dt:.2f}s rungs={s['rungs']} "
          f"iterations={s['iterations']} relres={s['final_relres']:.1e} "
          f"status={s['status']}")
    if not report.ok:
        raise RuntimeError(f"cg_posterior failed: {s}")
    rmse = float(np.sqrt(np.mean((mean - truth) ** 2)))
    prior_rms = float(np.sqrt(np.mean(truth ** 2)))
    print(f"posterior-mean RMSE vs truth: {rmse:.3f} "
          f"(prior field RMS {prior_rms:.3f})")
    if not rmse < prior_rms:  # conditioning must beat the prior
        raise RuntimeError("the posterior mean does not beat the prior")

    # -- route 2: kind="condition" serving ------------------------------------
    srv = GPFieldServer(demo_posterior(chart, rho, device=dev), slab=4)
    req = GPRequest(kind="condition", n=args.samples, seed=11, y=y,
                    obs_idx=obs_idx, noise_std=args.noise)
    t0 = time.perf_counter()
    srv.run([req])
    dt = time.perf_counter() - t0
    if not req.done or req.error is not None:
        raise RuntimeError(f"condition request failed: {req.error}")
    std = req.std.reshape(-1)
    met = srv.metrics()
    print(f"served condition request: {dt:.2f}s "
          f"{args.samples} Matheron draws, "
          f"report={met['solve_reports'][-1]['status']}")
    print(f"predictive std: observed pixels {std[obs_idx].mean():.3f}, "
          f"unobserved {np.delete(std, obs_idx).mean():.3f}")
    if not std[obs_idx].mean() < np.delete(std, obs_idx).mean():
        raise RuntimeError("observations did not lower the predictive std")
    print("conditioned posterior served OK")


if __name__ == "__main__":
    main()
