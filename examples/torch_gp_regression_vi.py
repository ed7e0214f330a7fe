"""End-to-end GP regression with the standardized generative model (paper
§3.2) on the PyTorch/CUDA port: a GP field and the kernel scale ρ from
noisy observations, with no kernel inversion.

The twin of ``examples/gp_regression_vi.py``:

  field prior : ICR on a 4096-point chart on the kernel route: every
                gradient runs the adjoint kernels
  theta prior : LogNormal on ρ, through the inverse CDF
  inference   : MAP over (ξ_field, ξ_θ) jointly, then mean-field ADVI at
                the fitted ρ for uncertainties, then the ADVI posterior
                served as field draws and predictive moments

Both fits are compiled as the JAX package's scan is: on the card each
step is one replay of a captured CUDA graph, the joint MAP's with the
matrices rebuilt from θ inside it (the families' eigenpairs by the
batched Jacobi kernel, the level-0 root a float64 Cholesky factor, no
host sync). ``--device cpu`` runs the kernels' plain versions;
``--quick`` takes a 256-point chart and a few steps.

Run:  PYTHONPATH=src python examples/torch_gp_regression_vi.py [--steps 300]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import (
    ICR,
    StandardizedModel,
    advi_fit,
    advi_posterior,
    charted_gp_dataset,
    gaussian_log_likelihood,
    lognormal_prior,
    map_fit,
    matern32,
    regular_chart,
)
from repro_torch.kernels import dispatch
from repro_torch.launch.serve_gp import GPFieldServer, GPRequest


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--n0", type=int, default=64)
    ap.add_argument("--levels", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="a 256-point chart and 40 steps")
    args = ap.parse_args()
    if args.quick:
        args.n0, args.levels, args.steps = 32, 3, 40
    dev = args.device

    chart = regular_chart(args.n0, args.levels, boundary="reflect")
    n = chart.size
    true_rho = 0.04 * n
    icr = ICR(chart, matern32.with_defaults(rho=true_rho), use_pallas=True,
              device=dev)
    truth, obs_idx, y = charted_gp_dataset(
        icr, torch.Generator(device=dev).manual_seed(0), obs_frac=0.3,
        noise_std=0.05)
    print(f"N={n} points, {obs_idx.numel()} noisy observations, "
          f"true rho={true_rho:.0f}, device={dev}")
    for entry in dispatch.plan(chart):
        print(f"  level {entry['level']}: fwd={entry['kernel']} "
              f"bwd={[v['kernel'] for v in entry['vjp']]}")

    # joint (field, θ) MAP: the matrices are rebuilt inside every step,
    # compiled with it
    priors = StandardizedModel({"rho": lognormal_prior(0.06 * n, 0.03 * n)})
    ll = gaussian_log_likelihood(0.05, obs_idx)

    def fwd(latent):
        theta = dict(priors(latent[1]))
        theta["sigma"] = 1.0
        return icr(latent[0], theta)

    latent0 = (icr.zero_xi(), priors.zero_xi(device=dev))
    t0 = time.perf_counter()
    latent, losses = map_fit(ll, fwd, latent0, y, steps=args.steps, lr=2e-2)
    rho_hat = float(priors(latent[1])["rho"])
    dt = time.perf_counter() - t0
    with torch.no_grad():
        rec = fwd(latent).reshape(-1)
    rmse = float(torch.sqrt(torch.mean((rec - truth) ** 2)))
    print(f"MAP: {args.steps} steps in {dt:.1f}s "
          f"({dt / args.steps * 1e3:.1f} ms/step)")
    print(f"  loss {float(losses[0]):.1f} -> {float(losses[-1]):.1f}")
    print(f"  field RMSE={rmse:.3f}  rho_hat={rho_hat:.0f} "
          f"(true {true_rho:.0f})")
    if not float(losses[-1]) < float(losses[0]):
        raise RuntimeError("the MAP loss did not fall")

    # mean-field ADVI over the field at the fitted ρ: one captured step
    theta = {"rho": rho_hat, "sigma": 1.0}
    mats = icr.matrices(theta)
    t0 = time.perf_counter()
    (mean, log_std), elbos = advi_fit(
        torch.Generator(device=dev).manual_seed(2), ll,
        lambda xi: icr.apply_sqrt_batch(mats, xi),
        [x.detach() for x in latent[0]], y,
        steps=max(args.steps // 2, 20))
    dt = time.perf_counter() - t0
    post_std = float(torch.mean(torch.exp(log_std[-1])))
    print(f"ADVI: {elbos.numel()} steps in {dt:.1f}s, ELBO "
          f"{float(elbos[0]):.1f} -> {float(elbos[-1]):.1f}, mean "
          f"finest-level posterior std={post_std:.3f} (prior: 1.0)")
    if not (bool(torch.isfinite(elbos).all()) and post_std < 1.0):
        raise RuntimeError("ADVI did not shrink the posterior std")

    # the ADVI fit as a Posterior, served: draws and predictive moments
    post = advi_posterior(icr, (mean, log_std), theta=theta)
    srv = GPFieldServer(post, slab=4)
    reqs = [GPRequest(kind="sample", n=2, seed=1),
            GPRequest(kind="moments", n=8, seed=2)]
    t0 = time.perf_counter()
    srv.run(reqs)
    dt = time.perf_counter() - t0
    if not all(r.done and r.error is None for r in reqs):
        raise RuntimeError(f"serving failed: {[r.error for r in reqs]}")
    mom = reqs[1]
    print(f"serve: {srv.rows_served} posterior draws in {srv.slabs_run} "
          f"slabs ({dt * 1e3:.0f} ms, cache {srv.cache_hits} hits/"
          f"{srv.cache_misses} miss); {len(reqs[0].fields)} fields + "
          f"moments({mom.n}): mean predictive std="
          f"{float(np.mean(mom.std)):.3f}")
    print("posterior fitted and served OK")


if __name__ == "__main__":
    main()
