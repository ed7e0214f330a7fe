"""Synthetic GP regression datasets on charted grids (paper §5 setting)."""
from __future__ import annotations

import torch


def charted_gp_dataset(icr, gen: torch.Generator, *, obs_frac: float = 0.5,
                       noise_std: float = 0.05) -> tuple:
    """Draw a ground-truth field from the ICR prior and observe a random
    subset with Gaussian noise, all from `gen` (on ``icr.device``).
    Returns (truth (N,), sorted obs_idx (n_obs,), y (n_obs,) float32)."""
    truth = icr.sample(gen).reshape(-1)
    n = truth.shape[0]
    n_obs = max(int(n * obs_frac), 1)
    obs_idx = torch.sort(torch.randperm(n, generator=gen,
                                        device=truth.device)[:n_obs]).values
    y = truth[obs_idx].float() + noise_std * torch.randn(
        n_obs, generator=gen, device=truth.device)
    return truth, obs_idx, y
