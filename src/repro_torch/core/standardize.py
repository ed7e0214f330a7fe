"""Standardization of model parameters (paper §3.2).

Every parameter is a deterministic map of a standard-normal latent ξ,
``theta = CDF_theta^{-1}(CDF_xi(xi))`` (inverse transform sampling). After
standardization the joint density is Eq. 3, a Gaussian prior over ξ plus
the likelihood, with no kernel inversion or log-determinant anywhere.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class Prior:
    """A 1-D prior as a push-forward of N(0, 1)."""

    name: str
    forward: Callable[[torch.Tensor], torch.Tensor]  # xi -> theta

    def __call__(self, xi: torch.Tensor) -> torch.Tensor:
        return self.forward(xi)


def lognormal_prior(mean: float, std: float) -> Prior:
    """LogNormal with the given *linear-space* mean and std."""
    s2 = math.log1p((std / mean) ** 2)
    mu = math.log(mean) - 0.5 * s2
    sig = math.sqrt(s2)
    return Prior("lognormal", lambda xi: torch.exp(mu + sig * xi))


def normal_prior(mean: float, std: float) -> Prior:
    return Prior("normal", lambda xi: mean + std * xi)


def uniform_prior(lo: float, hi: float) -> Prior:
    return Prior("uniform",
                 lambda xi: lo + (hi - lo) * torch.special.ndtr(xi))


@dataclasses.dataclass(frozen=True)
class StandardizedModel:
    """Named priors: a dict of standard-normal scalars -> a θ dict."""

    priors: Mapping[str, Prior]

    def init_xi(self, gen: torch.Generator) -> dict:
        """Small random latents, ``0.1 · N(0, 1)``, on `gen`'s device."""
        return {n: 0.1 * torch.randn((), generator=gen, device=gen.device)
                for n in sorted(self.priors)}

    def zero_xi(self, device="cuda") -> dict:
        return {n: torch.zeros((), device=device) for n in sorted(self.priors)}

    def __call__(self, xi: Mapping[str, torch.Tensor]) -> dict:
        return {n: self.priors[n](xi[n]) for n in self.priors}
