"""Stationary covariance kernels (paper §3.1, Eq. 14).

A kernel is a factory ``kernel(theta) -> k`` where ``k`` maps distances
``d >= 0`` to covariances. Kernels are isotropic in the modeled space; the
coordinate chart supplies anisotropy (paper §4.3). ``theta`` is a flat dict
of scalars.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch

KernelFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A stationary kernel family ``k_theta(d)``."""

    name: str
    fn: Callable[[Mapping], KernelFn]
    default_theta: Mapping[str, float]

    def __call__(self, theta: Mapping | None = None) -> KernelFn:
        theta = dict(self.default_theta) if theta is None else dict(theta)
        return self.fn(theta)

    def with_defaults(self, **kw) -> "Kernel":
        d = dict(self.default_theta)
        d.update(kw)
        return dataclasses.replace(self, default_theta=d)


def _matern32_fn(theta):
    rho, sigma = theta["rho"], theta.get("sigma", 1.0)

    def k(d):
        z = math.sqrt(3.0) * d / rho
        return sigma**2 * (1.0 + z) * torch.exp(-z)

    return k


def _matern52_fn(theta):
    rho, sigma = theta["rho"], theta.get("sigma", 1.0)

    def k(d):
        z = math.sqrt(5.0) * d / rho
        return sigma**2 * (1.0 + z + z**2 / 3.0) * torch.exp(-z)

    return k


def _rbf_fn(theta):
    rho, sigma = theta["rho"], theta.get("sigma", 1.0)

    def k(d):
        return sigma**2 * torch.exp(-0.5 * (d / rho) ** 2)

    return k


def _exponential_fn(theta):
    rho, sigma = theta["rho"], theta.get("sigma", 1.0)

    def k(d):
        return sigma**2 * torch.exp(-d / rho)

    return k


#: Matérn-3/2 — the paper's experimental kernel (Eq. 14).
matern32 = Kernel("matern32", _matern32_fn, {"rho": 1.0, "sigma": 1.0})
matern52 = Kernel("matern52", _matern52_fn, {"rho": 1.0, "sigma": 1.0})
rbf = Kernel("rbf", _rbf_fn, {"rho": 1.0, "sigma": 1.0})
exponential = Kernel("exponential", _exponential_fn, {"rho": 1.0, "sigma": 1.0})

KERNELS = {k.name: k for k in (matern32, matern52, rbf, exponential)}


def kernel_matrix(k: KernelFn, x: torch.Tensor,
                  y: torch.Tensor | None = None) -> torch.Tensor:
    """Dense kernel matrix ``K[..., i, j] = k(||x_i - y_j||)``.

    x: (N,) or (..., N, dim) points in the modeled space; y likewise
    (default x). Leading dims batch.
    """
    y = x if y is None else y
    x = x[:, None] if x.ndim == 1 else x
    y = y[:, None] if y.ndim == 1 else y
    d = torch.linalg.vector_norm(x[..., :, None, :] - y[..., None, :, :],
                                 dim=-1)
    return k(d)
