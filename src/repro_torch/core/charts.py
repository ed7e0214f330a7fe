"""Coordinate charts and the regular refinement grid ladder (paper §4.2–4.3).

ICR refines a ladder of regular Euclidean grids, the chart codomain. The
chart map ``phi_inv`` takes chart coordinates to the modeled space, where
the kernel is evaluated (paper §4.3).

Geometry (paper §4.1, §4.4, Fig. 1/2), per axis:

* level ``l`` has size ``N_l``, spacing ``Δ_l`` and origin ``o_l``;
* a refinement family sits on a central coarse pixel ``i`` and conditions
  ``n_fsz`` fine pixels on the ``n_csz`` nearest coarse pixels
  ``i-b … i+b``, ``b = (n_csz-1)//2``;
* fine spacing is ``Δ_l / 2`` and consecutive families stride
  ``n_fsz//2`` coarse pixels, so each level is again a regular grid.

Boundaries: ``"shrink"`` refines only pixels with a full neighbourhood and
loses ``n_csz - 1`` pixels per level (paper §4.2); ``"reflect"`` anchors a
family on every stride-th pixel and reflects out-of-range neighbours, so
every level is an exact 2x of its parent.

The window geometry is numpy float64, identical to the JAX package's; only
the chart maps are torch functions.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch


def _as_tuple(x, ndim, name):
    if x is None:
        return None
    if np.isscalar(x):
        return (x,) * ndim
    t = tuple(x)
    if len(t) != ndim:
        raise ValueError(f"{name} must have length {ndim}, got {t}")
    return t


@dataclasses.dataclass(frozen=True)
class Chart:
    """Refinement grid ladder + coordinate chart (frozen, hashable).

    Attributes:
      shape0: per-axis level-0 grid size.
      n_levels: number of refinement steps (level 0 is the exact coarse grid).
      n_csz: coarse neighbourhood size per axis (odd, >= 3).
      n_fsz: fine family size per axis (even, >= 2).
      delta0: level-0 spacing per axis in chart units.
      origin0: chart coordinate of pixel 0 per axis.
      boundary: "shrink" (paper) or "reflect" (uniform 2x).
      phi_inv: chart map on torch tensors, ``(..., ndim) -> (..., dim_D)``;
        ``None`` is the identity.
      invariant: per-axis flags; True means the chart and kernel are
        translation invariant along that axis, so one set of refinement
        matrices serves every family along it (paper §4.3).
    """

    shape0: tuple
    n_levels: int
    n_csz: int = 3
    n_fsz: int = 2
    delta0: tuple = None
    origin0: tuple = None
    boundary: str = "shrink"
    phi_inv: Callable = None
    invariant: tuple = None

    def __post_init__(self):
        shape0 = ((self.shape0,) if np.isscalar(self.shape0)
                  else tuple(self.shape0))
        object.__setattr__(self, "shape0", shape0)
        nd = len(shape0)
        object.__setattr__(
            self, "delta0", _as_tuple(self.delta0, nd, "delta0") or (1.0,) * nd)
        object.__setattr__(
            self, "origin0",
            _as_tuple(self.origin0, nd, "origin0") or (0.0,) * nd)
        inv = self.invariant
        if inv is None:
            inv = (self.phi_inv is None,) * nd
        object.__setattr__(self, "invariant", _as_tuple(inv, nd, "invariant"))
        if self.n_csz % 2 != 1 or self.n_csz < 3:
            raise ValueError("n_csz must be odd and >= 3")
        if self.n_fsz % 2 != 0 or self.n_fsz < 2:
            raise ValueError("n_fsz must be even and >= 2")
        if self.boundary not in ("shrink", "reflect"):
            raise ValueError(f"unknown boundary {self.boundary!r}")
        for lvl in range(self.n_levels):
            for n in self.shape(lvl):
                if n < self.n_csz:
                    raise ValueError(
                        f"level {lvl} has size {n} < n_csz={self.n_csz}; "
                        "increase shape0 or reduce n_levels")

    # -- static geometry ----------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape0)

    @property
    def b(self) -> int:
        return (self.n_csz - 1) // 2

    @property
    def stride(self) -> int:
        return self.n_fsz // 2

    def family_count(self, level: int, axis: int) -> int:
        """Number of refinement families along `axis` refining `level`."""
        n = self.shape(level)[axis]
        if self.boundary == "shrink":
            return (n - 2 * self.b - 1) // self.stride + 1
        if n % self.stride != 0:
            raise ValueError(
                f"reflect boundary requires size % (n_fsz//2) == 0, got {n}")
        return n // self.stride

    def _family_count_for(self, n: int) -> int:
        if self.boundary == "shrink":
            return (n - 2 * self.b - 1) // self.stride + 1
        return n // self.stride

    def shape(self, level: int) -> tuple:
        """Per-axis grid size at `level` (0 = coarsest)."""
        s = self.shape0
        for _ in range(level):
            s = tuple(self.n_fsz * self._family_count_for(n) for n in s)
        return s

    def delta(self, level: int) -> tuple:
        return tuple(d / (2.0**level) for d in self.delta0)

    def origin(self, level: int) -> tuple:
        o = list(self.origin0)
        anchor0 = self.b if self.boundary == "shrink" else 0
        for lvl in range(level):
            for a in range(self.ndim):
                da = self.delta0[a] / (2.0**lvl)
                o[a] = o[a] + anchor0 * da - (self.n_fsz - 1) * da / 4.0
        return tuple(o)

    @property
    def final_shape(self) -> tuple:
        return self.shape(self.n_levels)

    @property
    def size(self) -> int:
        return int(np.prod(self.final_shape))

    # -- chart coordinates ---------------------------------------------------
    def axis_coords(self, level: int, axis: int) -> np.ndarray:
        """Chart coordinates of all pixels along `axis` at `level`."""
        n = self.shape(level)[axis]
        return (self.origin(level)[axis]
                + np.arange(n) * self.delta(level)[axis])

    def _family_centers_idx(self, level: int, axis: int) -> np.ndarray:
        t = np.arange(self.family_count(level, axis))
        anchor0 = self.b if self.boundary == "shrink" else 0
        return anchor0 + t * self.stride

    def axis_coarse_windows(self, level: int, axis: int) -> np.ndarray:
        """(T_a, n_csz) chart coords of each family's coarse neighbours."""
        n = self.shape(level)[axis]
        centers = self._family_centers_idx(level, axis)
        idx = centers[:, None] + np.arange(-self.b, self.b + 1)[None, :]
        if self.boundary == "reflect":
            idx = np.abs(idx)
            idx = np.minimum(idx, 2 * (n - 1) - idx)
        elif (idx < 0).any() or (idx >= n).any():
            raise ValueError("shrink window out of range")
        return self.origin(level)[axis] + idx * self.delta(level)[axis]

    def axis_fine_windows(self, level: int, axis: int) -> np.ndarray:
        """(T_a, n_fsz) chart coords of each family's fine children."""
        centers = self._family_centers_idx(level, axis)
        d = self.delta(level)[axis]
        c = self.origin(level)[axis] + centers * d
        off = (np.arange(self.n_fsz) - (self.n_fsz - 1) / 2.0) * d / 2.0
        return c[:, None] + off[None, :]

    def grid_positions(self, level: int, *, device="cuda",
                       dtype=torch.float32) -> torch.Tensor:
        """All charted positions at `level`, (prod(shape_l), dim_D).

        Only for small levels (tests, the level-0 exact sqrt). The chart
        coordinates are made on `device` once per (level, device, dtype)
        and kept (``_grid_coords``), so a learned-θ build of the level-0
        root copies nothing from the host.
        """
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        coords = _grid_coords(self, level, device, dtype)
        # the identity map would hand out the kept tensor itself
        return self.map_to_D(coords.clone() if self.phi_inv is None
                             else coords)

    def map_to_D(self, chart_pts: torch.Tensor) -> torch.Tensor:
        """Map chart coordinates (..., ndim) to the modeled space."""
        if self.phi_inv is None:
            return chart_pts
        out = self.phi_inv(chart_pts)
        if out.ndim == chart_pts.ndim - 1:  # scalar-valued map
            out = out[..., None]
        return out


@functools.lru_cache(maxsize=256)
def _grid_coords(chart: Chart, level: int, device: torch.device,
                 dtype) -> torch.Tensor:
    """The chart coordinates of every pixel at `level`, (prod(shape_l),
    ndim): the numpy float64 grid cast to `dtype` on `device`."""
    axes = [chart.axis_coords(level, a) for a in range(chart.ndim)]
    mesh = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return torch.as_tensor(mesh.reshape(-1, chart.ndim), dtype=dtype,
                           device=device)


# -- chart maps (module-level so charts stay picklable and hashable) -----------
@dataclasses.dataclass(frozen=True)
class _LogMap:
    """``phi_inv(x) = base_scale * exp(x)``."""

    base_scale: float

    def __call__(self, x):
        return self.base_scale * torch.exp(x)


def _log_polar_map(x):
    # (log r, azimuth) -> the plane
    r = torch.exp(x[..., 0])
    return torch.stack([r * torch.cos(x[..., 1]), r * torch.sin(x[..., 1])],
                       dim=-1)


def _dust_map(x):
    # log-r axis maps to true radii; the angular axes stay chart distances
    # (flat patch at each shell)
    r = torch.exp(x[..., 0])
    return torch.stack([r, x[..., 1], x[..., 2]], dim=-1)


# -- common chart constructors ------------------------------------------------
def regular_chart(shape0, n_levels, *, n_csz=3, n_fsz=2, delta0=1.0,
                  boundary="shrink") -> Chart:
    """Identity chart: regularly spaced modeled points (paper §4.1–4.2)."""
    return Chart(shape0=shape0, n_levels=n_levels, n_csz=n_csz, n_fsz=n_fsz,
                 delta0=delta0, boundary=boundary, phi_inv=None)


def log_chart(shape0, n_levels, *, n_csz=3, n_fsz=2, delta0=1.0, origin0=0.0,
              base_scale=1.0, boundary="shrink") -> Chart:
    """1-D logarithmic chart, ``phi_inv(x) = base_scale * exp(x)`` — the
    paper's §5 setup, where neighbour distances vary exponentially."""
    return Chart(shape0=shape0, n_levels=n_levels, n_csz=n_csz, n_fsz=n_fsz,
                 delta0=delta0, origin0=origin0, boundary=boundary,
                 phi_inv=_LogMap(base_scale), invariant=(False,))


def log_polar_chart(shape0, n_levels, *, n_csz=3, n_fsz=2, delta_logr=0.05,
                    origin_logr=0.0, boundary="reflect") -> Chart:
    """2-D (log r, azimuth) chart mapped to the plane. Neither axis is
    translation invariant, so both carry per-family matrices: the one
    chart whose trailing axis is charted."""
    n_phi = shape0[1] if not np.isscalar(shape0) else shape0
    return Chart(shape0=shape0, n_levels=n_levels, n_csz=n_csz, n_fsz=n_fsz,
                 delta0=(delta_logr, 2 * math.pi / n_phi),
                 origin0=(origin_logr, 0.0), boundary=boundary,
                 phi_inv=_log_polar_map, invariant=(False, False))


def galactic_dust_chart(shape0, n_levels, *, n_csz=5, n_fsz=4,
                        delta_logr=0.02, origin_logr=0.0,
                        angular_extent=1.0, boundary="reflect") -> Chart:
    """3-D (log-r, u, v) chart of the Galactic dust application (paper §6):
    a logarithmic radial axis and two locally flat angular axes, which are
    translation invariant, so their matrices are computed once."""
    d_ang = angular_extent / (shape0[1] if not np.isscalar(shape0) else shape0)
    return Chart(shape0=shape0, n_levels=n_levels, n_csz=n_csz, n_fsz=n_fsz,
                 delta0=(delta_logr, d_ang, d_ang),
                 origin0=(origin_logr, 0.0, 0.0), boundary=boundary,
                 phi_inv=_dust_map, invariant=(False, True, True))
