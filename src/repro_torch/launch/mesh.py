"""Device meshes of the port: slots over ``torch.device``s.

The counterpart of the JAX package's ``launch/mesh.py``. The JAX package
runs one program over a ``jax.sharding.Mesh`` of devices; the port runs
one process that drives a mesh of *slots*. A slot is a ``torch.device``
and an integer id; the ids play the part of JAX device ids (in
``DeviceLossError.device_ids`` and ``elastic.shrink_mesh``). An explicit
device list may repeat a device: eight slots on one card (or on ``cpu``)
are the port's counterpart of XLA's forced host device count, the virtual
mesh the tests and ``chip_smoke.py`` run on. It is only ever built from
an explicit ``devices=`` list, never chosen silently; without one the
mesh takes the visible CUDA cards and raises when there are too few.

``PartitionSpec`` (``P``) names, per tensor dim, the mesh axis (or a tuple
of axes, or None) the dim is split over, as
``jax.sharding.PartitionSpec`` does; ``Mesh.shard`` places a tensor by
it: each slot gets its block, on its device, one copy per (device, block)
so that slots sharing a card share the tensor (the port's
``jax.device_put(x, NamedSharding(mesh, spec))``).

Mesh layouts of the JAX package: ``make_production_mesh`` builds
(data=16, model=16), or (pod=2, data=16, model=16) with ``multi_pod``;
ICR's spatial ring is the axes flattened.

The card's constants (the H100 SXM's data sheet) live here, in one place:
the roofline terms (``roofline/analysis.py``), the dry run and
``chip_smoke.py`` read them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

__all__ = ["BANDWIDTH_BY_NAME", "HBM_BW", "HBM_BYTES", "IB_BW", "Mesh",
           "NVLINK_BW", "P", "PEAK_FLOPS_BF16", "PEAK_FLOPS_F32",
           "PartitionSpec", "Slot", "bandwidth_of", "make_host_mesh",
           "make_mesh", "make_production_mesh", "visible_devices"]

# -- the card's constants (NVIDIA H100 SXM 80 GB, data sheet, 700 W) --------
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12       # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12             # B/s, HBM3
HBM_BYTES = 80 * 10**9       # the 80 GB card's device memory
NVLINK_BW = 450e9            # B/s per direction per GPU (NVLink 4, 900 GB/s
#                              both ways)
IB_BW = 50e9                 # B/s per GPU across hosts (400 Gb/s NDR)
# device-memory bandwidth by card name (NVIDIA data sheets), first match
BANDWIDTH_BY_NAME = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                     ("H200", 4.8e12), ("H100", HBM_BW))


def bandwidth_of(name: str):
    """The device-memory bandwidth of a card by its name, or None."""
    return next((bw for key, bw in BANDWIDTH_BY_NAME if key in name), None)


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of names, or None
    (replicated); dims past the spec's length are replicated. A tuple of
    one name is that name, and it prints, as the JAX package's
    ``PartitionSpec`` does."""

    def __new__(cls, *dims):
        return super().__new__(cls, (
            d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims))

    def __repr__(self) -> str:
        return "PartitionSpec" + (tuple.__repr__(self) if self else "()")

    __str__ = __repr__


P = PartitionSpec


class Slot(NamedTuple):
    """One slot of a mesh: its id and its device."""

    id: int
    device: torch.device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device`` in the mesh's
    shape; ``axis_names``: one name per array axis; ``ids``: an int array
    of the same shape, one id per slot (default ``0..n-1``)."""

    devices: np.ndarray
    axis_names: tuple
    ids: np.ndarray = None

    def __post_init__(self):
        devs = np.empty(np.shape(self.devices), dtype=object)
        for idx in np.ndindex(devs.shape):
            devs[idx] = torch.device(np.asarray(self.devices,
                                                dtype=object)[idx])
        names = ((self.axis_names,) if isinstance(self.axis_names, str)
                 else tuple(self.axis_names))
        if len(names) != devs.ndim:
            raise ValueError(f"{len(names)} axis names for a mesh of shape "
                             f"{devs.shape}")
        ids = (np.arange(devs.size).reshape(devs.shape) if self.ids is None
               else np.asarray(self.ids, dtype=np.int64).reshape(devs.shape))
        if len(set(ids.flat)) != ids.size:
            raise ValueError(f"slot ids {ids.tolist()} are not distinct")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "ids", ids)

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order (``jax``'s ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def slots(self) -> list:
        """Every slot, in row-major (flat) order."""
        return [Slot(int(i), d) for i, d in zip(self.ids.flat,
                                                self.devices.flat)]

    def distinct_devices(self) -> list:
        """The mesh's devices without repeats, in slot order."""
        return list(dict.fromkeys(self.devices.flat))

    def block_index(self, flat: int, axes) -> tuple:
        """(index, count) of slot `flat` along the flattened `axes`."""
        coords = np.unravel_index(flat, self.devices.shape)
        shape = self.shape
        index, count = 0, 1
        for a in axes:
            pos = self.axis_names.index(a)
            index = index * shape[a] + int(coords[pos])
            count *= shape[a]
        return index, count

    def shard(self, x: torch.Tensor, spec) -> list:
        """`x` placed by `spec`: per slot (flat order) its block, on the
        slot's device. A dim split over axes of total size n gives slot k
        of the flattened axes rows ``[k·m, (k+1)·m)``, m = dim / n (which
        must divide); slots that share a device and a block share one
        tensor (a view of one copy of `x` on that device)."""
        dims = tuple(spec) + (None,) * (x.ndim - len(spec))
        whole: dict = {}
        out, made = [], {}
        for flat, slot in enumerate(self.slots):
            key = [slot.device]
            view = whole.get(slot.device)
            if view is None:
                view = whole[slot.device] = x.to(slot.device)
            for dim, axes in enumerate(dims):
                if axes is None:
                    continue
                axes = (axes,) if isinstance(axes, str) else tuple(axes)
                k, n = self.block_index(flat, axes)
                if x.shape[dim] % n:
                    raise ValueError(f"dim {dim} of {tuple(x.shape)} is not "
                                     f"divisible by mesh axes {axes} (= {n})")
                m = x.shape[dim] // n
                view = view.narrow(dim, k * m, m)
                key.append((dim, k))
            out.append(made.setdefault(tuple(key), view))
        return out


def visible_devices() -> list:
    """The visible CUDA cards, as devices."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _make(shape, axes, devices=None) -> Mesh:
    n = int(np.prod(shape))
    explicit = devices is not None
    devices = visible_devices() if devices is None else list(devices)
    if len(devices) < n:
        what = "devices were given" if explicit else "CUDA cards are visible"
        raise RuntimeError(
            f"mesh {dict(zip(axes, shape))} needs {n} devices but only "
            f"{len(devices)} {what}; pass devices= (a device may repeat) "
            "for a virtual mesh")
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(devs.reshape(tuple(shape)), tuple(axes))


def make_mesh(shape, axes, devices: Sequence | None = None) -> Mesh:
    """A mesh of ``prod(shape)`` slots over the first devices of
    `devices` (default: the visible CUDA cards); raises when there are
    too few. `devices` may repeat a device (a virtual mesh)."""
    return _make(tuple(shape), tuple(axes), devices)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Sequence | None = None) -> Mesh:
    """16x16 (256 slots) or, with ``multi_pod``, 2x16x16 (512); raises
    unless that many devices are given or visible."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, devices)


def make_host_mesh(model: int | None = None,
                   devices: Sequence | None = None) -> Mesh:
    """A (data, model) mesh over every device given (default: the visible
    CUDA cards), ``model`` wide."""
    devices = visible_devices() if devices is None else list(devices)
    model = model or 1
    return _make((len(devices) // model, model), ("data", "model"), devices)
