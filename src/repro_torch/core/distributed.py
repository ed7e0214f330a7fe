"""Distributed ICR: spatial sharding with halo exchange.

The counterpart of the JAX package's ``core/distributed.py``. ICR's
conditioning is *local* (each family reads ``n_csz`` coarse neighbours),
so the refinement decomposes spatially: every slot of a ring owns a
contiguous block along one chart axis, and each refinement level takes a
``b = (n_csz-1)//2`` halo from its ring neighbours, O(b) entries per slot
per level, independent of N.

The JAX package runs one ``shard_map`` over a device mesh and moves the
halos by ``lax.ppermute``. The port keeps its single-controller design:
one process drives the ring's slots (``launch.mesh``) level by level; a
halo is a tensor copy from the neighbour's block (a peer copy where the
slots sit on different cards, a copy on the card where they share one),
and the ring may repeat a device (the virtual mesh). Every halo and every
block a slot refines is a fresh tensor: ``t.to(same_device)`` aliases, and
nothing here writes into a neighbour's storage.

Requirements (the JAX package's): ``boundary="reflect"`` (uniform 2x level
sizes) and, from the first sharded level on, the family count along the
shard axis divisible by the ring size with a coarse block of at least
``b + 1`` (single-hop halos). Earlier levels run replicated, once per
distinct device of the ring; then each slot takes its block.

**The interior runs on the kernel route.** With ``icr.use_pallas`` each
slot's level goes through ``dispatch.refine`` on its pre-padded block with
``boundary="shrink"`` geometry (``_local_geom``): a 1-D level launches #1
(stationary) or #3 (charted, its per-family ``R``/``sqrtD`` sliced to the
slot's families), an N-D level #9 on the per-axis factors
(``ICR.matrices(axes=True)``), a charted shard axis's factor sliced to the
slot's families and every other factor shared. (The JAX package runs its
N-D levels on the joint jnp reference inside ``shard_map``; the port has
no plain route on the card.) The pyramid does not run here. Without
``use_pallas`` each level is ``refine_level`` on the joint matrices.

Multi-pod: the ring may span several mesh axes, flattened in order; on a
mesh with further axes the ring takes the slots at index 0 of those (the
JAX package computes the same blocks replicated there).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, P, Slot

from .charts import Chart
from .icr import ICR, _level_mats
from .refine import LevelGeom, refine_level

__all__ = ["DistributedICR", "reflect_edges"]


def reflect_edges(x: torch.Tensor, axis: int, b: int) -> torch.Tensor:
    """`x` with `b` reflected entries on each side of `axis` (numpy's
    ``"reflect"``: the edge is not repeated); a fresh tensor."""
    n = x.shape[axis]
    return torch.cat([x.narrow(axis, 1, b).flip(axis), x,
                      x.narrow(axis, n - 1 - b, b).flip(axis)], dim=axis)


@dataclasses.dataclass(frozen=True)
class DistributedICR:
    """Spatially sharded wrapper around an ICR model.

    Attributes:
      icr: the underlying model; its chart must use boundary="reflect".
      mesh: the slots (``launch.mesh.Mesh``).
      axis_names: mesh axis name(s) forming the spatial ring (flattened).
      shard_axis: which chart axis is decomposed.
    """

    icr: ICR
    mesh: Mesh
    axis_names: tuple = ("space",)
    shard_axis: int = 0

    def __post_init__(self):
        if self.icr.chart.boundary != "reflect":
            raise ValueError("DistributedICR requires boundary='reflect'")
        if isinstance(self.axis_names, str):
            object.__setattr__(self, "axis_names", (self.axis_names,))

    # -- partitioning geometry (the JAX package's, as it is) -----------------
    @property
    def n_dev(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.axis_names]))

    @property
    def chart(self) -> Chart:
        return self.icr.chart

    def first_sharded_level(self) -> int:
        """First level whose *input* (coarse grid) is sharded.

        Constraints: family count divisible by the ring size, and the
        per-device coarse block must cover the halo + edge reflection
        (block >= b + 1) so halos are single-hop.
        """
        c = self.chart
        for lvl in range(c.n_levels):
            t = c.family_count(lvl, self.shard_axis)
            blk = c.shape(lvl)[self.shard_axis] // self.n_dev
            if t % self.n_dev == 0 and t >= self.n_dev and blk >= c.b + 1:
                return lvl
        raise ValueError(
            f"no refinement level is shardable over {self.n_dev} devices "
            f"along axis {self.shard_axis} (need family count divisible by "
            f"the ring and a coarse block >= {c.b + 1}); grow shape0 or "
            "reduce devices"
        )

    def xi_structure(self):
        """Per-level xi shapes (families kept *shaped*, not flattened):
        level 0: shape0-prod vector; level l>=1: (*T_l, n_fsz^d)."""
        c = self.chart
        nd = c.ndim
        shapes = [(int(np.prod(c.shape0)),)]
        for lvl in range(c.n_levels):
            t = tuple(c.family_count(lvl, a) for a in range(nd))
            shapes.append(t + (c.n_fsz**nd,))
        return shapes

    def xi_specs(self):
        """PartitionSpec per xi leaf: replicated until first sharded level."""
        k = self.first_sharded_level()
        specs = [P()]  # level-0 excitation replicated
        for lvl in range(self.chart.n_levels):
            if lvl < k:
                specs.append(P())
            else:
                spec = [None] * (self.chart.ndim + 1)
                spec[self.shard_axis] = self.axis_names
                specs.append(P(*spec))
        return specs

    def mat_specs(self):
        """PartitionSpecs for the refinement-matrix dict: the JAX
        package's for the joint ``R``/``sqrtD``, and for the per-axis
        factors ``Rax``/``sqrtDax`` of the N-D kernel route (per level, per
        axis: the charted shard axis's factor split along its families
        from the first sharded level on, every other factor replicated)."""
        c = self.chart
        k = self.first_sharded_level()
        r_specs, d_specs, ax_specs = [], [], []
        for lvl in range(c.n_levels):
            split = lvl >= k and not c.invariant[self.shard_axis]
            if split:
                spec = [None] * (c.ndim + 2)
                spec[self.shard_axis] = self.axis_names
                r_specs.append(P(*spec))
                d_specs.append(P(*spec))
            else:
                r_specs.append(P())
                d_specs.append(P())
            ax_specs.append([P(self.axis_names) if split and a ==
                             self.shard_axis else P()
                             for a in range(c.ndim)])
        return {"sqrt0": P(), "R": r_specs, "sqrtD": d_specs,
                "Rax": ax_specs, "sqrtDax": [list(s) for s in ax_specs]}

    def out_spec(self):
        spec = [None] * self.chart.ndim
        spec[self.shard_axis] = self.axis_names
        return P(*spec)

    def _local_geom(self, lvl: int, sharded: bool) -> LevelGeom:
        """Geometry of the per-device refine: the local block is pre-padded
        on every axis, so window extraction is plain 'shrink' indexing."""
        c = self.chart
        nd = c.ndim
        t = [c.family_count(lvl, a) for a in range(nd)]
        kept = tuple(
            1 if c.invariant[a] else t[a] for a in range(nd)
        )
        coarse = list(c.shape(lvl))
        fine = list(c.shape(lvl + 1))
        if sharded:
            t[self.shard_axis] //= self.n_dev
            coarse[self.shard_axis] //= self.n_dev
            fine[self.shard_axis] //= self.n_dev
            if not c.invariant[self.shard_axis]:
                kept = tuple(
                    t[a] if a == self.shard_axis else kept[a]
                    for a in range(nd)
                )
        padded = tuple(coarse[a] + 2 * c.b for a in range(nd))
        return LevelGeom(
            coarse_shape=padded, fine_shape=tuple(fine), T=tuple(t),
            kept_T=kept, n_csz=c.n_csz, n_fsz=c.n_fsz, stride=c.stride,
            b=c.b, boundary="shrink",
        )

    def halo_bytes(self, lvl: int, samples: int = 1,
                   itemsize: int = 4) -> int:
        """Bytes the ring's halos move between slots at sharded level
        `lvl`: two ``b``-wide edges across each of the ``n_dev - 1``
        interior boundaries (the global edges reflect locally)."""
        c = self.chart
        face = int(np.prod([n for a, n in enumerate(c.shape(lvl))
                            if a != self.shard_axis]))
        return 2 * (self.n_dev - 1) * c.b * face * samples * itemsize

    # -- the ring ------------------------------------------------------------
    def ring(self) -> List[Slot]:
        """The ring's slots in ring order: the mesh's slots along
        ``axis_names`` (flattened), at index 0 of any other mesh axis."""
        return [self.mesh.slots[i] for i in self._ring_flat()]

    def _ring_flat(self) -> List[int]:
        others = [a for a in self.mesh.axis_names
                  if a not in self.axis_names]
        flat = [i for i in range(self.mesh.size)
                if all(self.mesh.block_index(i, (a,))[0] == 0
                       for a in others)]
        return sorted(flat, key=lambda i: self.mesh.block_index(
            i, self.axis_names)[0])

    def place(self, mats: dict, report: list | None = None) -> List[dict]:
        """The matrices dict placed by ``mat_specs``: per ring slot, its
        dict on its device (replicated leaves shared by the slots of a
        device, a charted shard axis's factors sliced to the slot's
        families). A spec the mesh cannot honour degrades to replication
        and is appended to `report` (``elastic.remesh_report``)."""
        from repro_torch.distributed import elastic

        specs = self.mat_specs()
        placed, degraded = elastic.remesh_report(
            mats, self.mesh, {k: specs[k] for k in mats})
        if report is not None:
            report.extend(degraded)
        return [elastic.slot_view(placed, i) for i in self._ring_flat()]

    def place_xi(self, xi: Sequence) -> List[list]:
        """Per ring slot, its excitations in the ICR layout with a leading
        sample dim: level 0 ``(S, prod shape0)``, level l ``(S, prod T_l,
        n_fsz^d)`` with the shard axis's families cut to the slot's block
        from the first sharded level on. Each leaf of `xi` is either a
        global tensor with a leading sample dim (ICR layout, or
        ``xi_structure``'s) or the list of the ring slots' blocks in
        ``xi_structure``'s layout (``init_xi``)."""
        struct = self.xi_structure()
        specs = self.xi_specs()
        ring = self._ring_flat()
        per_slot = [[] for _ in ring]
        for leaf, shape, spec in zip(xi, struct, specs):
            if isinstance(leaf, torch.Tensor):
                full = leaf.reshape((leaf.shape[0],) + tuple(shape))
                all_slots = self.mesh.shard(full, P(None, *spec))
                blocks = [all_slots[i] for i in ring]
            else:
                blocks = list(leaf)
            for out, blk in zip(per_slot, blocks):
                out.append(blk.reshape(blk.shape[0], -1, *shape[-1:])
                           if len(shape) > 1 else blk)
        return per_slot

    # -- the sharded program -------------------------------------------------
    def _policy(self):
        return self.icr.policy if self.icr.dtype_policy is not None else None

    def _refine(self, field, xl, mats: dict, lvl: int, geom: LevelGeom):
        """Level `lvl` on a batch of (padded) fields with a slot's
        matrices: ``dispatch.refine`` with ``use_pallas``, else
        ``refine_level`` per sample."""
        r, d, axis_mats = _level_mats(mats, lvl)
        if not self.icr.use_pallas:
            return torch.stack([refine_level(f, x, r, d, geom)
                                for f, x in zip(field, xl)])
        from repro_torch.kernels import dispatch

        return dispatch.refine(field, xl, r, d, geom, axis_mats=axis_mats,
                               sample_axis=True, policy=self._policy())

    def _halo_exchange(self, fields: List[torch.Tensor],
                       b: int) -> List[torch.Tensor]:
        """Each block with its ring halos of width `b` along the shard axis
        (after the leading sample dim): the neighbours' edge rows, copied
        to the slot's device; the global edges reflect locally (the
        chart's reflect boundary)."""
        ax = 1 + self.shard_axis
        n = len(fields)
        out = []
        for i, local in enumerate(fields):
            size = local.shape[ax]
            if i == 0:
                left = local.narrow(ax, 1, b).flip(ax)
            else:
                prev = fields[i - 1]
                left = prev.narrow(ax, prev.shape[ax] - b, b).to(local.device)
            if i == n - 1:
                right = local.narrow(ax, size - b - 1, b).flip(ax)
            else:
                right = fields[i + 1].narrow(ax, 0, b).to(local.device)
            out.append(torch.cat([left, local, right], dim=ax))
        return out

    def _pad_unsharded_axes(self, local: torch.Tensor) -> torch.Tensor:
        c = self.chart
        for a in range(c.ndim):
            if a != self.shard_axis:
                local = reflect_edges(local, 1 + a, c.b)
        return local

    def _sharded_body(self, mats: List[dict],
                      xi: List[list]) -> List[torch.Tensor]:
        """Per ring slot its final block (S, *local fine shape), from the
        slots' placed matrices and excitations."""
        c = self.chart
        ring = self.ring()
        k = self.first_sharded_level()
        pol = self._policy()

        # replicated prologue (levels < k): once per distinct device
        prologue = {}
        for i, slot in enumerate(ring):
            if slot.device in prologue:
                continue
            m, x = mats[i], xi[i]
            field = torch.matmul(x[0], m["sqrt0"].T).reshape(
                (x[0].shape[0],) + c.shape0)
            if self.icr.use_pallas and pol is not None:
                field = field.to(pol.storage_dtype)
            for lvl in range(k):
                field = self._refine(field, x[lvl + 1], m, lvl,
                                     LevelGeom.for_level(c, lvl))
            prologue[slot.device] = field

        # transition: each slot takes its block along the shard axis
        blk = c.shape(k)[self.shard_axis] // self.n_dev
        fields = [prologue[s.device].narrow(1 + self.shard_axis, i * blk, blk)
                  for i, s in enumerate(ring)]

        # sharded levels with halo exchange
        for lvl in range(k, c.n_levels):
            padded = [self._pad_unsharded_axes(p)
                      for p in self._halo_exchange(fields, c.b)]
            geom = self._local_geom(lvl, sharded=True)
            fields = [self._refine(p, xi[i][lvl + 1], mats[i], lvl, geom)
                      for i, p in enumerate(padded)]
        return fields

    def apply_sqrt_batch(self, mats, xi: Sequence) -> List[torch.Tensor]:
        """sqrt(K_ICR) on a batch: the ring slots' final blocks (S, *local
        fine shape), in ring order, each on its slot's device. `mats` is
        a matrices dict (placed here) or ``matrices()``' placed list; `xi`
        as ``place_xi`` takes it."""
        placed = self.place(mats) if isinstance(mats, dict) else mats
        return self._sharded_body(placed, self.place_xi(xi))

    def apply_sqrt(self, mats, xi: Sequence) -> List[torch.Tensor]:
        """``apply_sqrt_batch`` without the sample dim."""
        batched = [x[None] if isinstance(x, torch.Tensor)
                   else [b[None] for b in x] for x in xi]
        return [f[0] for f in self.apply_sqrt_batch(mats, batched)]

    def gather(self, blocks: Sequence[torch.Tensor],
               device=None) -> torch.Tensor:
        """The slots' blocks joined along the shard axis on `device` (the
        first block's by default)."""
        device = blocks[0].device if device is None else device
        ax = blocks[0].ndim - self.chart.ndim + self.shard_axis
        return torch.cat([b.to(device) for b in blocks], dim=ax)

    def init_xi(self, gen: torch.Generator | None = None, dtype=None, *,
                batch: int | None = None) -> List[list]:
        """Standard-normal excitations per ``xi_structure`` drawn from `gen`
        (on its device), placed by ``xi_specs``: per level, the ring
        slots' blocks (replicated levels: each slot the whole leaf, shared
        per device). ``batch`` prepends a sample dim (default 1, which
        ``apply_sqrt`` drops)."""
        dtype = self.icr.policy.storage_dtype if dtype is None else dtype
        device = gen.device if gen is not None else self.ring()[0].device
        ring = self._ring_flat()
        out = []
        for shape, spec in zip(self.xi_structure(), self.xi_specs()):
            full = torch.randn((batch or 1,) + tuple(shape), generator=gen,
                               device=device, dtype=torch.float32).to(dtype)
            blocks = self.mesh.shard(full, P(None, *spec))
            out.append([blocks[i] if batch else blocks[i][0] for i in ring])
        return out

    def matrices(self, theta=None) -> List[dict]:
        """The ICR's matrices at θ (on the kernel route of an N-D chart:
        the per-axis factors), placed per ring slot (``place``)."""
        return self.place(self.icr.matrices(theta))

    def sample(self, gen: torch.Generator | None = None, theta=None,
               dtype=None) -> torch.Tensor:
        """One sample, gathered on the first slot's device."""
        return self.gather(self.apply_sqrt(self.matrices(theta),
                                           self.init_xi(gen, dtype)))
