"""Static analysis of the port's CUDA launches.

The counterpart of the JAX package's ``analysis/`` layer, rebuilt over
the port's own launch geometry (``kernels/launch.py``):

* ``scenarios`` — the cells: tod, image and dust × fp32 and bf16 (quick
  and full), and the four charts ``chip_smoke.py`` drives at full width;
* ``kernel_verify`` — proofs about every launch plan: coverage, bounds,
  halo, bytes, transpose and hygiene;
* ``lint`` — shared memory and registers against the H100's limits,
  route coverage and a dtype census;
* ``fingerprint`` / ``diff`` — structural fingerprints, diffed against
  the goldens under ``tests/golden_torch/``;
* ``mesh_verify`` — the halo proof of ``DistributedICR``, samples-mode
  placement and the cache-key audits.

``python -m repro_torch.analysis fingerprint|lint|verify|shardcheck|
roofline`` drives them and exits 1 on any finding.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Finding"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One finding of a pass: ``pass_name`` (coverage, bounds, halo,
    bytes, transpose, hygiene, lint, mesh, cachekey), the scenario, where
    and what."""

    pass_name: str
    scenario: str
    location: str
    message: str

    def __str__(self) -> str:
        return (f"[{self.pass_name}] {self.scenario} {self.location}: "
                f"{self.message}")
