"""``--arch`` registry: the 10 assigned architectures + the paper's own
ICR configurations (DESIGN.md §4)."""
from __future__ import annotations

import dataclasses

from .base import ArchConfig
from .starcoder2_15b import CONFIG as starcoder2_15b
from .gemma3_27b import CONFIG as gemma3_27b
from .command_r_35b import CONFIG as command_r_35b
from .gemma3_4b import CONFIG as gemma3_4b
from .internvl2_2b import CONFIG as internvl2_2b
from .xlstm_1_3b import CONFIG as xlstm_1_3b
from .deepseek_v2_236b import CONFIG as deepseek_v2_236b
from .llama4_maverick_400b import CONFIG as llama4_maverick_400b
from .whisper_base import CONFIG as whisper_base
from .zamba2_7b import CONFIG as zamba2_7b

ARCHS = {
    c.name: c for c in (
        starcoder2_15b, gemma3_27b, command_r_35b, gemma3_4b,
        internvl2_2b, xlstm_1_3b, deepseek_v2_236b, llama4_maverick_400b,
        whisper_base, zamba2_7b,
    )
}


# -- the paper's own configurations (ICR models; see repro/core) ---------------
@dataclasses.dataclass(frozen=True)
class ICRArchConfig:
    """ICR 'architecture': chart + kernel selection (paper §5 / §6)."""

    name: str
    kind: str                    # log1d | dust3d
    shape0: tuple
    n_levels: int
    n_csz: int = 5
    n_fsz: int = 4
    notes: str = ""

    def build(self, device="cuda"):
        """The port's ``ICR`` over this chart, on `device`."""
        from repro_torch.core import ICR, log_chart, matern32
        from repro_torch.core.charts import galactic_dust_chart
        if self.kind == "log1d":
            chart = log_chart(self.shape0[0], self.n_levels,
                              n_csz=self.n_csz, n_fsz=self.n_fsz,
                              delta0=0.02, boundary="reflect")
        else:
            chart = galactic_dust_chart(self.shape0, self.n_levels,
                                        n_csz=self.n_csz, n_fsz=self.n_fsz)
        return ICR(chart=chart, kernel=matern32.with_defaults(rho=1.0),
                   device=device)


ICR_ARCHS = {
    # the paper's §5 experiment geometry, scaled to production
    "icr-log1d": ICRArchConfig(
        name="icr-log1d", kind="log1d", shape0=(1024,), n_levels=17,
        notes="1-D log chart; 1024 * 2^17 ≈ 134M points"),
    # the 122-billion-DOF Galactic dust application (paper §6, ref [24]);
    # wide angular axis 1 so the spatial ring shards early (block >= b+1)
    "icr-dust122b": ICRArchConfig(
        name="icr-dust122b", kind="dust3d", shape0=(32, 128, 12),
        n_levels=7, notes="(32,128,12) * 2^(3*7) ≈ 103B points; wide "
        "angular axis => the ring shards from level 3 (pod) / 4 (multipod)"
        " and the replicated prologue stays <1 GB"),
    # a pod-scale variant used for the perf hillclimb
    "icr-dust-pod": ICRArchConfig(
        name="icr-dust-pod", kind="dust3d", shape0=(16, 128, 16),
        n_levels=5, notes="≈1.1B points; angular axis 1 shards over 512"),
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)} "
            f"+ ICR: {sorted(ICR_ARCHS)}")
    return ARCHS[name]


def arch_names():
    return sorted(ARCHS)
