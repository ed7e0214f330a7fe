"""The cells the analysis runs over.

The serving scenarios (``launch/serve_gp.scenario_chart``: tod, image,
dust) × fp32 and bf16, quick and full, as in the JAX package's
``analysis/scenarios.py``; and the four charts ``chip_smoke.py`` drives at
full width (dust, regular, log, log_polar), at S = 8.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch import serve_gp

__all__ = ["Scenario", "SCENARIOS", "CHIP_CHARTS", "chip_scenarios"]

_STORAGE = {"fp32": "float32", "bf16": "bfloat16"}


def _chip_chart(name: str):
    from repro_torch.core import (galactic_dust_chart, log_chart,
                                  log_polar_chart, regular_chart)

    return {"dust": lambda: galactic_dust_chart((8, 16, 16), 3),
            "regular": lambda: regular_chart(1024, 10, boundary="reflect"),
            "log": lambda: log_chart(1024, 8, n_csz=5, n_fsz=4,
                                     delta0=0.0197 / 16),
            "log_polar": lambda: log_polar_chart((64, 64), 3)}[name]()


# the charts of chip_smoke.py and their kernels' ρ
CHIP_CHARTS = {"dust": 0.5, "regular": 5000.0, "log": 1.0, "log_polar": 2.0}


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One cell: a chart by name, its storage dtype (``fp32``/``bf16``),
    the sample count and whether it is a serving scenario at its quick
    size."""

    name: str
    dtype: str = "fp32"
    samples: int = 4
    quick: bool = True
    chip: bool = False

    @property
    def label(self) -> str:
        return f"{self.name}-{self.dtype}" + ("" if self.quick or self.chip
                                              else "-full")

    @property
    def storage(self) -> str:
        return _STORAGE[self.dtype]

    @property
    def rho(self) -> float:
        return (CHIP_CHARTS if self.chip else serve_gp.SCENARIOS)[self.name]

    def chart(self):
        if self.chip:
            return _chip_chart(self.name)
        return serve_gp.scenario_chart(self.name, quick=self.quick)


def SCENARIOS(quick: bool = True, samples: int = 4) -> list:
    """tod, image and dust × fp32 and bf16."""
    return [Scenario(n, dt, samples, quick)
            for n in serve_gp.SCENARIOS for dt in _STORAGE]


def chip_scenarios(samples: int = 8) -> list:
    """The four charts of ``chip_smoke.py`` at full width × fp32 and
    bf16."""
    return [Scenario(n, dt, samples, quick=False, chip=True)
            for n in CHIP_CHARTS for dt in _STORAGE]
