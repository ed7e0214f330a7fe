from .base import (ArchConfig, EncoderConfig, MLAConfig, MoEConfig, SHAPES,
                   ShapeCell, SSMConfig, input_specs)
from .registry import ARCHS, ICR_ARCHS, arch_names, get_arch

__all__ = [
    "ArchConfig", "EncoderConfig", "MLAConfig", "MoEConfig", "SSMConfig",
    "SHAPES", "ShapeCell", "input_specs", "ARCHS", "ICR_ARCHS",
    "arch_names", "get_arch",
]
