"""Analytic traffic models of the port's routes (``level_traffic``)."""
from .level_traffic import ROUTES, refine_level_traffic, storage_width

__all__ = ["ROUTES", "refine_level_traffic", "storage_width"]
