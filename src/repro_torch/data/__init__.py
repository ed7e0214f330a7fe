"""Synthetic datasets of the port."""
from .gp_data import charted_gp_dataset

__all__ = ["charted_gp_dataset"]
