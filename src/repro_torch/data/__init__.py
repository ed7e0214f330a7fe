"""Synthetic datasets of the port: the GP charts' observations and the LM
token stream with its prefetching iterator."""
from .gp_data import charted_gp_dataset
from .pipeline import SyntheticLMData, make_batch_iterator

__all__ = ["charted_gp_dataset", "SyntheticLMData", "make_batch_iterator"]
