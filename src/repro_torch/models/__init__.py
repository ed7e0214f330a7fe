"""The LM model zoo in PyTorch: the JAX package's ten assigned
architectures (``repro.models``) as plain functions over nested dicts of
tensors. See model.py:build_model for the public entry point."""
from .model import Model, build_model

__all__ = ["build_model", "Model"]
