"""Hand-written CUDA kernels of the refinement levels, for Hopper.

  icr_refine.py — 1-D levels, stationary and charted: forward
                  (csrc/refine_1d.cu) and adjoint
                  (csrc/refine_1d_adjoint.cu), with autograd
  nd_fused.py   — one launch per 2-D/3-D level (csrc/nd_fused.cu); its
                  backward composes the 1-D adjoints
  nd.py         — the nd-axes route: one 1-D pass per axis (the noise-free
                  1-D kernels on the trailing axes), for learned θ
  pyramid.py    — the first levels of a chart in one cooperative launch
                  (csrc/pyramid.cu)
  dispatch.py   — route per level, the pyramid's cover, and ``plan()``
  policy.py     — storage/accumulation dtype policy
  ref.py        — plain PyTorch oracles the kernels are held against
  build.py      — nvcc build, ctypes loading, launch counters

Importing this package builds nothing: a kernel is compiled at its first
launch (or by ``build.build()``).
"""
from . import build, dispatch, nd, nd_fused, policy, pyramid, ref
from .icr_refine import (
    refine_charted,
    refine_charted_adjoint,
    refine_charted_nn,
    refine_stationary,
    refine_stationary_adjoint,
    refine_stationary_nn,
)
from .nd import refine_axes
from .nd_fused import refine_nd_fused
from .policy import BF16, FP32, DtypePolicy
from .pyramid import refine_pyramid

__all__ = [
    "build", "dispatch", "nd", "nd_fused", "policy", "pyramid", "ref",
    "refine_charted", "refine_charted_adjoint", "refine_charted_nn",
    "refine_stationary", "refine_stationary_adjoint", "refine_stationary_nn",
    "refine_axes", "refine_nd_fused", "refine_pyramid", "BF16", "FP32",
    "DtypePolicy",
]
