"""The 1-D forward refinement kernels (paper Eq. 11–12, §4.3).

One 1-D level reads the coarse field once, builds overlapping
``n_csz``-windows, contracts them with the stencil(s) and adds the
correlated correction ``sqrt(D) ξ``:

    fine[b, t*n_fsz + f] = Σ_k R[f, k] coarse[b, t*s + k]
                         + Σ_j sqrtD[f, j] ξ[b, t, j],     s = n_fsz // 2

* ``refine_stationary`` — one stencil shared by every family (regular
  axes); replaces the JAX package's ``_stationary_kernel``.
* ``refine_charted`` — per-family matrices ``R[t]``, ``sqrtD[t]``
  (charted axes); replaces ``_charted_kernel``.

Both launch ``csrc/refine_1d.cu`` on CUDA tensors and run their plain
version, the oracles of ``ref.py``, on CPU tensors. A CUDA tensor never
reaches the plain version: the kernel launches or the wrapper raises.
"""
from __future__ import annotations

import torch

from . import build
from .ref import refine_charted_ref as refine_charted_plain
from .ref import refine_stationary_ref as refine_stationary_plain

__all__ = ["refine_stationary", "refine_charted", "refine_stationary_plain",
           "refine_charted_plain", "block_shape_1d"]

# outputs per sample staged by one block: two per thread of 256
_OUTPUTS_PER_BLOCK = 512
# blocks to aim for, a few per SM of the H100's 132
_TARGET_BLOCKS = 528


def block_shape_1d(batch: int, t: int, n_fsz: int) -> tuple:
    """(families, samples) one block of ``refine_1d.cu`` owns: 512 outputs
    per sample, and as many samples as keep ~528 blocks in flight."""
    bf = max(1, _OUTPUTS_PER_BLOCK // n_fsz)
    nbf = -(-t // bf)
    bb = max(1, min(batch, nbf * batch // _TARGET_BLOCKS))
    return bf, bb


def _refine_1d(coarse, xi, r, d, *, charted: bool) -> torch.Tensor:
    build.forbid_grad(coarse, xi, r, d)
    if coarse.device.type == "cpu":
        plain = refine_charted_plain if charted else refine_stationary_plain
        return plain(coarse, xi, r, d)
    build.check_operands(coarse=coarse, xi=xi, r=r, d=d)
    batch, length = coarse.shape
    _, t, n_fsz = xi.shape
    n_csz = r.shape[-1]
    mat_lead = (t,) if charted else ()
    if (xi.shape[0] != batch or r.shape != mat_lead + (n_fsz, n_csz)
            or d.shape != mat_lead + (n_fsz, n_fsz)):
        raise ValueError(
            f"shape mismatch: coarse {tuple(coarse.shape)}, xi "
            f"{tuple(xi.shape)}, r {tuple(r.shape)}, d {tuple(d.shape)}")
    if length < (t - 1) * (n_fsz // 2) + n_csz:
        raise ValueError(f"coarse length {length} too short for {t} "
                         f"families of ({n_fsz}, {n_csz})")
    if t * n_fsz >= 2**31:
        raise ValueError("level too large for 32-bit family indices")
    bf, bb = block_shape_1d(batch, t, n_fsz)
    if -(-batch // bb) > 65535:
        raise ValueError(f"batch {batch} exceeds the launch grid")
    out = torch.empty((batch, t * n_fsz), dtype=coarse.dtype,
                      device=coarse.device)
    build.launch("refine_1d", coarse.device, build.dtype_code(coarse.dtype),
                 int(charted), coarse.data_ptr(), xi.data_ptr(), r.data_ptr(),
                 d.data_ptr(), out.data_ptr(), batch, length, t, n_csz, n_fsz,
                 bf, bb)
    build.LAUNCHES["refine_charted" if charted else "refine_stationary"] += 1
    return out


def refine_stationary(coarse, xi, r, d) -> torch.Tensor:
    """Stationary 1-D refinement, one shared stencil.

    coarse: (B, L) halo-padded, L >= (T-1)*s + n_csz; xi: (B, T, n_fsz);
    r: (n_fsz, n_csz); d: (n_fsz, n_fsz) -> fine (B, T*n_fsz), in the
    storage dtype of the operands with f32 accumulation.
    """
    return _refine_1d(coarse, xi, r, d, charted=False)


def refine_charted(coarse, xi, r, d) -> torch.Tensor:
    """Charted 1-D refinement with per-family matrices.

    coarse: (B, L); xi: (B, T, n_fsz); r: (T, n_fsz, n_csz);
    d: (T, n_fsz, n_fsz) -> fine (B, T*n_fsz).
    """
    return _refine_1d(coarse, xi, r, d, charted=True)
