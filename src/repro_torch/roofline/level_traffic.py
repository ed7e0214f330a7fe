"""Analytic device-memory traffic of one ICR refinement level, per route.

The counterpart of the JAX package's ``roofline/level_traffic.py``, for
the port's own routes: ``stationary-1d``, ``charted-1d``, ``nd-fused``,
``nd-axes`` and ``pyramid``. The estimates come from the level geometry
alone (no tensors), at the storage itemsize, with field and ξ terms
scaled by ``samples`` and the matrices counted once per level (they stay
cached across the sample slab). ``dispatch.plan()`` reports them as its
``hbm_bytes`` column; the server reads their sum as
``GPFieldServer.modeled_slab_bytes``.

On every route the two packages share, the model is the JAX package's,
term for term, so the totals are equal:

  ``stationary-1d`` / ``charted-1d`` / ``nd-fused``
      read the coarse field (+ reflect padding, and for the fused N-D
      level its tile rounding) + read ξ + write the fine field + the
      per-axis matrices: one launch each.
  ``nd-axes``
      one pass per axis: each reads its input field at mixed resolution
      and writes its output, ξ is read by the axis-0 pass only, and every
      pass whose axis is not minor pays a relayout, a read and a write of
      the field on each side.
  ``pyramid``
      a covered level reads its ξ and matrices; only the first covered
      level reads the coarse field (``first``), only the last writes the
      fine field (``last``).

Where the port's kernels move other bytes than the model says:

  ``stationary-1d`` / ``charted-1d``
      on a reflect boundary the padded coarse rows are built in torch
      before the launch (``dispatch.level_operands``): one more read and
      write of the coarse field. The model counts the padded read once.
  ``nd-fused``
      the same reflect pad (``nd_fused.nd_operands``), and the trailing
      noise factors are contracted into ξ by torch einsums before the
      launch (``prepare_xi0``), a few passes over ξ that the model leaves
      out, as the JAX package's model leaves out its own
      ``precontract_noise``.
  ``nd-axes``
      the relayout is real here too: ``torch.movedim`` and
      ``.contiguous()`` copy the field around each non-minor pass, and a
      reflect boundary pads each pass's rows in torch as well.
  ``pyramid``
      the fields handed from one covered level to the next go through
      two scratch buffers in device memory, read back through the L2
      (``__ldcg``). The cover rule (``dispatch.pyramid_cover``) keeps them
      within half the 50 MB L2, so the model counts them as zero, as the
      JAX package counts VMEM-resident fields; whatever the L2 evicts is
      traffic the model does not see.

The port has no ``reference`` route on the card (CPU tensors run the
kernels' plain versions, which are no yardstick of traffic) and no VMEM
fallback.
"""
from __future__ import annotations

import math

from repro_torch.dtypes import as_dtype

__all__ = ["ROUTES", "refine_level_traffic", "storage_width"]

ROUTES = ("stationary-1d", "charted-1d", "nd-fused", "nd-axes", "pyramid")


def _padded_extent(geom, a: int) -> int:
    """Coarse extent along axis ``a`` as the kernels see it: reflect adds
    ``b`` per side; the fused tile rounds up to ``(T_a + q_max)·s``."""
    n = geom.coarse_shape[a]
    if geom.boundary == "reflect":
        n += 2 * geom.b
    s = max(1, geom.n_fsz // 2)
    q_max = (geom.n_csz - 1) // s
    return max(n, (geom.T[a] + q_max) * s)


def _axis_mat_bytes(geom, itemsize: int) -> int:
    """Per-axis factors (R_a, sqrtD_a), shared on invariant axes."""
    f, c = geom.n_fsz, geom.n_csz
    return itemsize * sum(
        (geom.T[a] if geom.kept_T[a] > 1 else 1) * (f * c + f * f)
        for a in range(len(geom.coarse_shape)))


def storage_width(dtype=None) -> tuple:
    """(itemsize, dtype column) of a storage dtype (a torch dtype or a
    name; float32 by default)."""
    dt = as_dtype("float32" if dtype is None else dtype)
    return dt.itemsize, str(dt).removeprefix("torch.")


def refine_level_traffic(geom, route: str, *, samples: int = 1, dtype=None,
                         first: bool = True, last: bool = True) -> dict:
    """Estimated device-memory bytes of one refinement level on `route`:
    a breakdown with a ``"total"`` key and a ``"dtype"`` column (see the
    module docstring). ``dtype`` (a torch dtype or a name; float32 by
    default) sets the storage width; ``first``/``last`` place a
    ``pyramid`` level in its launch."""
    itemsize, dtype_name = storage_width(dtype)
    nd = len(geom.coarse_shape)
    fsz = geom.n_fsz
    n_out = math.prod(geom.fine_shape)
    xi_elems = math.prod(geom.T) * fsz**nd
    padded = math.prod(_padded_extent(geom, a) for a in range(nd))
    per = samples * itemsize

    if route == "pyramid":
        out = {"field_read": per * (padded if first else 0),
               "xi_read": per * xi_elems,
               "fine_write": per * (n_out if last else 0),
               "matrices": _axis_mat_bytes(geom, itemsize),
               "relayout": 0}
    elif route in ("stationary-1d", "charted-1d", "nd-fused"):
        out = {"field_read": per * padded,
               "xi_read": per * xi_elems,
               "fine_write": per * n_out,
               "matrices": _axis_mat_bytes(geom, itemsize),
               "relayout": 0}
    elif route == "nd-axes":
        extents = list(geom.coarse_shape)
        kernel_elems = relayout = 0
        for a in range(nd - 1, -1, -1):
            in_pad = list(extents)
            if geom.boundary == "reflect":
                in_pad[a] += 2 * geom.b
            n_in = math.prod(extents)
            extents[a] = geom.T[a] * fsz
            n_pass_out = math.prod(extents)
            kernel_elems += math.prod(in_pad) + n_pass_out
            if a == 0:
                kernel_elems += xi_elems   # the only ξ read
            if a != nd - 1:
                relayout += 2 * n_in + 2 * n_pass_out
        out = {"field_read": per * kernel_elems,
               "xi_read": 0,      # counted with the axis-0 pass above
               "fine_write": 0,   # counted with each pass above
               "matrices": _axis_mat_bytes(geom, itemsize),
               "relayout": per * relayout}
    else:
        raise ValueError(f"unknown route {route!r}; the port's routes are "
                         f"{ROUTES}")
    out["total"] = sum(out.values())
    out["dtype"] = dtype_name
    return out
