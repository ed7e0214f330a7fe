"""Eigendecompositions of the refinement matrices' build, on the device.

A learned-θ step rebuilds every refinement matrix from θ: one symmetric
root per family (``sqrt(D)``), one SPD solve per family (``K_cc``) and
the level-0 root. On the TPU, XLA's ``eigh`` inside the compiled step is
a Jacobi eigensolver. ``torch.linalg.eigh`` checks its status on the host
and cannot be captured in a CUDA graph, so the port computes the
families' eigenpairs itself:

* ``sym_eig`` — a batch of symmetric n×n float32 matrices, n ≤ 32, by
  cyclic Jacobi with a fixed number of sweeps (``csrc/sym_eig.cu``). It
  replaces no TPU kernel: it is the device half of the build that XLA
  compiled for the TPU. It writes a per-matrix status, the off-diagonal
  Frobenius norm left after the last sweep relative to the input's
  (``BOUND`` bounds it), so a caller reads convergence once, after a
  whole fit.
* ``dense_eigh`` — one symmetric n×n float32 matrix of any size, by
  cuSOLVER's ``cusolverDnXsyevd`` on the current stream (``csrc/
  dense_eigh.cu``), its workspace from torch's allocator and its ``info``
  left on the device: the binding of ``chip_smoke.py --level0-probe``,
  which asks whether the level-0 root could be an eigendecomposition
  inside a CUDA graph. On the H100 it cannot (syevd invalidates the
  capture), so no path calls it: the root is a float64 Cholesky factor
  (``core/refine.level0_sqrt``).

On CPU tensors ``sym_eig`` runs ``sym_eig_plain``, the same Jacobi in
torch (same rotation order, same sweeps), and ``dense_eigh`` runs
``torch.linalg.eigh``. A CUDA tensor launches the kernel or raises.

The Jacobi: a sweep is the parallel ("round-robin") cyclic ordering, the
``m - 1`` rounds of ``m / 2`` disjoint pairs of the circle method (``m``
is n rounded up to even; a pair with the dummy index n of odd n is
skipped), each pair ``(p, q)`` rotated by the classical angle that
zeroes ``A[p, q]`` (``rotation``), all angles of a round from the matrix
at the round's start, ``A ← Jᵀ A J``, ``V ← V J``. Rotations of one round
touch disjoint rows and columns, so their order within the round does not
change the result beyond rounding. The eigenvalues come out ascending
(ties and NaN as ``torch.sort(stable=True)`` orders them), the
eigenvectors as the columns of ``V``.

Bound on the card: a matrix is read once and its eigenpairs written once,
``(2n² + n + 1)·4`` bytes; the work is ``sweeps·(m−1)·(m/2)`` rotations of
``6n`` multiply-adds each, so the small families are bound by bytes and
n = 32 by operations.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build, launch

__all__ = ["sym_eig", "sym_eig_plain", "sym_eig_plan", "dense_eigh",
           "workspace_bytes", "rounds", "sweeps_for", "MAX_N", "BOUND", "THREAD_MAX_N",
           "WARPS"]

MAX_N = 32          # the largest n: one warp per matrix
THREAD_MAX_N = 5    # n ≤ 5: one thread per matrix, held in registers
WARPS = launch.THREADS // 32   # matrices per block of the warp route
# the relative off-diagonal norm a converged matrix stays under: float32
# sweeps end at ~1e-7 to 3e-7 (n = 2 to 32); one sweep short of
# convergence leaves 1e-5 to 1e-2
BOUND = 1e-5


def sweeps_for(n: int) -> int:
    """The fixed sweep count at size `n`: cyclic Jacobi converges
    quadratically: float32 reaches its rounding level in at most 4 sweeps
    at n ≤ 5 and 8 at n ≤ 32, on random matrices and on Matérn kernel
    matrices from well to badly conditioned; two more are the margin."""
    return 6 if n <= THREAD_MAX_N else 10


@functools.lru_cache(maxsize=None)
def rounds(n: int) -> tuple:
    """The rotation order of one sweep, as ``csrc/sym_eig.cu`` derives it:
    per round r of the ``m − 1`` (m = n rounded up to even), the pairs
    ``(p, q)`` of the circle method, ``(r, m − 1)`` and ``((r + i) mod
    (m − 1), (r − i) mod (m − 1))`` for 0 < i < m / 2, in that orientation
    (p is rotated as the first index). With odd n, index n = m − 1 is a
    dummy: its pair is skipped."""
    m = n + n % 2
    return tuple(
        ((r, m - 1),) + tuple(((r + i) % (m - 1), (r - i) % (m - 1))
                              for i in range(1, m // 2))
        for r in range(m - 1))


@functools.lru_cache(maxsize=None)
def _slot_gathers(n: int, device) -> tuple:
    """The plain version keeps A's rows and columns (and V's columns) in
    each round's slot order, the round's p's, then its q's, so that its
    rotations act on slices. Returns the gathers into round 0's order from
    the natural one and from the last round's (a new sweep), into each
    later round's order from the one before, and back to the natural
    order after the last round."""
    orders = [[p for p, _ in pairs] + [q for _, q in pairs]
              for pairs in rounds(n)]

    def gather(old, new):
        pos = {idx: j for j, idx in enumerate(old)}
        return torch.tensor([pos[i] for i in new], device=device)

    natural = sorted(orders[0])
    return (gather(natural, orders[0]), gather(orders[-1], orders[0]),
            tuple(gather(o, nxt) for o, nxt in zip(orders, orders[1:])),
            gather(orders[-1], natural))


def rotation(app, aqq, apq) -> tuple:
    """(c, s) of the rotation that zeroes ``A[p, q]``: ``t = sign(τ) /
    (|τ| + sqrt(1 + τ²))``, ``τ = (A_qq − A_pp) / (2 A_pq)``, c = 1 /
    sqrt(1 + t²), s = t·c; the identity where ``A_pq`` is 0 (τ² overflows
    to inf where ``A_pq`` is negligible, and t is then 0)."""
    zero = apq == 0
    tau = (aqq - app) / (2 * torch.where(zero, torch.ones_like(apq), apq))
    sign = torch.where(tau >= 0, 1.0, -1.0).to(tau.dtype)
    t = sign / (tau.abs() + torch.sqrt(1 + tau * tau))
    t = torch.where(zero, torch.zeros_like(t), t)
    c = 1 / torch.sqrt(1 + t * t)
    return c, t * c


def _rotate(x, c, s):
    """``x J`` on the paired slots of the last axis (the p's, then the
    q's): (c·x_p − s·x_q, s·x_p + c·x_q), each product and sum rounded on
    its own, as the kernel computes it."""
    k = c.shape[-1]
    xp, xq = x[..., :k], x[..., k:]
    return torch.cat([c * xp - s * xq, s * xp + c * xq], -1)


def _sorted(diag, vecs) -> tuple:
    evals, order = torch.sort(diag, dim=-1, stable=True)
    return evals, vecs.gather(-1, order[..., None, :].expand(vecs.shape))


def sym_eig_plain(mat: torch.Tensor, sweeps: int | None = None) -> tuple:
    """``sym_eig`` in torch, on any device and dtype (the oracle the kernel
    is held against): ``(evals (..., n) ascending, evecs (..., n, n) by
    column, status (...))``. The dummy index of odd n is a zero row and
    column: its pair has ``A_pq = 0``, the identity rotation, as the
    kernel skips it."""
    n = mat.shape[-1]
    sweeps = sweeps_for(n) if sweeps is None else sweeps
    lead = mat.shape[:-2]
    a = mat.reshape(-1, n, n)
    b, m = a.shape[0], n + n % 2
    norm = torch.linalg.vector_norm(a.reshape(b, -1), dim=-1)
    if m > n:
        a = torch.nn.functional.pad(a, (0, 1, 0, 1))
    v = torch.eye(m, dtype=a.dtype, device=a.device).expand(b, m, m)
    start, wrap, gathers, back = _slot_gathers(n, a.device)
    for sweep in range(sweeps):
        for g in ((wrap if sweep else start),) + gathers:
            a, v = a[:, g][:, :, g], v[:, :, g]
            diag = a.diagonal(dim1=-2, dim2=-1)
            c, s = rotation(diag[:, :m // 2], diag[:, m // 2:],
                            a[:, :m // 2, m // 2:].diagonal(dim1=-2,
                                                             dim2=-1))
            c, s = c[:, None], s[:, None]
            # A J (columns), then Jᵀ (A J) (rows), then V J
            a = _rotate(_rotate(a, c, s).mT, c, s).mT
            v = _rotate(v, c, s)
    if sweeps:
        a, v = a[:, back][:, :, back], v[:, :, back]
    a, v = a[:, :n, :n], v[:, :n, :n]
    diag = a.diagonal(dim1=-2, dim2=-1)
    off = torch.linalg.vector_norm((a - torch.diag_embed(diag)).reshape(b, -1),
                                   dim=-1)
    status = off / torch.where(norm > 0, norm, torch.ones_like(norm))
    evals, evecs = _sorted(diag, v)
    return (evals.reshape(lead + (n,)), evecs.reshape(lead + (n, n)),
            status.reshape(lead))


@functools.lru_cache(maxsize=256)
def sym_eig_plan(batch: int, n: int, sweeps: int) -> launch.LaunchPlan:
    """The launch of ``batch`` n×n matrices: one thread per matrix for
    n ≤ ``THREAD_MAX_N`` (grid ceil(batch / 256)), else one warp per
    matrix, ``WARPS`` to a block, A and V in shared memory (grid
    ceil(batch / WARPS))."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"sym_eig takes 1 ≤ n ≤ {MAX_N}, not {n}")
    thread = 2 <= n <= THREAD_MAX_N
    if thread:
        grid, smem = -(-batch // launch.THREADS), 0
    else:
        grid, smem = -(-batch // WARPS), WARPS * _warp_floats(n) * 4
    return launch.LaunchPlan(
        kernel="sym_eig", library="sym_eig", entry="sym_eig_launch",
        instance={"dtype": "float32", "n": n, "sweeps": sweeps,
                  "route": "thread" if thread else "warp"},
        grid=(grid, 1, 1), block=(launch.THREADS, 1, 1), smem=smem,
        operands=(launch.Operand("a", (batch, n, n), "float32"),
                  launch.Operand("evals", (batch, n), "float32", out=True),
                  launch.Operand("evecs", (batch, n, n), "float32",
                                 out=True),
                  launch.Operand("status", (batch,), "float32", out=True)),
        ownership=functools.partial(_ownership, batch, n))


def _ownership(batch: int, n: int) -> tuple:
    """One unit per matrix (a thread, or a warp): it reads its matrix
    whole and writes its eigenvalues, eigenvectors and status."""
    b = np.arange(batch)
    mat = launch.Boxes.of((b, b + 1), (0, n), (0, n))
    return (launch.Group(
        label="sym_eig",
        spaces={"a": (batch, n, n), "evals": (batch, n),
                "evecs": (batch, n, n), "status": (batch,)},
        writes={"evals": launch.Boxes.of((b, b + 1), (0, n)), "evecs": mat,
                "status": launch.Boxes.of((b, b + 1))},
        reads={"a": mat}, needs={"a": mat}),)


def _warp_floats(n: int) -> int:
    # per warp: A and V with rows padded to n + 1, then c and s of a round
    # and its pairs (as floats' worth of ints): kWarpFloats in sym_eig.cu
    return 2 * n * (n + 1) + 4 * (MAX_N // 2)


def sym_eig(mat: torch.Tensor, sweeps: int | None = None, *,
            out: tuple | None = None) -> tuple:
    """Eigenpairs of a batch of symmetric n×n float32 matrices, n ≤ 32:
    ``(evals (..., n) ascending, evecs (..., n, n) by column, status
    (...))``, status the relative off-diagonal norm left (``BOUND``).
    Launches ``csrc/sym_eig.cu`` on a CUDA tensor, one launch for the
    whole batch, into `out` (evals, evecs, status; contiguous, of the
    batch's flat shapes) where given; runs ``sym_eig_plain`` on a CPU
    tensor."""
    n = mat.shape[-1]
    sweeps = sweeps_for(n) if sweeps is None else sweeps
    if not mat.is_cuda:
        return sym_eig_plain(mat, sweeps)
    if mat.dtype != torch.float32:
        raise TypeError(f"sym_eig takes float32, not {mat.dtype}")
    lead = mat.shape[:-2]
    a = mat.reshape(-1, n, n).contiguous()
    b = a.shape[0]
    if out is None:
        out = (torch.empty((b, n), dtype=a.dtype, device=a.device),
               torch.empty((b, n, n), dtype=a.dtype, device=a.device),
               torch.empty((b,), dtype=a.dtype, device=a.device))
    evals, evecs, status = out
    if b:
        launch.run_plan(sym_eig_plan(b, n, sweeps),
                        {"a": a, "evals": evals, "evecs": evecs,
                         "status": status},
                        n, b, sweeps, a.data_ptr(), evals.data_ptr(),
                        evecs.data_ptr(), status.data_ptr())
    return (evals.reshape(lead + (n,)), evecs.reshape(lead + (n, n)),
            status.reshape(lead))


# -- the level-0 probe's binding: cuSOLVER's syevd on the current stream -------
_CUSOLVER_STATUS = {1: "NOT_INITIALIZED", 2: "ALLOC_FAILED",
                    3: "INVALID_VALUE", 4: "ARCH_MISMATCH",
                    5: "MAPPING_ERROR", 6: "EXECUTION_FAILED",
                    7: "INTERNAL_ERROR", 8: "MATRIX_TYPE_NOT_SUPPORTED",
                    9: "NOT_SUPPORTED"}
_WORKSPACE: dict = {}


def _dense_call(fn_name: str, *args) -> None:
    lib = build.library("dense_eigh")
    err = getattr(lib, fn_name)(*args)
    if err >= 20000:
        code = err - 20000
        raise RuntimeError(f"{fn_name}: cuSOLVER status "
                           f"{_CUSOLVER_STATUS.get(code, code)}")
    if err != 0:
        raise RuntimeError(f"{fn_name}: "
                           f"{lib.repro_cuda_error_string(err).decode()}")


def _workspace(n: int, device: torch.device, a, w) -> int:
    """Device workspace bytes of syevd at size n, queried once per size and
    device, eagerly (the query creates the device's cuSOLVER handle)."""
    key = (n, device.index)
    if key not in _WORKSPACE:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"dense_eigh: a {n}×{n} root reached a "
                               "capture before an eager call sized its "
                               "workspace")
        dev, host = ctypes.c_longlong(0), ctypes.c_longlong(0)
        _dense_call("dense_eigh_workspace", n, a.data_ptr(), w.data_ptr(),
                    ctypes.addressof(dev), ctypes.addressof(host),
                    device.index)
        _WORKSPACE[key] = (max(int(dev.value), 1), int(host.value))
    return _WORKSPACE[key][0]


def workspace_bytes(n: int, device) -> tuple | None:
    """(device, host) workspace bytes syevd took at size n on `device`, once
    a root of that size ran there."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return _WORKSPACE.get((n, index))


def dense_eigh(mat: torch.Tensor) -> tuple:
    """Eigenpairs of one symmetric n×n float32 matrix: ``(evals (n,)
    ascending, evecs (n, n) by column, info (1,) int32)``. On a CUDA
    tensor cuSOLVER's ``cusolverDnXsyevd`` on the current stream (no host
    sync: it can be captured), ``info`` on the device (0: success);
    ``torch.linalg.eigh`` on a CPU tensor, info 0."""
    if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
        raise ValueError(f"dense_eigh takes one square matrix, not "
                         f"{tuple(mat.shape)}")
    n = mat.shape[-1]
    if not mat.is_cuda:
        evals, evecs = torch.linalg.eigh(mat)
        return evals, evecs, torch.zeros(1, dtype=torch.int32)
    if mat.dtype != torch.float32:
        raise TypeError(f"dense_eigh takes float32, not {mat.dtype}")
    a = mat.contiguous().clone()     # syevd overwrites it with V
    w = torch.empty((n,), dtype=a.dtype, device=a.device)
    info = torch.empty((1,), dtype=torch.int32, device=a.device)
    nbytes = _workspace(n, a.device, a, w)
    work = torch.empty((nbytes,), dtype=torch.uint8, device=a.device)
    _dense_call("dense_eigh_run", n, a.data_ptr(), w.data_ptr(),
                info.data_ptr(), work.data_ptr(), nbytes, a.device.index,
                torch.cuda.current_stream(a.device).cuda_stream)
    # column-major eigenvectors of a symmetric matrix: row j of the
    # row-major buffer is eigenvector j
    return w, a.mT, info
