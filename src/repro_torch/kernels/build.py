"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, from the sources in this package only, into
``build/repro_torch/`` at the root of the checkout. A library's file name
carries a hash of its sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. ``build()`` compiles all missing
libraries in parallel, one ``nvcc`` per source.

``LAUNCHES`` counts kernel launches by wrapper name. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures, by library: each exported launch function's argtypes,
# ending in the launch plan's (grid x, grid y, dynamic shared memory) and
# (int device, void* stream)
_PLAN = [_I] * 3
SIGNATURES = {
    "refine_1d": {
        "refine_1d_charted_fwd": [_I, _I] + [_P] * 5 + [_I] * 8 + _PLAN
        + [_I, _P],
        "refine_1d_stationary_fwd": [_I, _I] + [_P] * 5 + [_I] * 7 + _PLAN
        + [_I, _P]},
    "refine_1d_adjoint": {
        "refine_1d_charted_adj": [_I, _I] + [_P] * 5 + [_I] * 8 + _PLAN
        + [_I, _P],
        "refine_1d_stationary_adj": [_I, _I] + [_P] * 5 + [_I] * 7 + _PLAN
        + [_I, _P]},
    "nd_fused": {
        "refine_nd_fused_fwd": [_I] + [_P] * 7 + [_I] * 16 + _PLAN
        + [_I, _P]},
    "sym_eig": {
        "sym_eig_launch": [_I] * 3 + [_P] * 4 + _PLAN + [_I, _P]},
    "dense_eigh": {
        "dense_eigh_workspace": [_I] + [_P] * 4 + [_I],
        "dense_eigh_run": [_I] + [_P] * 4 + [ctypes.c_longlong, _I, _P]},
    "pyramid": {
        "refine_pyramid_fwd":
            [_I, _P] + [_I] * 4 + [_P] * 4 + [_I, _P] + _PLAN + [_I, _P],
        "refine_pyramid_resident": [_I] * 6 + [_P]},
}
# link flags beyond NVCC_FLAGS, by library: the level-0 probe's binding
# calls the toolkit's cuSOLVER (found again at load time through an rpath
# to the toolkit's libraries, ``_link_flags``)
LINK = {"dense_eigh": ("-lcusolver",)}
# what a C entry returns when the grid or shared memory it derives differs
# from the plan it was handed (csrc/common.cuh, kPlanMismatch)
PLAN_MISMATCH = 10000


class PlanMismatchError(ValueError):
    """A launch does not match the plan that claims to describe it."""

LAUNCHES: collections.Counter = collections.Counter()
_LIBS: dict = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _link_flags(name: str) -> list:
    flags = list(LINK.get(name, ()))
    if flags:
        lib = Path(nvcc()).resolve().parents[1] / "lib64"
        flags += ["-Xlinker", f"-rpath,{lib}"]
    return flags


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK.get(name, ())).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the named libraries (default: all) that are not built yet,
    one ``nvcc`` each, all at once. Returns ``{name: ptxas report}`` for
    the libraries this call compiled. Raises on a failed compile."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *_link_flags(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    reports, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, path)  # atomic: concurrent builders never see half
        path.with_suffix(".log").write_text(log)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str):
    """The loaded library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    """Call library `name`'s launch function `fn_name` on `device`'s current
    stream; raise if the launch returned an error."""
    lib = library(name)
    err = getattr(lib, fn_name)(
        *args, device.index, torch.cuda.current_stream(device).cuda_stream)
    if err == PLAN_MISMATCH:
        raise PlanMismatchError(f"{fn_name}: its grid or shared memory "
                                "differs from the launch plan's")
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn_name} failed: {msg} ({err})")


def dtype_code(dtype: torch.dtype) -> int:
    """The C interface's storage-type code: 0 float32, 1 bfloat16."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dtype}")
