"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface, so ``nvcc`` alone
compiles it into a shared library in seconds (a source that includes
PyTorch's headers takes minutes) and ``ctypes`` loads it. Each library
lands in ``build/torch_ext/`` at the root of the checkout, named by a hash
of its source and flags, so an edited kernel is rebuilt and a stale one is
never loaded. Nothing is built when this module is imported: the first
launch calls :func:`load_warp_library`, :func:`load_hist_library` or
:func:`load_lane_interp_library`, and several sources may build at once
(each ``nvcc`` writes its own file).

Flags: ``--fmad=false`` keeps every float32 operation rounded on its own,
so the kernels are bit-equal to their plain PyTorch twins;
``sm_90a`` is Hopper with its architecture-specific instructions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "build_library", "load_hist_library",
           "load_lane_interp_library", "load_warp_library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-O3", "--fmad=false", "-std=c++17",
              "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir():
    """``build/torch_ext`` at the root of the checkout."""
    return Path(__file__).resolve().parents[2] / "build" / "torch_ext"


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def build_library(name):
    """Compile csrc/<name>.cu (if not built yet) -> (path, ptxas report)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = build_dir() / f"libmia_{name}_{digest}.so"
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a racing process never loads half a file
    return out, proc.stderr


# the warp library's entry points: name -> argtypes (each returns a
# cudaError_t as int)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
WARP_ENTRIES = {
    "mia_warp_coords": [_P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _F,
                        _P, _P, _P, _P, _I, _P],
    "mia_warp_affine": [_P, _I, _I, _I, _I, _P, _I, _I, _I, _F, _P, _P],
    "mia_warp_affine_axis": [_P, _I, _I, _I, _I, _P, _I, _I, _I, _F, _P,
                             _P],
    "mia_warp_affine_axis_ratio": [_P, _I, _I, _I, _I, _P, _I, _I, _I, _F,
                                   _P, _F, _P],
    "mia_warp_disp": [_P, _I, _I, _I, _I, _P, _I, _I, _I, _F, _P, _P, _P,
                      _P, _I, _P],
    "mia_warp_affine_shear": [_P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I,
                              _F, _P, _P]}


def bind_warp_library(lib):
    """Set the return and argument types of each WARP_ENTRIES entry point
    that the loaded warp library ``lib`` has (a build of an older
    csrc/warp.cu may lack some); returns ``lib``."""
    for name, argtypes in WARP_ENTRIES.items():
        entry = getattr(lib, name, None)
        if entry is not None:
            entry.restype = _I
            entry.argtypes = argtypes
    return lib


@functools.lru_cache(maxsize=None)
def load_warp_library():
    """The warp kernels' ctypes handle, built on first use."""
    path, _ = build_library("warp")
    return bind_warp_library(ctypes.CDLL(str(path)))


@functools.lru_cache(maxsize=None)
def load_hist_library():
    """The dose-histogram kernel's ctypes handle, built on first use."""
    path, _ = build_library("hist")
    lib = ctypes.CDLL(str(path))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mia_dose_hist.restype = i
    lib.mia_dose_hist.argtypes = [p, p, i64, p, p, i, p, p, p]
    return lib


@functools.lru_cache(maxsize=None)
def load_lane_interp_library():
    """The per-row linear interpolation kernel's ctypes handle, built on
    first use."""
    path, _ = build_library("lane_interp")
    lib = ctypes.CDLL(str(path))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mia_lane_interp.restype = i
    lib.mia_lane_interp.argtypes = [p, p, i64, i, i, p, p]
    return lib
