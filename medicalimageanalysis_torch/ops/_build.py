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


@functools.lru_cache(maxsize=None)
def load_warp_library():
    """The warp kernels' ctypes handle, built on first use."""
    path, _ = build_library("warp")
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mia_warp_coords.restype = i
    lib.mia_warp_coords.argtypes = [p, i, i, i, i, p, p, p, i, i, i, f,
                                    p, p, p, p, i, p]
    lib.mia_warp_affine.restype = i
    lib.mia_warp_affine.argtypes = [p, i, i, i, i, p, i, i, i, f, p, p]
    lib.mia_warp_disp.restype = i
    lib.mia_warp_disp.argtypes = [p, i, i, i, i, p, i, i, i, f, p, p, p, p,
                                  i, p]
    lib.mia_warp_affine_shear.restype = i
    lib.mia_warp_affine_shear.argtypes = [p, i, i, i, i, i, i, p, i, i, i, f,
                                          p, p]
    return lib


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
