"""Device-side volume assembly.

Port of medicalimageanalysis_tpu/ops/volume.py. The raw slice stack moves
to the device once, in its stored 16-bit type, and rescale + output cast +
FFS reorientation run there as a few elementwise/relayout kernels. The
*decision* of which FFS op applies is host metadata work
(ops/geometry.ffs_decision); the *move* happens here.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["apply_ffs", "assemble_volume", "assemble_volume_numpy"]

_TORCH_DTYPE = {np.dtype(np.int16): torch.int16,
                np.dtype(np.float32): torch.float32}


def apply_ffs(array, op):
    """torch counterpart of geometry.apply_ffs_numpy on a (Z, Y, X) tensor."""
    if op == "none":
        return array
    if op == "ax_rot1":
        return torch.rot90(array, 1, (1, 2))
    if op == "ax_rot3":
        return torch.rot90(array, 3, (1, 2))
    if op == "ax_rot2":
        return torch.rot90(array, 2, (1, 2))
    if op == "cor_rot1":
        return torch.rot90(array, 1, (0, 1))
    if op == "sag_fix":
        return torch.rot90(array, 1, (0, 1)).permute(0, 2, 1).flip(2)
    raise ValueError(f"unknown ffs op {op!r}")


def stored_to_float(raw, device):
    """(..., R, C) numpy stored values -> float32 tensor on ``device``.

    The stack crosses the host->device link in its stored type; uint16
    and uint32 (RTDOSE) travel as their signed bit pattern and are
    widened on the device (torch's unsigned support is too thin to rely
    on). The widened integer rounds to float32 to nearest, ties to even,
    as XLA's ``astype(float32)`` does: uint32 values above 2^24 are not
    all representable."""
    raw = np.ascontiguousarray(raw)
    if not raw.flags.writeable:        # a decoded frame buffer: torch
        raw = raw.copy()               # wants memory it may own
    if raw.dtype == np.uint16:
        t = torch.from_numpy(raw.view(np.int16)).to(device)
        return t.to(torch.int32).bitwise_and_(0xFFFF).to(torch.float32)
    if raw.dtype == np.uint32:
        t = torch.from_numpy(raw.view(np.int32)).to(device)
        return t.to(torch.int64).bitwise_and_(0xFFFFFFFF).to(torch.float32)
    return torch.from_numpy(raw).to(device).to(torch.float32)


def assemble_volume(raw_slices, slopes, intercepts, ffs_op="none",
                    out_dtype=np.int16, device=None):
    """Rescale (slope/intercept) -> output dtype -> FFS reorientation.

    Parameters
    ----------
    raw_slices : (N, R, C) numpy array of stored pixel values
    slopes, intercepts : (N,) per-slice rescale
    ffs_op : op-code from geometry.ffs_decision
    device : where the assembly runs (default: ``default_device()``); the
        result is a contiguous tensor there
    """
    from ..device import default_device

    device = default_device() if device is None else torch.device(device)
    vol = stored_to_float(raw_slices, device)
    slope = torch.from_numpy(np.asarray(slopes, np.float32)).to(device)
    intercept = torch.from_numpy(
        np.asarray(intercepts, np.float32)).to(device)
    vol = vol * slope[:, None, None] + intercept[:, None, None]
    vol = vol.to(_TORCH_DTYPE[np.dtype(out_dtype)])
    return apply_ffs(vol, ffs_op).contiguous()


def assemble_volume_numpy(raw_slices, slopes, intercepts, ffs_op="none",
                          out_dtype=np.int16):
    """Pure-numpy twin of :func:`assemble_volume` on the host (the golden
    path of parity tests), bit-equal to the JAX package's: float32
    ``raw * slope + intercept`` rounded twice, then the cast and the FFS
    op (geometry.apply_ffs_numpy)."""
    from .geometry import apply_ffs_numpy

    slopes = np.asarray(slopes, dtype=np.float32)
    intercepts = np.asarray(intercepts, dtype=np.float32)
    raw = np.asarray(raw_slices)
    # integer fast path: slope 1 and one integral intercept on 16-bit
    # stored values is exact in the output type, and equal to the float32
    # round trip (float32 holds every 16-bit value exactly)
    if (raw.dtype in (np.int16, np.uint16)
            and np.all(slopes == 1.0)
            and np.all(intercepts == intercepts[0])
            and float(intercepts[0]).is_integer()):
        vol = raw.astype(out_dtype, copy=True)
        if intercepts[0]:
            vol += out_dtype(int(intercepts[0]))
        return np.ascontiguousarray(apply_ffs_numpy(vol, ffs_op))
    vol = (raw.astype(np.float32) * slopes[:, None, None]
           + intercepts[:, None, None]).astype(out_dtype)
    return np.ascontiguousarray(apply_ffs_numpy(vol, ffs_op))
