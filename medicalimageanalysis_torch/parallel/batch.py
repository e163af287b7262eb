"""Batched cohort preprocess.

Port of medicalimageanalysis_tpu/parallel/batch.py:59-141
(``make_preprocess_fn``, ``preprocess_batch``): rescale -> FFS -> three
interpolation-matrix contractions -> three Gaussian contractions ->
external-threshold mask over a (B, Z, Y, X) batch. These are plain large
products outside any kernel, so they run as ``torch.einsum`` (cuBLAS on
the card, in full float32 under device.full_float32). The TPU's VMEM-cliff
sub-batching has no counterpart; ``chunk`` is kept as a no-op argument so
callers port line for line.
"""

from __future__ import annotations

import torch

from ..device import default_device, full_float32
from ..ops.filters import _gauss_kernel_matrix
from ..ops.resample import _interp_matrix

__all__ = ["make_preprocess_fn", "preprocess_batch"]


def make_preprocess_fn(in_shape, out_shape, ffs_op="ax_rot2",
                       threshold=-250.0, sigma_vox=1.0, chunk="auto",
                       device=None):
    """Build the preprocess step for fixed shapes on ``device``.

    raw (B, Z, Y, X) stored values + per-series slope/intercept (B,)
    tensors on ``device`` -> (volumes (B, oz, oy, ox) float32, masks
    uint8). ``chunk`` is accepted and ignored.
    """
    del chunk
    device = torch.device("cpu") if device is None else torch.device(device)
    Z, Y, X = in_shape
    if ffs_op in ("ax_rot1", "ax_rot3"):
        ry, rx = X, Y
    else:
        ry, rx = Y, X
    oz, oy, ox = out_shape

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    mz = dev(_interp_matrix(oz, Z, Z / oz))
    my = dev(_interp_matrix(oy, ry, ry / oy))
    mx = dev(_interp_matrix(ox, rx, rx / ox))
    gz = dev(_gauss_kernel_matrix(oz, sigma_vox))
    gy = dev(_gauss_kernel_matrix(oy, sigma_vox))
    gx = dev(_gauss_kernel_matrix(ox, sigma_vox))

    @full_float32()
    def step(raw, slope, intercept):
        vol = raw.to(torch.float32) * slope[:, None, None, None] \
            + intercept[:, None, None, None]
        if ffs_op == "ax_rot1":
            vol = torch.rot90(vol, 1, (2, 3))
        elif ffs_op == "ax_rot2":
            vol = torch.rot90(vol, 2, (2, 3))
        elif ffs_op == "ax_rot3":
            vol = torch.rot90(vol, 3, (2, 3))
        out = torch.einsum("ij,bjyx->biyx", mz, vol)
        out = torch.einsum("kj,bzjx->bzkx", my, out)
        out = torch.einsum("lj,bzyj->bzyl", mx, out)
        blurred = torch.einsum("ij,bjyx->biyx", gz, out)
        blurred = torch.einsum("kj,bzjx->bzkx", gy, blurred)
        blurred = torch.einsum("lj,bzyj->bzyl", gx, blurred)
        mask = (blurred > threshold).to(torch.uint8)
        return out, mask

    return step


def preprocess_batch(raw, slopes, intercepts, out_shape=(64, 256, 256),
                     ffs_op="none", device=None):
    """Host wrapper: run the preprocess over a numpy batch on ``device``
    (default: the card when present); returns device tensors."""
    from ..ops.volume import stored_to_float

    device = default_device() if device is None else torch.device(device)
    fn = make_preprocess_fn(raw.shape[1:], out_shape, ffs_op=ffs_op,
                            device=device)
    return fn(stored_to_float(raw, device),
              torch.as_tensor(slopes, dtype=torch.float32, device=device),
              torch.as_tensor(intercepts, dtype=torch.float32,
                              device=device))
