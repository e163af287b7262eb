"""Affine volume resampling.

Port of medicalimageanalysis_tpu/ops/resample.py (the parts on the
ingest -> registration -> reslice path):

- :func:`_trilinear` — the plain trilinear gather (the warp kernel's twin);
- :func:`affine_resample` — one 4x4 pixel matrix maps output voxel ->
  input voxel, run by the CUDA warp kernel in ``affine`` mode on the card;
- :func:`compose_pixel_matrix`, :func:`_interp_matrix` — numpy builders;
- :func:`separable_resample` — axis-aligned trilinear resample as three
  full-float32 matrix contractions (the demons pyramid);
- :func:`reslice_transform` — the vtkImageReslice(AutoCrop) equivalent
  behind ``Rigid.create_image``.

The TPU's tz=16 / axis-align / oblique dispatch in ``affine_resample``
has no counterpart: one affine kernel that reads global memory directly
serves every matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config
from ..device import full_float32
from . import geometry as geo
from .warp import affine_warp_fused, warp_coords_plain

__all__ = ["affine_resample", "compose_pixel_matrix", "reslice_transform",
           "separable_resample"]


def _trilinear(vol, coords_xyz, background):
    """vol: (Z, Y, X) f32 tensor; coords_xyz: (..., 3) in pixel (x, y, z)
    order -> (...) samples, background outside."""
    return warp_coords_plain(vol[None], coords_xyz[..., 2],
                             coords_xyz[..., 1], coords_xyz[..., 0],
                             background)[0][0]


def affine_resample(volume, pixel_matrix, out_shape, background=None,
                    device=None):
    """Resample through a single 4x4 *pixel-to-pixel* matrix.

    ``pixel_matrix`` maps output pixel (x, y, z, 1) -> input pixel
    (x, y, z); compose it with :func:`compose_pixel_matrix`. ``volume``
    (Z, Y, X) moves to ``device`` (default: where it already is) as
    float32; returns the (Zo, Yo, Xo) float32 tensor there.
    """
    if background is None:
        background = config.background_fill
    vol = torch.as_tensor(volume)
    if device is not None:
        vol = vol.to(device)
    return affine_warp_fused(vol, np.asarray(pixel_matrix, np.float32),
                             float(background), out_shape)


def compose_pixel_matrix(in_matrix, in_spacing, in_origin,
                         out_matrix, out_spacing, out_origin,
                         phys_transform=None):
    """Build the output-pixel -> input-pixel 4x4.

    A = P2Pix_in @ T_phys @ Pix2P_out, where T_phys maps output physical
    points into input physical space (identity when both grids live in
    the same frame of reference).
    """
    pix2p_out = geo.pixel_to_position_matrix(out_matrix, out_spacing,
                                             out_origin).astype(np.float64)
    p2pix_in = geo.position_to_pixel_matrix(in_matrix, in_spacing,
                                            in_origin).astype(np.float64)
    if phys_transform is None:
        return (p2pix_in @ pix2p_out).astype(np.float32)
    return (p2pix_in @ np.asarray(phys_transform, dtype=np.float64)
            @ pix2p_out).astype(np.float32)


def _interp_matrix(n_out, n_in, scale, offset=0.0, dtype=np.float32):
    """(n_out, n_in) row-stochastic linear interpolation matrix.

    Row i has weight (1-f) at floor(i*scale+offset) and f at +1 — a dense
    matmul replaces the gather for axis-aligned resampling.
    """
    src = np.arange(n_out, dtype=np.float64) * scale + offset
    src = np.clip(src, 0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (src - lo).astype(np.float64)
    m = np.zeros((n_out, n_in), dtype=np.float64)
    m[np.arange(n_out), lo] += 1 - f
    m[np.arange(n_out), hi] += f
    return m.astype(dtype)


@full_float32()
def _separable_apply(vol, mz, my, mx):
    out = torch.einsum("ij,jyx->iyx", mz, vol)
    out = torch.einsum("kj,zjx->zkx", my, out)
    return torch.einsum("lj,zyj->zyl", mx, out)


def separable_resample(volume, out_shape):
    """Axis-aligned trilinear resample as three matrix contractions, at
    the shape ratios (the JAX package's optional spacing ratios have no
    caller yet). volume (Z, Y, X) array or tensor -> float32 tensor on
    its device (the CPU for an array).
    """
    vol = torch.as_tensor(volume).to(torch.float32)
    mz, my, mx = (torch.as_tensor(_interp_matrix(int(o), i, i / int(o)),
                                  device=vol.device)
                  for o, i in zip(out_shape, vol.shape))
    return _separable_apply(vol, mz, my, mx)


def reslice_grid(vol_shape, vol_matrix, vol_spacing, vol_origin,
                 phys_transform, out_spacing):
    """Output grid of :func:`reslice_transform`: (pixel matrix A,
    out_shape (Z, Y, X), origin lo, dims (x, y, z))."""
    Z, Y, X = vol_shape
    T = np.asarray(phys_transform, dtype=np.float64)
    out_spacing = np.asarray(out_spacing, dtype=np.float64)
    pix2p = geo.pixel_to_position_matrix(vol_matrix, vol_spacing,
                                         vol_origin)
    corners_pix = np.array([[x, y, z] for z in (0, Z - 1)
                            for y in (0, Y - 1) for x in (0, X - 1)],
                           dtype=np.float64)
    corners_phys = geo.apply_homogeneous(corners_pix, pix2p)
    out_corners = geo.apply_homogeneous(corners_phys, np.linalg.inv(T))
    lo = out_corners.min(axis=0)
    hi = out_corners.max(axis=0)
    out_dims = np.maximum(
        np.round((hi - lo) / out_spacing).astype(int) + 1, 1)
    A = compose_pixel_matrix(vol_matrix, vol_spacing, vol_origin,
                             np.eye(3), out_spacing, lo,
                             phys_transform=T)
    out_shape = (int(out_dims[2]), int(out_dims[1]), int(out_dims[0]))
    return A, out_shape, lo, out_dims


def reslice_transform(volume, vol_matrix, vol_spacing, vol_origin,
                      phys_transform, out_spacing, background=None,
                      device=None):
    """vtkImageReslice(AutoCrop) behavioral equivalent with an arbitrary
    physical reslice transform: the output grid has identity direction and
    ``out_spacing``; output point p samples the input volume at
    ``phys_transform @ p``; the output extent covers the
    inverse-transformed input bounding box. The sample runs on
    ``device`` (default: the card when present).

    Returns dict(array (Z,Y,X) float32 numpy, origin, spacing, dimensions).
    """
    from ..device import default_device

    if background is None:
        background = config.background_fill
    volume = np.asarray(volume)
    A, out_shape, lo, out_dims = reslice_grid(
        volume.shape, vol_matrix, vol_spacing, vol_origin, phys_transform,
        out_spacing)
    device = default_device() if device is None else device
    arr = affine_resample(volume, A, out_shape, background, device=device)
    return {"array": arr.cpu().numpy(), "origin": lo,
            "spacing": np.asarray(out_spacing, dtype=np.float64),
            "dimensions": np.asarray(out_dims)}
