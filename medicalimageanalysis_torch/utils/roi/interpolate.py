"""Shape-based slice interpolation for sparsely-contoured ROIs.

Copied from medicalimageanalysis_tpu/utils/roi/interpolate.py (scipy on the
host, as there).

BEYOND-PARITY: clinicians routinely contour every other (or third)
slice; the reference carries such ROIs as-is, leaving gaps in masks,
meshes and DVH volumes. Classic shape-based interpolation (Raya &
Udupa 1990): per contoured slice build the signed distance field
(positive inside), linearly interpolate the fields across each gap,
and threshold at zero. Reduces to nearest-slice copy for identical
neighbors and morphs smoothly between differing shapes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["interpolate_mask_slices"]


def _signed_distance(slice_mask):
    from scipy import ndimage

    inside = slice_mask > 0
    if not inside.any():
        return np.full(slice_mask.shape, -np.inf, np.float32)
    if inside.all():
        return np.full(slice_mask.shape, np.inf, np.float32)
    d_out = ndimage.distance_transform_edt(inside)
    d_in = ndimage.distance_transform_edt(~inside)
    return (d_out - d_in).astype(np.float32)


def interpolate_mask_slices(mask, axis=0):
    """Fill all-empty slices along ``axis`` lying BETWEEN contoured
    ones by signed distance interpolation. Slices outside the
    contoured span and the contoured slices themselves are untouched.
    Returns a new uint8 mask of the input shape."""
    mask = np.asarray(mask)
    if axis:
        return np.moveaxis(
            interpolate_mask_slices(np.moveaxis(mask, axis, 0)),
            0, axis)
    out = (mask > 0).astype(np.uint8)
    filled = np.where(out.reshape(out.shape[0], -1).any(axis=1))[0]
    if filled.size < 2:
        return out

    from scipy import ndimage

    sdf_cache = {}

    def sdf(z):
        if z not in sdf_cache:
            sdf_cache[z] = _signed_distance(out[z])
        return sdf_cache[z]

    def centroid(z):
        ys, xs = np.nonzero(out[z])
        return np.array([ys.mean(), xs.mean()])

    for a, b in zip(filled[:-1], filled[1:]):
        if b - a <= 1:
            continue
        # centroid alignment: naive SDF averaging yields an empty
        # in-between for spatially disjoint neighbor shapes; shift
        # each field so its centroid rides the interpolated centroid
        # path, then blend (shape morphs AND translates)
        ca, cb = centroid(a), centroid(b)
        for z in range(a + 1, b):
            t = (z - a) / float(b - a)
            ct = (1.0 - t) * ca + t * cb
            fa = ndimage.shift(sdf(a), ct - ca, order=1,
                               mode="nearest")
            fb = ndimage.shift(sdf(b), ct - cb, order=1,
                               mode="nearest")
            out[z] = ((1.0 - t) * fa + t * fb > 0).astype(np.uint8)
    return out
