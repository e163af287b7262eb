"""ROI margin expansion/contraction and boolean combination.

Port of medicalimageanalysis_tpu/utils/roi/margin.py: PTV = CTV + margin,
ring structures, overlap resolution. Margins are exact anisotropic
Euclidean distances in mm (the EDT with the grid spacing as sampling;
per-axis margins rescale the sampling so the unit ball becomes the
requested ellipsoid). Negative margins contract by the same metric. The
default ``device`` backend runs the exact EDT (ops/edt.squared_edt) on
the ``device`` argument, else ``default_device()``; ``scipy`` runs on the
host.
"""

from __future__ import annotations

import numpy as np

__all__ = ["expand_mask", "combine_masks"]


def expand_mask(mask, spacing, margin_mm, backend="device", device=None):
    """Expand (margin > 0) or contract (margin < 0) a (Z, Y, X) mask by a
    Euclidean mm margin. ``spacing`` is [sx, sy, sz]; ``margin_mm`` is a
    scalar or per-axis [mx, my, mz] (the margin ellipsoid's semi-axes).
    Returns uint8 numpy.

    backend='device' (the default) runs the exact EDT on ``device``
    (default: ``default_device()``): the same semantics in float32
    distances, so a voxel landing exactly on the margin ellipsoid can
    tie-break differently from scipy's float64 (backend='scipy', on the
    host)."""
    mask = np.asarray(mask) > 0
    m = np.asarray(margin_mm, np.float64).reshape(-1)
    if m.size == 1:
        m = np.repeat(m, 3)
    if m.size != 3:
        raise ValueError("expand_mask: margin_mm must be a scalar or "
                         "[mx, my, mz]")
    if np.any(m > 0) and np.any(m < 0):
        raise ValueError("expand_mask: mixed-sign per-axis margins "
                         "are not supported (expand or contract)")
    if backend not in ("scipy", "device"):
        # validated before the early return, so a typo never succeeds
        raise ValueError(f"expand_mask: unknown backend {backend!r}")
    sx, sy, sz = (float(v) for v in spacing)
    sampling_zyx = np.array([sz, sy, sx], np.float64)
    scale = np.array([m[2], m[1], m[0]], np.float64)  # (z, y, x)

    if not m.any() or not mask.any():
        return mask.astype(np.uint8)

    def margin_sampling(sc):
        # sampling in margin units: a ZERO margin axis must be
        # prohibitively expensive (never crossed), not free
        eff = np.full(3, 1e12)
        nz = sc > 0
        eff[nz] = sampling_zyx[nz] / sc[nz]
        return eff

    if backend == "device":
        from ...ops.edt import squared_edt

        def dev_sampling(sc):
            # the zero-margin-axis penalty capped so its square stays
            # within float32 (1e6^2 a step: forbidden, finite)
            return np.minimum(margin_sampling(sc), 1e6)

        if np.all(m >= 0):
            eff = dev_sampling(scale)          # (z, y, x)
            d2 = squared_edt(mask, (eff[2], eff[1], eff[0]), device)
            return (d2 <= 1.0).cpu().numpy().astype(np.uint8)
        eff = dev_sampling(-scale)
        d2 = squared_edt(~mask, (eff[2], eff[1], eff[0]), device)
        return (d2 > 1.0).cpu().numpy().astype(np.uint8)

    from scipy import ndimage

    if np.all(m >= 0):
        # distance from the outside to the mask, in margin units
        d = ndimage.distance_transform_edt(
            ~mask, sampling=margin_sampling(scale))
        return (d <= 1.0).astype(np.uint8)
    # contraction: keep voxels deeper than the |margin| ellipsoid
    d = ndimage.distance_transform_edt(
        mask, sampling=margin_sampling(-scale))
    return (d > 1.0).astype(np.uint8)


def combine_masks(op, mask_a, mask_b):
    """Boolean combination: 'union' | 'intersect' | 'subtract' (a minus
    b) | 'xor'. Returns uint8."""
    a = np.asarray(mask_a) > 0
    b = np.asarray(mask_b) > 0
    if a.shape != b.shape:
        raise ValueError(f"combine_masks: shapes differ "
                         f"{a.shape} vs {b.shape}")
    if op == "union":
        out = a | b
    elif op == "intersect":
        out = a & b
    elif op == "subtract":
        out = a & ~b
    elif op == "xor":
        out = a ^ b
    else:
        raise ValueError(f"combine_masks: unknown op {op!r}")
    return out.astype(np.uint8)
