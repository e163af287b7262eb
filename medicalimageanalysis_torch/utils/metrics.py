"""Segmentation-comparison and registration-QA metrics.

Port of medicalimageanalysis_tpu/utils/metrics.py: TRE, Dice, Jaccard,
volumes, surface distances (boundary voxels + scipy's cKDTree, on the
host as in the JAX package), Hausdorff (with its percentile), ASSD,
surface Dice and ``compare_rois``, whose default ``backend="device"``
runs the exact-EDT panel (ops/edt.surface_metrics) on the image's device
(``backend="host"`` keeps the KD-tree panel).

Conventions: masks are array-ordered (z, y, x); ``spacing`` is
[sx, sy, sz] mm. All distances in mm.
"""

from __future__ import annotations

import numpy as np

__all__ = ["dice_coefficient", "jaccard_index", "volume_cc",
           "voxel_volume_cc",
           "surface_distances", "hausdorff_distance",
           "mean_surface_distance", "surface_dice", "compare_rois",
           "target_registration_error"]


def target_registration_error(points_a, points_b):
    """TRE between corresponding landmark sets ((N, 3) mm each, same
    order). Returns {'tre_mm': (N,), 'mean_mm', 'max_mm'}."""
    a = np.asarray(points_a, np.float64).reshape(-1, 3)
    b = np.asarray(points_b, np.float64).reshape(-1, 3)
    if a.shape != b.shape:
        raise ValueError("target_registration_error: point sets must "
                         f"pair up, got {a.shape} vs {b.shape}")
    d = np.linalg.norm(a - b, axis=1)
    return {"tre_mm": d, "mean_mm": float(d.mean()) if d.size else 0.0,
            "max_mm": float(d.max()) if d.size else 0.0}


def _as_bool(mask):
    m = np.asarray(mask)
    return m > 0 if m.dtype != bool else m


def dice_coefficient(mask_a, mask_b):
    """2|A∩B| / (|A|+|B|); 1.0 for two empty masks."""
    a, b = _as_bool(mask_a), _as_bool(mask_b)
    denom = int(a.sum()) + int(b.sum())
    if denom == 0:
        return 1.0
    return 2.0 * int((a & b).sum()) / denom


def jaccard_index(mask_a, mask_b):
    a, b = _as_bool(mask_a), _as_bool(mask_b)
    union = int((a | b).sum())
    if union == 0:
        return 1.0
    return int((a & b).sum()) / union


def voxel_volume_cc(spacing):
    """One voxel's volume in cc (spacing [sx, sy, sz] mm) — the single
    home of the mm3-to-cc conversion."""
    return float(np.prod(np.asarray(spacing, float))) / 1000.0


def volume_cc(mask, spacing):
    """Mask volume in cc (spacing [sx, sy, sz] mm)."""
    return float(_as_bool(mask).sum()) * voxel_volume_cc(spacing)


def _boundary_points_mm(mask, spacing):
    """Physical (x, y, z) mm coordinates of boundary voxels (mask minus
    its erosion), (N, 3); (0, 3) for an empty mask."""
    from scipy import ndimage

    m = _as_bool(mask)
    if not m.any():
        return np.zeros((0, 3))
    eroded = ndimage.binary_erosion(m)
    boundary = m & ~eroded
    idx = np.argwhere(boundary)  # (N, 3) in (z, y, x)
    sx, sy, sz = (float(v) for v in spacing)
    return idx[:, ::-1].astype(np.float64) * np.array([sx, sy, sz])


def surface_distances(mask_a, mask_b, spacing):
    """Directed NN distances (a->b, b->a) between boundary voxel
    centers, in mm. Raises on an empty mask (no surface exists)."""
    from scipy.spatial import cKDTree

    pa = _boundary_points_mm(mask_a, spacing)
    pb = _boundary_points_mm(mask_b, spacing)
    if pa.shape[0] == 0 or pb.shape[0] == 0:
        raise ValueError("surface_distances: empty mask has no surface")
    d_ab = cKDTree(pb).query(pa, workers=-1)[0]
    d_ba = cKDTree(pa).query(pb, workers=-1)[0]
    return d_ab, d_ba


def _hd(d_ab, d_ba, percentile):
    if percentile >= 100.0:
        return float(max(d_ab.max(), d_ba.max()))
    return float(max(np.percentile(d_ab, percentile),
                     np.percentile(d_ba, percentile)))


def _assd(d_ab, d_ba):
    return float((d_ab.sum() + d_ba.sum()) / (d_ab.size + d_ba.size))


def _sdice(d_ab, d_ba, tolerance_mm):
    hits = int((d_ab <= tolerance_mm).sum()) \
        + int((d_ba <= tolerance_mm).sum())
    return hits / (d_ab.size + d_ba.size)


def hausdorff_distance(mask_a, mask_b, spacing, percentile=100.0):
    """Symmetric (percentile-)Hausdorff distance in mm; HD95 is
    ``percentile=95``."""
    return _hd(*surface_distances(mask_a, mask_b, spacing), percentile)


def mean_surface_distance(mask_a, mask_b, spacing):
    """Average symmetric surface distance (ASSD) in mm."""
    return _assd(*surface_distances(mask_a, mask_b, spacing))


def surface_dice(mask_a, mask_b, spacing, tolerance_mm):
    """Normalized surface Dice at a tolerance (Nikolov et al. 2018): the
    fraction of both surfaces within ``tolerance_mm`` of the other."""
    return _sdice(*surface_distances(mask_a, mask_b, spacing),
                  tolerance_mm)


def compare_rois(image, name_a, name_b, tolerance_mm=2.0,
                 backend="device"):
    """Comparison panel for two ROIs on one image: Dice, Jaccard, HD,
    HD95, ASSD, surface Dice @tolerance, volumes.

    backend='device' (the default) computes the panel with the exact EDT
    (ops/edt.surface_metrics) on the image's device (the card unless the
    image was read elsewhere); backend='host' runs scipy's erosion and
    KD-tree on the CPU, as the JAX package's default does: the same
    numbers to float32 tolerance. For whole-cohort QA use
    parallel.batch.compare_masks_batch."""
    mask_a = np.asarray(image.rois[name_a].compute_mask())
    mask_b = np.asarray(image.rois[name_b].compute_mask())
    spacing = np.asarray(image.spacing, float)
    if backend == "device":
        from ..ops.edt import surface_metrics

        dev = surface_metrics(mask_a, mask_b, spacing, tolerance_mm,
                              device=getattr(image, "device", None))
        out = {k: float(dev[k]) for k in
               ("dice", "jaccard", "volume_a_cc", "volume_b_cc")}
        if _as_bool(mask_a).any() and _as_bool(mask_b).any():
            out["hausdorff_mm"] = float(dev["hausdorff_mm"])
            out["hd95_mm"] = float(dev["hd95_mm"])
            out["assd_mm"] = float(dev["assd_mm"])
            out[f"surface_dice@{tolerance_mm}mm"] = \
                float(dev["surface_dice"])
        return out
    if backend != "host":
        raise ValueError(f"compare_rois: unknown backend {backend!r}")
    out = {
        "dice": dice_coefficient(mask_a, mask_b),
        "jaccard": jaccard_index(mask_a, mask_b),
        "volume_a_cc": volume_cc(mask_a, spacing),
        "volume_b_cc": volume_cc(mask_b, spacing),
    }
    if _as_bool(mask_a).any() and _as_bool(mask_b).any():
        d_ab, d_ba = surface_distances(mask_a, mask_b, spacing)
        out["hausdorff_mm"] = _hd(d_ab, d_ba, 100.0)
        out["hd95_mm"] = _hd(d_ab, d_ba, 95.0)
        out["assd_mm"] = _assd(d_ab, d_ba)
        out[f"surface_dice@{tolerance_mm}mm"] = \
            _sdice(d_ab, d_ba, tolerance_mm)
    return out
