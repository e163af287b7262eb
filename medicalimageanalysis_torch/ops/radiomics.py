"""Radiomics feature extraction: IBSI / pyradiomics-family panels.

Port of medicalimageanalysis_tpu/ops/radiomics.py. The texture matrices
are counted on the device: for each of the 13 directions the neighbour
level and validity come from slicing into preallocated tensors (no pad
+ slice chains), run lengths by log-doubling of trailing same-level
counts, dependence and neighbourhood sums over the 26-stencil; every
count is a ``torch.bincount`` of packed (pair, row, column) keys, so
the counts are exact integers, equal to the JAX package's one-hot
contractions below 2^24. The float sums of NGTDM (``ngtdm_s``) accumulate
in float64 (the JAX package sums float32 in its own order: about 1e-6
relative apart). The matrices come back to the host, where the formulas
run in float64, verbatim from the JAX package: first order, shape (on the
port's ``marching_cubes_mask`` and ``TriMesh``), GLCM, GLRLM, GLSZM
(scipy's labelling on the host, as there), GLDM and NGTDM.

Families (names follow pyradiomics, definitions follow IBSI):
``firstorder`` (19), ``shape`` (14), ``glcm`` (24, 13 symmetric 3-D
directions averaged), ``glrlm`` (16), ``glszm`` (16), ``gldm`` (14),
``ngtdm`` (5). Discretisation per IBSI: ``bin_width`` (fixed size,
anchored at the ROI minimum) or ``n_bins`` (fixed count). Gray levels are
1-based in every formula.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import default_device

__all__ = ["compute_radiomics", "discretize", "texture_matrices",
           "first_order_features", "shape_features", "glcm_features",
           "glrlm_features", "glszm_features", "gldm_features",
           "ngtdm_features", "DIRECTIONS_13"]

# the 13 unique 3-D directions of the 26-neighbourhood (each axis pair
# counted once; the opposite directions are covered by symmetry)
DIRECTIONS_13 = (
    (0, 0, 1), (0, 1, 0), (1, 0, 0),
    (0, 1, 1), (0, 1, -1), (1, 0, 1), (1, 0, -1), (1, 1, 0), (1, -1, 0),
    (1, 1, 1), (1, 1, -1), (1, -1, 1), (1, -1, -1),
)

_EPS = 2.2e-16  # pyradiomics' log guard


def _offsets_26():
    out = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz or dy or dx:
                    out.append((dz, dy, dx))
    return tuple(out)


def _shift(a, d, fill):
    """out[..., v] = a[..., v - d] over the last three axes for the static
    offset d = (dz, dy, dx); reads from outside become ``fill``. One
    preallocated tensor and one sliced copy."""
    out = torch.full_like(a, fill)
    dst, src = [], []
    for s, n in zip(d, a.shape[-3:]):
        if abs(s) >= n:
            return out
        dst.append(slice(s, n) if s >= 0 else slice(0, n + s))
        src.append(slice(0, n - s) if s >= 0 else slice(-s, n))
    out[(Ellipsis, *dst)] = a[(Ellipsis, *src)]
    return out


def _count(a, b, w, Na, Nb):
    """Per lane b of the batch: counts of the pairs (a[v], b[v]) over the
    voxels with ``w`` (bool), pairs outside [0, Na) x [0, Nb) dropped ->
    (B, Na, Nb) int64, by one bincount of packed keys."""
    B = a.shape[0]
    lane = torch.arange(B, device=a.device).reshape(
        (B,) + (1,) * (a.dim() - 1))
    ok = w & (a >= 0) & (a < Na) & (b >= 0) & (b < Nb)
    key = ((lane * Na + a) * Nb + b)[ok]
    return torch.bincount(key, minlength=B * Na * Nb).reshape(B, Na, Nb)


def _weighted_count(a, w, values, Na):
    """Per lane: the float64 sums of ``values`` over the voxels with
    ``w``, by level a in [0, Na) -> (B, Na)."""
    B = a.shape[0]
    lane = torch.arange(B, device=a.device).reshape(
        (B,) + (1,) * (a.dim() - 1))
    ok = w & (a >= 0) & (a < Na)
    key = (lane * Na + a)[ok]
    out = torch.zeros(B * Na, dtype=torch.float64, device=a.device)
    out.index_add_(0, key, values[ok].to(torch.float64))
    return out.reshape(B, Na)


def _trailing_run(t, d, lmax):
    """cnt[v] = length of the run of True values of ``t`` ending at v,
    walking backwards along d (t[v], t[v-d], ...); log-doubling with
    static shifts: after each step cnt == min(true count, cap)."""
    c = t.to(torch.int32)
    m = 1
    while m < lmax:
        sh = _shift(c, tuple(x * m for x in d), 0)
        c = torch.where(c == m, m + sh, c)
        m *= 2
    return c


@torch.no_grad()
def _texture_matrices(lev, valid, Ng, Lmax, alpha):
    """All device-countable texture matrices of the lanes (B, Z, Y, X)
    (JAX ops/radiomics.py:140-191). lev: int 0-based gray levels (ignored
    wherever ``valid`` is False); valid: bool ROI masks. Returns int64
    counts glcm (B, 13, Ng, Ng) symmetric, glrlm (B, 13, Ng, Lmax), gldm
    (B, Ng, 27), ngtdm_n (B, Ng), hist (B, Ng), and the float64 sums
    ngtdm_s (B, Ng)."""
    lev = lev.to(torch.int64)
    valid = valid.to(torch.bool)
    lev_m = torch.where(valid, lev, torch.full_like(lev, -1))
    glcm, glrlm = [], []
    for d in DIRECTIONS_13:
        lev_n = _shift(lev_m, d, -2)      # distinct sentinel: pads never
        valid_n = _shift(valid, d, False)  # pair with real voxels
        pair_ok = valid & valid_n
        c = _count(lev, lev_n, pair_ok, Ng, Ng)
        glcm.append(c + c.transpose(1, 2))
        same_prev = pair_ok & (lev_m == lev_n)
        cnt = _trailing_run(same_prev, d, Lmax).to(torch.int64)
        same_next = _shift(same_prev, tuple(-x for x in d), False)
        ends = valid & ~same_next
        glrlm.append(_count(lev, cnt, ends, Ng, Lmax))
        del lev_n, valid_n, pair_ok, same_prev, cnt, same_next, ends

    # GLDM dependence + NGTDM neighbourhood over the 26-stencil
    dep = torch.zeros_like(lev)
    nsum = torch.zeros(lev.shape, dtype=torch.float32, device=lev.device)
    ncount = torch.zeros(lev.shape, dtype=torch.float32, device=lev.device)
    for d in _offsets_26():
        lev_n = _shift(lev_m, d, -2)
        valid_n = _shift(valid, d, False)
        dep += (valid_n & (torch.abs(lev_n - lev_m) <= alpha))
        nsum += torch.where(valid_n, lev_n.to(torch.float32) + 1.0,
                            torch.zeros_like(nsum))
        ncount += valid_n
    gldm = _count(lev, dep, valid, Ng, 27)
    # NGTDM: gray values are 1-based; voxels with no valid neighbour are
    # left out (pyradiomics: A_i defined over present neighbours)
    has_nb = valid & (ncount > 0)
    abar = nsum / torch.clamp(ncount, min=1.0)
    diff = torch.abs(lev.to(torch.float32) + 1.0 - abar)
    zero = torch.zeros_like(lev)
    return {"glcm": torch.stack(glcm, 1), "glrlm": torch.stack(glrlm, 1),
            "gldm": gldm,
            "ngtdm_s": _weighted_count(lev, has_nb, diff, Ng),
            "ngtdm_n": _count(lev, zero, has_nb, Ng, 1)[..., 0],
            "hist": _count(lev, zero, valid, Ng, 1)[..., 0]}


def _as_lanes(a, dtype, device):
    t = torch.as_tensor(np.asarray(a), device=device).to(dtype)
    return t[None] if t.dim() == 3 else t


def texture_matrices(levels, mask, Ng, Lmax=None, alpha=0, device=None):
    """Texture matrices of one (Z, Y, X) level volume under its ROI mask,
    counted on ``device`` (default: ``default_device()``), as float64
    numpy: glcm (13, Ng, Ng), glrlm (13, Ng, Lmax), gldm (Ng, 27),
    ngtdm_s / ngtdm_n (Ng,), hist (Ng,)."""
    device = default_device() if device is None else torch.device(device)
    levels = np.asarray(levels)
    if Lmax is None:
        Lmax = max(levels.shape)
    out = _texture_matrices(_as_lanes(levels, torch.int64, device),
                            _as_lanes(np.asarray(mask) > 0, torch.bool,
                                      device),
                            int(Ng), int(Lmax), int(alpha))
    return {k: v[0].cpu().numpy().astype(np.float64) for k, v in out.items()}


def discretize(values, mask, bin_width=None, n_bins=None):
    """IBSI discretization to 0-based integer levels + the level count.

    ``bin_width``: fixed bin size anchored at the ROI minimum
    (floor((x - min)/w); the IBSI FBS recommendation for calibrated
    units like HU/SUV). ``n_bins``: fixed bin count over the ROI range
    (equal-width; constant ROIs collapse to one level). Exactly one
    must be given. Returns (levels int32 ndarray, Ng).
    """
    if (bin_width is None) == (n_bins is None):
        raise ValueError("discretize: give exactly one of bin_width / "
                         "n_bins")
    vals = np.asarray(values, np.float64)
    m = np.asarray(mask) > 0
    if not m.any():
        return np.zeros(vals.shape, np.int32), 1
    inside = vals[m]
    vmin = float(inside.min())
    vmax = float(inside.max())
    if bin_width is not None:
        w = float(bin_width)
        if w <= 0:
            raise ValueError("discretize: bin_width must be positive")
        lev = np.floor((vals - vmin) / w).astype(np.int32)
        ng = int(np.floor((vmax - vmin) / w)) + 1
    else:
        ng = int(n_bins)
        if ng < 1:
            raise ValueError("discretize: n_bins must be >= 1")
        if vmax == vmin:
            return np.zeros(vals.shape, np.int32), 1
        lev = np.minimum(
            np.floor((vals - vmin) / (vmax - vmin) * ng), ng - 1
        ).astype(np.int32)
    return np.clip(lev, 0, ng - 1), ng


# ---------------------------------------------------------------- #
# feature formulas (host float64, tiny inputs)                      #
# ---------------------------------------------------------------- #

def first_order_features(values, mask, spacing, hist=None):
    """19 first-order features (pyradiomics names; Kurtosis is NOT
    excess-kurtosis — no -3, matching pyradiomics). ``hist`` is the
    discretized in-ROI histogram used for Entropy/Uniformity; when
    None those two come back NaN."""
    vals = np.asarray(values, np.float64)
    m = np.asarray(mask) > 0
    x = vals[m]
    n = x.size
    vox = float(np.prod(np.asarray(spacing, np.float64)))
    if n == 0:
        keys = ["Energy", "TotalEnergy", "Entropy", "Minimum",
                "10Percentile", "90Percentile", "Maximum", "Mean",
                "Median", "InterquartileRange", "Range",
                "MeanAbsoluteDeviation", "RobustMeanAbsoluteDeviation",
                "RootMeanSquared", "StandardDeviation", "Skewness",
                "Kurtosis", "Variance", "Uniformity"]
        return {k: float("nan") for k in keys}
    mean = x.mean()
    var = x.var()
    std = np.sqrt(var)
    m2 = var
    m3 = np.mean((x - mean) ** 3)
    m4 = np.mean((x - mean) ** 4)
    p10, p25, p75, p90 = np.percentile(x, [10, 25, 75, 90])
    robust = x[(x >= p10) & (x <= p90)]
    energy = float(np.sum(x * x))
    out = {
        "Energy": energy,
        "TotalEnergy": vox * energy,
        "Entropy": float("nan"),
        "Minimum": float(x.min()),
        "10Percentile": float(p10),
        "90Percentile": float(p90),
        "Maximum": float(x.max()),
        "Mean": float(mean),
        "Median": float(np.median(x)),
        "InterquartileRange": float(p75 - p25),
        "Range": float(x.max() - x.min()),
        "MeanAbsoluteDeviation": float(np.mean(np.abs(x - mean))),
        "RobustMeanAbsoluteDeviation": float(
            np.mean(np.abs(robust - robust.mean()))
            if robust.size else np.nan),
        "RootMeanSquared": float(np.sqrt(np.mean(x * x))),
        "StandardDeviation": float(std),
        "Skewness": float(m3 / std ** 3) if std > 0 else 0.0,
        "Kurtosis": float(m4 / m2 ** 2) if m2 > 0 else 0.0,
        "Variance": float(var),
        "Uniformity": float("nan"),
    }
    if hist is not None:
        p = np.asarray(hist, np.float64)
        p = p[p > 0]
        p = p / p.sum()
        out["Entropy"] = float(-np.sum(p * np.log2(p)))
        out["Uniformity"] = float(np.sum(p * p))
    return out


def shape_features(mask, spacing, device=None):
    """14 shape features from the port's marching-cubes mesh (table path
    on ``device``, padded 1 voxel so surfaces close at the array edge)
    + the voxel-center PCA axes. spacing = [sx, sy, sz] mm."""
    from .marching_cubes import marching_cubes_mask

    m = np.asarray(mask) > 0
    sp = np.asarray(spacing, np.float64).reshape(-1)
    vox = float(np.prod(sp))
    n = int(m.sum())
    keys = ["MeshVolume", "VoxelVolume", "SurfaceArea",
            "SurfaceVolumeRatio", "Sphericity", "Maximum3DDiameter",
            "Maximum2DDiameterSlice", "Maximum2DDiameterColumn",
            "Maximum2DDiameterRow", "MajorAxisLength",
            "MinorAxisLength", "LeastAxisLength", "Elongation",
            "Flatness"]
    if n == 0:
        return {k: float("nan") for k in keys}
    # pads internally, shifts back
    mesh = marching_cubes_mask(m, device=device)
    pts = np.asarray(mesh.points, np.float64)  # pixel units, (x, y, z)
    pts = pts * sp[None, :]                    # to mm
    from ..utils.mesh.trimesh import TriMesh
    mesh_mm = TriMesh(pts, np.asarray(mesh.faces))
    vol = float(mesh_mm.volume)
    area = float(mesh_mm.area)

    zz, yy, xx = np.nonzero(m)
    coords = np.stack([xx * sp[0], yy * sp[1], zz * sp[2]], axis=1)

    def _max_diam(p2d):
        if p2d.shape[0] < 2:
            return 0.0
        q = p2d
        if q.shape[0] > 64:
            try:  # hull prunes the O(n^2) pair scan
                from scipy.spatial import ConvexHull
                uq = np.unique(q, axis=0)
                if uq.shape[0] > q.shape[1]:
                    q = uq[ConvexHull(uq, qhull_options="QJ").vertices]
            except Exception:
                pass
        d2 = np.sum((q[:, None, :] - q[None, :, :]) ** 2, axis=-1)
        return float(np.sqrt(d2.max()))

    # surface-voxel centers stand in for mesh vertices (same voxel
    # resolution, hull-pruned exact pair scan)
    from scipy import ndimage
    surf = m & ~ndimage.binary_erosion(m)
    sz, sy, sx = np.nonzero(surf)
    spts = np.stack([sx * sp[0], sy * sp[1], sz * sp[2]], axis=1)
    max3d = _max_diam(spts)

    def _planar(keep_axes, slice_idx):
        best = 0.0
        for s in np.unique(slice_idx):
            sel = slice_idx == s
            best = max(best, _max_diam(spts[sel][:, keep_axes]))
        return best

    max_slice = _planar([0, 1], sz)    # in-plane (x, y) per z
    max_col = _planar([0, 2], sy)      # (x, z) per y
    max_row = _planar([1, 2], sx)      # (y, z) per x

    centered = coords - coords.mean(axis=0)
    if n > 1:
        cov = centered.T @ centered / n
        lam = np.sort(np.linalg.eigvalsh(cov))[::-1]
        lam = np.maximum(lam, 0.0)
    else:
        lam = np.zeros(3)
    major, minor, least = (4.0 * np.sqrt(lam)).tolist()
    return {
        "MeshVolume": vol,
        "VoxelVolume": n * vox,
        "SurfaceArea": area,
        "SurfaceVolumeRatio": area / vol if vol > 0 else float("nan"),
        "Sphericity": ((36.0 * np.pi * vol * vol) ** (1.0 / 3.0) / area
                       if area > 0 else float("nan")),
        "Maximum3DDiameter": max3d,
        "Maximum2DDiameterSlice": max_slice,
        "Maximum2DDiameterColumn": max_col,
        "Maximum2DDiameterRow": max_row,
        "MajorAxisLength": major,
        "MinorAxisLength": minor,
        "LeastAxisLength": least,
        "Elongation": (np.sqrt(lam[1] / lam[0]) if lam[0] > 0
                       else float("nan")),
        "Flatness": (np.sqrt(lam[2] / lam[0]) if lam[0] > 0
                     else float("nan")),
    }


def glcm_features(glcm):
    """24 GLCM features averaged over the leading direction axis.
    glcm: (D, Ng, Ng) symmetric counts."""
    P = np.asarray(glcm, np.float64)
    if P.ndim == 2:
        P = P[None]
    D, Ng, _ = P.shape
    tot = P.sum(axis=(1, 2), keepdims=True)
    p = P / np.maximum(tot, _EPS)
    i = np.arange(1, Ng + 1, dtype=np.float64)
    ii = i[None, :, None]
    jj = i[None, None, :]
    px = p.sum(axis=2)                    # (D, Ng)
    mu = (px * i[None, :]).sum(axis=1)    # symmetric: mux == muy
    sig2 = (px * (i[None, :] - mu[:, None]) ** 2).sum(axis=1)
    sig = np.sqrt(sig2)
    # anti/diagonal marginals
    kk_plus = np.arange(2, 2 * Ng + 1, dtype=np.float64)
    kk_minus = np.arange(0, Ng, dtype=np.float64)
    p_plus = np.zeros((D, 2 * Ng - 1))
    p_minus = np.zeros((D, Ng))
    sums = (ii + jj - 2).astype(int)      # 0 .. 2Ng-2
    diffs = np.abs(ii - jj).astype(int)   # 0 .. Ng-1
    for d in range(D):
        np.add.at(p_plus[d], sums[0].ravel(), p[d].ravel())
        np.add.at(p_minus[d], diffs[0].ravel(), p[d].ravel())
    da = (p_minus * kk_minus[None, :]).sum(axis=1)
    idm_core = ii - jj
    hxy = -np.sum(p * np.log2(p + _EPS), axis=(1, 2))
    px_py = px[:, :, None] * px[:, None, :]
    hxy1 = -np.sum(p * np.log2(px_py + _EPS), axis=(1, 2))
    hxy2 = -np.sum(px_py * np.log2(px_py + _EPS), axis=(1, 2))
    hx = -np.sum(px * np.log2(px + _EPS), axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = (np.sum(ii * jj * p, axis=(1, 2)) - mu * mu) / (sig * sig)
        imc1 = (hxy - hxy1) / np.maximum(hx, _EPS)
        imc2 = np.sqrt(np.maximum(1.0 - np.exp(-2.0 * (hxy2 - hxy)),
                                  0.0))
        inv_var = np.where(
            idm_core == 0, 0.0,
            p / np.where(idm_core == 0, 1.0, idm_core ** 2)
        ).sum(axis=(1, 2))
    feats = {
        "Autocorrelation": np.sum(ii * jj * p, axis=(1, 2)),
        "JointAverage": mu,
        "ClusterProminence": np.sum(
            (ii + jj - 2 * mu[:, None, None]) ** 4 * p, axis=(1, 2)),
        "ClusterShade": np.sum(
            (ii + jj - 2 * mu[:, None, None]) ** 3 * p, axis=(1, 2)),
        "ClusterTendency": np.sum(
            (ii + jj - 2 * mu[:, None, None]) ** 2 * p, axis=(1, 2)),
        "Contrast": np.sum((ii - jj) ** 2 * p, axis=(1, 2)),
        "Correlation": np.where(sig2 > 0, corr, 1.0),
        "DifferenceAverage": da,
        "DifferenceEntropy": -np.sum(
            p_minus * np.log2(p_minus + _EPS), axis=1),
        "DifferenceVariance": np.sum(
            (kk_minus[None, :] - da[:, None]) ** 2 * p_minus, axis=1),
        "JointEnergy": np.sum(p * p, axis=(1, 2)),
        "JointEntropy": hxy,
        "Imc1": imc1,
        "Imc2": imc2,
        "Idm": np.sum(p / (1.0 + (ii - jj) ** 2), axis=(1, 2)),
        "Idmn": np.sum(p / (1.0 + ((ii - jj) / Ng) ** 2), axis=(1, 2)),
        "Id": np.sum(p / (1.0 + np.abs(ii - jj)), axis=(1, 2)),
        "Idn": np.sum(p / (1.0 + np.abs(ii - jj) / Ng), axis=(1, 2)),
        "InverseVariance": inv_var,
        "MaximumProbability": p.max(axis=(1, 2)),
        "SumAverage": (p_plus * kk_plus[None, :]).sum(axis=1),
        "SumEntropy": -np.sum(p_plus * np.log2(p_plus + _EPS), axis=1),
        "SumSquares": np.sum(
            (ii - mu[:, None, None]) ** 2 * p, axis=(1, 2)),
    }
    # empty directions (no valid pairs) are excluded from the average
    ok = tot[:, 0, 0] > 0
    return {k: float(np.mean(v[ok])) if ok.any() else float("nan")
            for k, v in feats.items()}


def _rlm_style_features(P, n_vox, prefix_pairs):
    """Shared GLRLM/GLSZM formula set. P: (Ng, L) counts with gray
    level i (1-based rows) and size/length j (1-based cols)."""
    P = np.asarray(P, np.float64)
    Ng, L = P.shape
    nr = P.sum()
    if nr <= 0:
        return None
    i = np.arange(1, Ng + 1, dtype=np.float64)[:, None]
    j = np.arange(1, L + 1, dtype=np.float64)[None, :]
    p = P / nr
    ri = P.sum(axis=1)
    rj = P.sum(axis=0)
    mu_i = (p * i).sum()
    mu_j = (p * j).sum()
    (k_se, k_le, k_gln, k_glnn, k_ln, k_lnn, k_pct, k_glv, k_lv,
     k_ent, k_lgl, k_hgl, k_sl, k_sh, k_ll, k_lh) = prefix_pairs
    return {
        k_se: float((P / j ** 2).sum() / nr),
        k_le: float((P * j ** 2).sum() / nr),
        k_gln: float((ri ** 2).sum() / nr),
        k_glnn: float((ri ** 2).sum() / nr ** 2),
        k_ln: float((rj ** 2).sum() / nr),
        k_lnn: float((rj ** 2).sum() / nr ** 2),
        k_pct: float(nr / n_vox) if n_vox > 0 else float("nan"),
        k_glv: float((p * (i - mu_i) ** 2).sum()),
        k_lv: float((p * (j - mu_j) ** 2).sum()),
        k_ent: float(-np.sum(p * np.log2(p + _EPS))),
        k_lgl: float((P / i ** 2).sum() / nr),
        k_hgl: float((P * i ** 2).sum() / nr),
        k_sl: float((P / (i ** 2 * j ** 2)).sum() / nr),
        k_sh: float((P * i ** 2 / j ** 2).sum() / nr),
        k_ll: float((P * j ** 2 / i ** 2).sum() / nr),
        k_lh: float((P * i ** 2 * j ** 2).sum() / nr),
    }


_GLRLM_KEYS = ("ShortRunEmphasis", "LongRunEmphasis",
               "GrayLevelNonUniformity",
               "GrayLevelNonUniformityNormalized",
               "RunLengthNonUniformity",
               "RunLengthNonUniformityNormalized", "RunPercentage",
               "GrayLevelVariance", "RunVariance", "RunEntropy",
               "LowGrayLevelRunEmphasis", "HighGrayLevelRunEmphasis",
               "ShortRunLowGrayLevelEmphasis",
               "ShortRunHighGrayLevelEmphasis",
               "LongRunLowGrayLevelEmphasis",
               "LongRunHighGrayLevelEmphasis")

_GLSZM_KEYS = ("SmallAreaEmphasis", "LargeAreaEmphasis",
               "GrayLevelNonUniformity",
               "GrayLevelNonUniformityNormalized",
               "SizeZoneNonUniformity",
               "SizeZoneNonUniformityNormalized", "ZonePercentage",
               "GrayLevelVariance", "ZoneVariance", "ZoneEntropy",
               "LowGrayLevelZoneEmphasis", "HighGrayLevelZoneEmphasis",
               "SmallAreaLowGrayLevelEmphasis",
               "SmallAreaHighGrayLevelEmphasis",
               "LargeAreaLowGrayLevelEmphasis",
               "LargeAreaHighGrayLevelEmphasis")


def glrlm_features(glrlm, n_vox):
    """16 run-length features averaged over the direction axis.
    glrlm: (D, Ng, Lmax) counts."""
    P = np.asarray(glrlm, np.float64)
    if P.ndim == 2:
        P = P[None]
    per_dir = [
        _rlm_style_features(P[d], n_vox, _GLRLM_KEYS)
        for d in range(P.shape[0])
    ]
    per_dir = [f for f in per_dir if f is not None]
    if not per_dir:
        return {k: float("nan") for k in _GLRLM_KEYS}
    return {k: float(np.mean([f[k] for f in per_dir]))
            for k in _GLRLM_KEYS}


def glszm_matrix(levels, mask, Ng, connectivity=26):
    """Zone-size matrix on host: per gray level, 26-connected zones
    via scipy.ndimage.label (labeling is inherently sequential —
    host is the right processor; the matrix is tiny). Returns
    (Ng, max_zone) float64 counts."""
    from scipy import ndimage

    lev = np.asarray(levels)
    m = np.asarray(mask) > 0
    struct = (np.ones((3, 3, 3), bool) if connectivity == 26
              else ndimage.generate_binary_structure(3, 1))
    per_level = []
    max_zone = 1
    for g in range(Ng):
        sel = m & (lev == g)
        if not sel.any():
            per_level.append({})
            continue
        lab, n = ndimage.label(sel, structure=struct)
        sizes = np.bincount(lab.ravel())[1:]
        cnt = {}
        for s in sizes:
            cnt[int(s)] = cnt.get(int(s), 0) + 1
        per_level.append(cnt)
        max_zone = max(max_zone, int(sizes.max()))
    P = np.zeros((Ng, max_zone), np.float64)
    for g, cnt in enumerate(per_level):
        for s, c in cnt.items():
            P[g, s - 1] = c
    return P


def glszm_features(P, n_vox):
    """16 zone-size features. P: (Ng, max_zone) counts."""
    out = _rlm_style_features(P, n_vox, _GLSZM_KEYS)
    if out is None:
        return {k: float("nan") for k in _GLSZM_KEYS}
    return out


def gldm_features(gldm, n_vox):
    """14 dependence features. gldm: (Ng, 27) counts where column d
    is the number of 26-neighbors within alpha; the dependence size
    j = d + 1 counts the center voxel (pyradiomics convention)."""
    P = np.asarray(gldm, np.float64)
    Ng, Nd = P.shape
    nz = P.sum()
    keys = ("SmallDependenceEmphasis", "LargeDependenceEmphasis",
            "GrayLevelNonUniformity", "DependenceNonUniformity",
            "DependenceNonUniformityNormalized", "GrayLevelVariance",
            "DependenceVariance", "DependenceEntropy",
            "LowGrayLevelEmphasis", "HighGrayLevelEmphasis",
            "SmallDependenceLowGrayLevelEmphasis",
            "SmallDependenceHighGrayLevelEmphasis",
            "LargeDependenceLowGrayLevelEmphasis",
            "LargeDependenceHighGrayLevelEmphasis")
    if nz <= 0:
        return {k: float("nan") for k in keys}
    i = np.arange(1, Ng + 1, dtype=np.float64)[:, None]
    j = np.arange(1, Nd + 1, dtype=np.float64)[None, :]
    p = P / nz
    mu_i = (p * i).sum()
    mu_j = (p * j).sum()
    return {
        "SmallDependenceEmphasis": float((P / j ** 2).sum() / nz),
        "LargeDependenceEmphasis": float((P * j ** 2).sum() / nz),
        "GrayLevelNonUniformity": float(
            (P.sum(axis=1) ** 2).sum() / nz),
        "DependenceNonUniformity": float(
            (P.sum(axis=0) ** 2).sum() / nz),
        "DependenceNonUniformityNormalized": float(
            (P.sum(axis=0) ** 2).sum() / nz ** 2),
        "GrayLevelVariance": float((p * (i - mu_i) ** 2).sum()),
        "DependenceVariance": float((p * (j - mu_j) ** 2).sum()),
        "DependenceEntropy": float(-np.sum(p * np.log2(p + _EPS))),
        "LowGrayLevelEmphasis": float((P / i ** 2).sum() / nz),
        "HighGrayLevelEmphasis": float((P * i ** 2).sum() / nz),
        "SmallDependenceLowGrayLevelEmphasis": float(
            (P / (i ** 2 * j ** 2)).sum() / nz),
        "SmallDependenceHighGrayLevelEmphasis": float(
            (P * i ** 2 / j ** 2).sum() / nz),
        "LargeDependenceLowGrayLevelEmphasis": float(
            (P * j ** 2 / i ** 2).sum() / nz),
        "LargeDependenceHighGrayLevelEmphasis": float(
            (P * i ** 2 * j ** 2).sum() / nz),
    }


def ngtdm_features(s, n):
    """5 NGTDM features. s[i] = summed |gray - neighborhood average|
    for level i; n[i] = voxel count at level i (both over voxels with
    at least one valid neighbor)."""
    s = np.asarray(s, np.float64)
    n = np.asarray(n, np.float64)
    nvp = n.sum()
    keys = ("Coarseness", "Contrast", "Busyness", "Complexity",
            "Strength")
    if nvp <= 0:
        return {k: float("nan") for k in keys}
    p = n / nvp
    present = p > 0
    i = np.arange(1, s.size + 1, dtype=np.float64)
    ngp = int(present.sum())
    ps = (p * s).sum()
    coarseness = 1.0 / ps if ps > 0 else 1e6  # pyradiomics cap
    ip, pp, sp_ = i[present], p[present], s[present]
    dif2 = (ip[:, None] - ip[None, :]) ** 2
    if ngp > 1:
        contrast = (float((pp[:, None] * pp[None, :] * dif2).sum())
                    / (ngp * (ngp - 1))) * (sp_.sum() / nvp)
    else:
        contrast = 0.0
    denom_b = np.abs(ip[:, None] * pp[:, None]
                     - ip[None, :] * pp[None, :]).sum()
    busyness = ps / denom_b if denom_b > 0 else 0.0
    pij = pp[:, None] + pp[None, :]
    complexity = float((np.abs(ip[:, None] - ip[None, :])
                        * (pp[:, None] * sp_[:, None]
                           + pp[None, :] * sp_[None, :]) / pij).sum()
                       ) / nvp
    strength = (float((pij * dif2).sum()) / sp_.sum()
                if sp_.sum() > 0 else 0.0)
    return {"Coarseness": coarseness, "Contrast": contrast,
            "Busyness": busyness, "Complexity": complexity,
            "Strength": strength}


ALL_FAMILIES = ("firstorder", "shape", "glcm", "glrlm", "glszm",
                "gldm", "ngtdm")


def _crop(vol, m):
    """The ROI's bounding box (lo, hi) and the volume and mask cropped to
    it; an empty mask crops to one voxel."""
    nz = np.nonzero(m)
    if nz[0].size == 0:
        lo = np.zeros(3, int)
        hi = np.ones(3, int)
    else:
        lo = np.array([a.min() for a in nz])
        hi = np.array([a.max() + 1 for a in nz])
    box = (slice(lo[0], hi[0]), slice(lo[1], hi[1]), slice(lo[2], hi[2]))
    return lo, hi, vol[box], m[box]


def _discretize(vol, m, bin_width, n_bins):
    if bin_width is not None:
        return discretize(vol, m, bin_width=bin_width)
    return discretize(vol, m, n_bins=n_bins)


def _panel(families, vol, m, sp, levels, ng, mats, n_vox, device):
    """The feature families of one ROI from its (cropped) volume, mask,
    levels and texture matrices (float64 numpy, or None when the ROI is
    empty or no family needs them)."""
    out = {}
    if "firstorder" in families:
        out["firstorder"] = first_order_features(
            vol, m, sp, hist=None if mats is None else mats["hist"])
    if "shape" in families:
        out["shape"] = shape_features(m, sp, device=device)
    if "glcm" in families:
        out["glcm"] = (glcm_features(mats["glcm"]) if mats is not None
                       else {k: float("nan")
                             for k in glcm_features(np.ones((1, 1, 1)))})
    if "glrlm" in families:
        out["glrlm"] = (glrlm_features(mats["glrlm"], n_vox)
                        if mats is not None
                        else {k: float("nan") for k in _GLRLM_KEYS})
    if "glszm" in families:
        out["glszm"] = (glszm_features(
            glszm_matrix(levels, m, ng), n_vox) if n_vox
            else {k: float("nan") for k in _GLSZM_KEYS})
    if "gldm" in families:
        out["gldm"] = (gldm_features(mats["gldm"], n_vox)
                       if mats is not None
                       else gldm_features(np.zeros((1, 27)), 0))
    if "ngtdm" in families:
        out["ngtdm"] = (ngtdm_features(mats["ngtdm_s"], mats["ngtdm_n"])
                        if mats is not None
                        else ngtdm_features(np.zeros(1), np.zeros(1)))
    return out


_TEXTURE_FAMILIES = ("glcm", "glrlm", "gldm", "ngtdm", "firstorder")


def compute_radiomics(volume, mask, spacing, bin_width=None, n_bins=32,
                      alpha=0, families=ALL_FAMILIES, device=None):
    """Full radiomics panel for one (volume, ROI mask) pair (JAX
    ops/radiomics.py:687-758).

    volume: (Z, Y, X) intensities (HU / SUV / anything calibrated);
    mask: same-shape ROI; spacing [sx, sy, sz] mm; discretisation by
    ``bin_width`` (IBSI FBS) or ``n_bins`` (FBN, default 32). The texture
    matrices are counted on ``device`` (default: ``default_device()``)
    over the ROI's bounding box; the formulas run in host float64.

    Returns {family: {feature: float}} plus ``meta`` (Ng, crop bounds,
    voxel count). An empty mask gives all-NaN panels.
    """
    device = default_device() if device is None else torch.device(device)
    vol = np.asarray(volume, np.float32)
    m = np.asarray(mask) > 0
    if vol.shape != m.shape or vol.ndim != 3:
        raise ValueError("compute_radiomics: expected matching "
                         f"(Z, Y, X), got {vol.shape} vs {m.shape}")
    sp = np.asarray(spacing, np.float64).reshape(-1)
    lo, hi, cvol, cm = _crop(vol, m)
    n_vox = int(cm.sum())
    levels, ng = _discretize(cvol, cm, bin_width, n_bins)
    mats = None
    if n_vox and any(f in families for f in _TEXTURE_FAMILIES):
        mats = texture_matrices(levels, cm, ng, alpha=alpha, device=device)
    out = _panel(families, cvol, cm, sp, levels, ng, mats, n_vox, device)
    out["meta"] = {"Ng": int(ng), "voxels": n_vox,
                   "crop_lo": lo.tolist(), "crop_hi": hi.tolist(),
                   "bin_width": bin_width,
                   "n_bins": None if bin_width is not None else n_bins}
    return out
