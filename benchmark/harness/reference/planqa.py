"""A plan check written plainly: ROI masks, the dose on the CT grid, DVH
goals and curves, and 3-D gamma.

- Masks follow the contract of the port's ``Image.compute_roi_masks``
  (the reference package's cv2.fillPoly + XOR loop): a contour's mm
  vertices go to pixels by the image's position-to-pixel map, are
  truncated (``trunc(v + 1e-6)``) and closed on the first vertex; a
  polygon fills the pixels whose centre has an odd number of edge
  crossings to its right and the pixels its edges pass through as cv2
  draws 8-connected lines (rounding halves down); polygons on one slice
  (``round`` of the pixel z) combine by XOR. A frozen copy of that
  arithmetic, in float64 on whole frames.
- The dose on the CT grid: trilinear at each CT voxel centre mapped into
  the dose grid, 0 Gy outside [0, n-1] on any axis.
- Goals (QUANTEC idiom): Dmax / Dmin / Dmean / Dmedian; Dp% the
  (100 - p)th percentile (linear); Dvcc the dose to the hottest
  round(v / voxel cc) voxels; VdGy the share (or cc) with dose >= d.
- DVH curve: at ``n_bins`` doses evenly from 0 to 1.05 x the ROI's
  maximum (+1e-6 Gy), 100 x (1 - the share of voxels below each).
- Gamma (Low 1998, global, TG-218 search): the evaluated dose resampled
  trilinearly onto a grid s times finer than the reference grid (s =
  ceil(spacing / (dta / 3)) an axis), padded by the search radius r =
  ceil(cap x dta / fine spacing); for each reference voxel the minimum
  over fine offsets within cap x dta of |d|^2 / dta^2 + (D_eval -
  D_ref)^2 / dD^2, dD = pct % of the reference maximum; its square root
  clamped at cap; the pass rate over voxels >= threshold % of that
  maximum.

``dtype`` float64 is the reference; bfloat16 is the control one step
below the configuration's float32 dose arithmetic (the masks keep their
integer contract).
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-3


def polygon_bitmap(verts, H, W, device):
    """verts (n + 1, 2) int closed chain -> (H, W) bool interior |
    boundary, in float64."""
    f = torch.as_tensor(verts, dtype=torch.float64, device=device)
    x1, y1 = f[:-1, 0, None], f[:-1, 1, None]
    x2, y2 = f[1:, 0, None], f[1:, 1, None]
    py = torch.arange(H, dtype=torch.float64, device=device)
    crosses = (y1 > py) != (y2 > py)
    denom = torch.where(y2 != y1, y2 - y1, torch.ones_like(y2))
    x_int = x1 + (py - y1) * (x2 - x1) / denom
    cross_bin = torch.where(crosses, torch.clamp(torch.ceil(x_int), 0, W),
                            torch.zeros_like(x_int)).long()
    dx, dy = x2 - x1, y2 - y1
    shallow = dx.abs() >= dy.abs()
    sdy = torch.where(dy != 0, dy, torch.ones_like(dy))
    t_m = x1 + (py - 0.5 - y1) * dx / sdy
    t_p = x1 + (py + 0.5 - y1) * dx / sdy
    lo_sl = torch.ceil(torch.minimum(t_m, t_p) + EPS)
    hi_sl = torch.floor(torch.maximum(t_m, t_p) + EPS)
    row = (py - y1).abs() < 0.5
    inf = torch.tensor(math.inf, dtype=torch.float64, device=device)
    lo_sh = torch.where(dy != 0, lo_sl, torch.where(row, -inf, inf))
    hi_sh = torch.where(dy != 0, hi_sl, torch.where(row, inf, -inf))
    lo_sh = torch.maximum(lo_sh, torch.minimum(x1, x2))
    hi_sh = torch.minimum(hi_sh, torch.maximum(x1, x2))
    xs = torch.floor(x1 + (py - y1) * dx / sdy + 0.5 - EPS)
    in_rows = (py >= torch.minimum(y1, y2)) & (py <= torch.maximum(y1, y2))
    lo = torch.where(shallow, lo_sh, torch.where(in_rows, xs, 1.0))
    hi = torch.where(shallow, hi_sh, torch.where(in_rows, xs, 0.0))
    ok = (hi >= lo) & (hi >= 0) & (lo <= W - 1)
    lo_c = torch.where(ok, torch.clamp(lo, 0, W), 0.0).long()
    hi_c = torch.where(ok, torch.clamp(hi + 1, 0, W + 1), 0.0).long()
    hist = torch.zeros((H, W + 1), dtype=torch.int64, device=device)
    hist.scatter_add_(1, cross_bin.T, torch.ones_like(cross_bin.T))
    below = torch.cumsum(hist, 1)
    interior = ((below[:, -1:] - below[:, :W]) % 2).bool()
    runs = torch.zeros((H, W + 2), dtype=torch.int64, device=device)
    one = ok.T.long()
    runs.scatter_add_(1, lo_c.T, one)
    runs.scatter_add_(1, hi_c.T, -one)
    covered = torch.cumsum(runs, 1)[:, :W] > 0
    return interior | covered


def masks(contours_mm, shape, spacing, origin, device):
    """{roi: (Z, Y, X) uint8 numpy} from {roi: [(N, 3) mm]} on an
    axis-aligned grid."""
    Z, Y, X = shape
    sp = np.asarray(spacing, np.float64)
    org = np.asarray(origin, np.float64)
    out = {}
    for name, polys in contours_mm.items():
        m = torch.zeros((Z, Y, X), dtype=torch.bool, device=device)
        for pos in polys:
            pix = (np.asarray(pos, np.float64) - org) / sp
            k = int(np.round(pix[0, 2]))
            if not 0 <= k < Z:
                continue
            v = np.trunc(pix[:, :2] + 1e-6).astype(np.int64)
            v = np.vstack([v, v[:1], v[:1]])    # closed, as the port closes
            m[k] ^= polygon_bitmap(v, Y, X, device)
        out[name] = m.to(torch.uint8).cpu().numpy()
    return out


def _axis_weights(coords, n):
    """Linear weights of sample coordinates along one axis of n voxels:
    (lo index, hi index, weight of hi, inside)."""
    inside = (coords >= 0) & (coords <= n - 1)
    c = torch.clamp(torch.nan_to_num(coords, nan=0.0), 0, n - 1)
    lo = torch.floor(c).long()
    f = c - lo
    hi = torch.clamp(lo + 1, max=n - 1)
    return lo, hi, f, inside


def separable_sample(vol, cz, cy, cx, background, dtype):
    """``vol`` (Z, Y, X) at the outer product of per-axis coordinates
    (1-d tensors), trilinear, ``background`` where any axis is outside:
    three matrix products, each an axis's two taps."""
    def mat(coords, n):
        lo, hi, f, inside = _axis_weights(coords, n)
        m = torch.zeros((coords.numel(), n), dtype=dtype,
                        device=vol.device)
        rows = torch.arange(coords.numel(), device=vol.device)
        m.index_put_((rows, lo), (1 - f).to(dtype), accumulate=True)
        m.index_put_((rows, hi), f.to(dtype), accumulate=True)
        return m, inside

    v = vol.to(dtype)
    mz, iz = mat(cz, vol.shape[0])
    my, iy = mat(cy, vol.shape[1])
    mx, ix = mat(cx, vol.shape[2])
    out = torch.einsum("ij,jyx->iyx", mz, v)
    out = torch.einsum("kj,zjx->zkx", my, out)
    out = torch.einsum("lj,zyj->zyl", mx, out)
    inside = iz[:, None, None] & iy[None, :, None] & ix[None, None, :]
    return torch.where(inside, out, torch.tensor(background, dtype=dtype,
                                                 device=vol.device))


def dose_on_grid(dose, dose_origin, dose_spacing, shape, spacing, origin,
                 dtype):
    """The dose (a tensor) at each voxel centre of an axis-aligned grid."""
    def coords(axis, n):
        i = torch.arange(n, dtype=torch.float64, device=dose.device)
        return (origin[axis] + i * spacing[axis] - dose_origin[axis]) \
            / dose_spacing[axis]

    Z, Y, X = shape
    return separable_sample(dose, coords(2, Z), coords(1, Y),
                            coords(0, X), 0.0, dtype)


def goal_value(goal, d, voxel_cc):
    """(value, unit kind) of one goal string on the ROI's doses ``d``
    (float64 numpy)."""
    import re

    m = re.match(r"^\s*([DV])\s*(max|min|mean|median|[0-9.]+\s*(?:%|cc|Gy))"
                 r"\s*(<=|>=|<|>)\s*([0-9.]+)\s*(Gy|%|cc)\s*$", goal,
                 re.IGNORECASE)
    kind, qual, unit = m.group(1).upper(), m.group(2).replace(" ", ""), \
        m.group(5)
    ql = qual.lower()
    if kind == "D":
        if ql in ("max", "min", "mean", "median"):
            return float(getattr(np, ql)(d)), "Gy"
        if ql.endswith("%"):
            return float(np.percentile(d, 100.0 - float(ql[:-1]))), "Gy"
        k = int(np.clip(round(float(ql[:-2]) / voxel_cc), 1, d.size))
        return float(np.sort(d)[::-1][k - 1]), "Gy"
    covered = d >= float(ql[:-2])
    if unit == "%":
        return float(100.0 * covered.mean()), "%"
    return float(covered.sum() * voxel_cc), "cc"


def dvh_curve(d, n_bins):
    """(doses, volume %) of a cumulative DVH."""
    bins = np.linspace(0.0, float(d.max()) * 1.05 + 1e-6, n_bins)
    below = np.searchsorted(np.sort(d), bins, side="left")
    return bins, 100.0 * (1.0 - below / d.size)


def gamma(ref, ev, spacing, dose_pct, dta_mm, threshold_pct, cap, dtype):
    """(gamma map (Z, Y, X) float64 numpy, pass rate %, analysed mask) of
    ``ev`` against ``ref``, both tensors on one grid of ``spacing``."""
    sp_zyx = np.asarray(spacing, np.float64)[::-1]
    s = np.maximum(1, np.ceil(sp_zyx / (dta_mm / 3.0) - 1e-9)).astype(int)
    fine_sp = sp_zyx / s
    reach = cap * dta_mm
    r = np.ceil(reach / fine_sp - 1e-9).astype(int)
    dev = ref.device
    # the fine grid: fine index f along an axis at reference pixel
    # (f - r) / s, outside the evaluated grid never chosen
    axes = [(torch.arange((n - 1) * si + 2 * ri + 1, dtype=torch.float64,
                          device=dev) - ri) / si
            for n, si, ri in zip(ref.shape, s, r)]
    fine = separable_sample(ev, *axes, math.inf, dtype)
    refd = ref.to(dtype)
    norm = float(ref.max())
    dd2 = (dose_pct / 100.0 * norm) ** 2
    dta2 = dta_mm * dta_mm
    Z, Y, X = ref.shape
    best = torch.full(ref.shape, math.inf, dtype=dtype, device=dev)
    rz, ry, rx = (int(v) for v in r)
    for oz in range(-rz, rz + 1):
        for oy in range(-ry, ry + 1):
            for ox in range(-rx, rx + 1):
                d2 = (oz * fine_sp[0]) ** 2 + (oy * fine_sp[1]) ** 2 \
                    + (ox * fine_sp[2]) ** 2
                if d2 > reach * reach + 1e-9:
                    continue
                a = (rz + oz, ry + oy, rx + ox)
                view = fine[a[0]:a[0] + (Z - 1) * s[0] + 1:s[0],
                            a[1]:a[1] + (Y - 1) * s[1] + 1:s[1],
                            a[2]:a[2] + (X - 1) * s[2] + 1:s[2]]
                diff = view - refd
                torch.minimum(best, diff * diff / dd2 + d2 / dta2, out=best)
    g = torch.clamp(torch.sqrt(best.to(torch.float64)), max=cap)
    g = g.cpu().numpy()
    mask = ref.cpu().numpy() >= threshold_pct / 100.0 * norm
    rate = float((g[mask] <= 1.0).mean() * 100.0) if mask.any() else 100.0
    return g, rate, mask
