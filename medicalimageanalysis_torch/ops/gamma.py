"""3-D gamma-index dose comparison (Low et al. 1998).

Port of medicalimageanalysis_tpu/ops/gamma.py: ``fine_grid_layout``,
``_decompose_offsets``, the offset scan ``_gamma_fn`` (chunked and
unchunked), ``gamma_index``, ``fine_grid_shape``,
``fine_to_ref_pixel_matrix`` and ``upsample_to_fine``. Every voxel gets

    gamma(r) = min over r' of sqrt( |r' - r|^2 / dta^2
                                  + (D_eval(r') - D_ref(r))^2 / dD^2 )

and passes where gamma <= 1.

The evaluated dose is resampled once onto a fine sub-voxel grid aligned
with the reference grid (spacing <= dta/3, TG-218). Every fine-grid
search offset o decomposes as o = q * s + p: a sub-voxel phase p in
[0, s) and an integer reference-grid shift q. The s_z s_y s_x phase
grids are carved out of the fine volume once (one padded copy); the
minimisation is then a loop over the offsets whose body is a view of one
phase grid at the integer shift and five elementwise operations in the
JAX body's order (``d2 / dta2 + diff * diff / dd2``), so the maps agree
with the JAX package's to float32 rounding. The JAX package runs this
scan as an XLA program, not a Pallas kernel; here it is plain PyTorch on
the device, about five launches an offset (PERF.md §6 records its time
against its bound). The offsets are pruned on the host to the sphere
|d| <= cap * dta, so the map is exact for values <= cap and clamped
above it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import default_device
from ..telemetry import trace

__all__ = ["gamma_index", "fine_grid_layout", "fine_grid_shape",
           "fine_to_ref_pixel_matrix", "upsample_to_fine"]

# the fine grid's background: squared it overflows to inf, so an
# out-of-volume sample never wins the minimum
_OUTSIDE = np.float32(3.0e30)


def fine_grid_layout(spacing, dta_mm, subdiv=None, cap=2.0):
    """Host-side search layout: (s, r, offsets, dist2) with ``s`` the
    per-axis (z, y, x) sub-division factors (fine spacing <= dta/3), ``r``
    the per-axis search radii in fine steps (covering cap * dta),
    ``offsets`` an (M, 3) int array of fine-step offsets inside the
    pruning sphere, centre first, and ``dist2`` their squared physical
    distances in mm^2."""
    sp = np.asarray(spacing, np.float64)  # [sx, sy, sz]
    sp_zyx = sp[::-1]
    if subdiv is None:
        target = dta_mm / 3.0
        s = np.maximum(1, np.ceil(sp_zyx / target - 1e-9)).astype(int)
    else:
        s = np.full(3, int(subdiv), int)
    fine_sp = sp_zyx / s
    reach = cap * dta_mm
    r = np.ceil(reach / fine_sp - 1e-9).astype(int)

    oz, oy, ox = np.mgrid[-r[0]:r[0] + 1, -r[1]:r[1] + 1, -r[2]:r[2] + 1]
    d2 = ((oz * fine_sp[0]) ** 2 + (oy * fine_sp[1]) ** 2
          + (ox * fine_sp[2]) ** 2)
    keep = d2 <= reach * reach + 1e-9
    offsets = np.stack([oz[keep], oy[keep], ox[keep]], axis=1)
    dist2 = d2[keep]
    order = np.argsort(dist2, kind="stable")  # center first
    return tuple(int(v) for v in s), tuple(int(v) for v in r), \
        offsets[order], dist2[order]


def _decompose_offsets(offsets, s, r):
    """Host: fine-step offsets (M, 3) -> (phase_index, qz, qy, qx) int32
    rows. Along each axis the fine index of reference voxel k at offset o
    is k*s + (r + o) = (k + q)*s + p with p = (r+o) mod s."""
    s = np.asarray(s, np.int64)
    r = np.asarray(r, np.int64)
    shifted = offsets + r[None, :]
    p = shifted % s[None, :]
    q = shifted // s[None, :]
    pidx = (p[:, 0] * s[1] + p[:, 1]) * s[2] + p[:, 2]
    return np.concatenate([pidx[:, None], q], axis=1).astype(np.int32)


def _carve_phases(fine, ref_shape, s, r):
    """(s^3, Z + qmax, Y + qmax, X + qmax) phase grids of the fine volume
    as one pad + reshape + permute (one copy); the high-end pad carries
    the outside sentinel where the strided comb runs past the fine volume
    (never addressed by in-sphere offsets)."""
    Z, Y, X = ref_shape
    sz, sy, sx = s
    qz, qy, qx = (2 * ri // si for ri, si in zip(r, s))
    Lz, Ly, Lx = (Z + qz) * sz, (Y + qy) * sy, (X + qx) * sx
    f = F.pad(fine, (0, Lx - fine.shape[2], 0, Ly - fine.shape[1],
                     0, Lz - fine.shape[0]), value=float(_OUTSIDE))
    f = f.reshape(Z + qz, sz, Y + qy, sy, X + qx, sx)
    return f.permute(1, 3, 5, 0, 2, 4).reshape(sz * sy * sx, Z + qz,
                                                Y + qy, X + qx)


def _gamma_scan(ref, phases, dd2, rows, c):
    """sqrt of the minimum over the offsets of d2/dta2 + diff^2/dd2 on
    the reference grid. ref (Z, Y, X) float32 tensor; phases the grids of
    :func:`_carve_phases` on its device; dd2 a 0-d or (Z, Y, X) float32
    tensor there; rows the (M, 4) int rows of :func:`_decompose_offsets`;
    c the (M,) float32 d2/dta2 (numpy)."""
    Z, Y, X = ref.shape
    gam2 = torch.full(ref.shape, 1e30, dtype=torch.float32,
                      device=ref.device)
    g2 = torch.empty_like(ref)
    for (p, qz, qy, qx), ck in zip(rows.tolist(), c.tolist()):
        ev = phases[p, qz:qz + Z, qy:qy + Y, qx:qx + X]
        torch.sub(ev, ref, out=g2)
        g2.mul_(g2).div_(dd2).add_(ck)
        torch.minimum(gam2, g2, out=gam2)
    return gam2.sqrt_()


def _gamma_fn(ref_shape, s, r, chunk):
    """The gamma scan for a grid layout: ``run(ref, fine, dd2, rows,
    dist2, dta2)`` -> the (Z, Y, X) map (a tensor on fine's device), over
    z-chunks of ``chunk`` reference slices when given (each chunk needs
    fine rows [z0*sz, z0*sz + (cz-1)*sz + 2rz], which bounds the phase
    grids' memory on large dose grids)."""
    Z = ref_shape[0]
    sz, rz = s[0], r[0]

    def run(ref, fine, dd2, rows, dist2, dta2):
        c = np.asarray(dist2, np.float32) / np.float32(dta2)
        if chunk is None:
            phases = _carve_phases(fine, tuple(ref.shape), s, r)
            return _gamma_scan(ref, phases, dd2, rows, c)
        parts = []
        for z0 in range(0, Z, chunk):
            cz = min(chunk, Z - z0)
            fsub = fine[z0 * sz:z0 * sz + (cz - 1) * sz + 2 * rz + 1]
            dsub = dd2[z0:z0 + cz] if dd2.dim() == 3 else dd2
            phases = _carve_phases(fsub, (cz,) + tuple(ref.shape[1:]), s, r)
            parts.append(_gamma_scan(ref[z0:z0 + cz], phases, dsub, rows, c))
            del phases
        return torch.cat(parts, dim=0)

    return run


def _gamma_map(ref, fine, dd2, layout, dta_mm, cap, chunk=None):
    """The gamma map of ``ref`` (a (Z, Y, X) float32 tensor) against its
    fine grid ``fine`` for a :func:`fine_grid_layout` ``layout``, clamped
    at ``cap``; dd2 a 0-d or (Z, Y, X) float32 tensor. A tensor on the
    device of ``ref``; :func:`gamma_index` and parallel.batch.gamma_batch
    both run it."""
    s, r, offsets, dist2 = layout
    run = _gamma_fn(tuple(ref.shape), s, r,
                    None if chunk is None else int(chunk))
    gam = run(ref, fine, dd2, _decompose_offsets(offsets, s, r), dist2,
              np.float32(dta_mm * dta_mm))
    return torch.minimum(gam, torch.tensor(np.float32(cap),
                                           device=gam.device))


def gamma_index(ref_dose, eval_fine, spacing, dose_pct=3.0, dta_mm=3.0,
                local=False, norm_dose=None, threshold_pct=10.0,
                subdiv=None, cap=2.0, chunk=None, layout=None):
    """Gamma map of ``eval`` vs ``ref_dose`` on the reference grid.

    ref_dose : (Z, Y, X) reference dose on its own grid (array or tensor).
    eval_fine : the evaluated dose already resampled onto the padded fine
        grid of :func:`fine_grid_layout` / :func:`fine_grid_shape`
        (``Dose.compute_gamma`` does it from any grid;
        :func:`upsample_to_fine` when both doses share a grid), with the
        ``_OUTSIDE`` background. A tensor keeps its device, which runs the
        scan; an array goes to ``default_device()``.
    spacing : [sx, sy, sz] mm of the reference grid.
    dose_pct, dta_mm : the criteria (percent, mm).
    local : False -> global gamma (dD = pct% of ``norm_dose``, default
        max(ref)); True -> local (dD = pct% of |ref| per voxel).
    threshold_pct : voxels with ref < pct% of norm are left out of the
        pass rate (still in the map).
    cap : search-sphere radius in gamma units (>= 1); the map is clamped
        at it.
    chunk : optional z-chunk size bounding the working set.

    Returns dict: gamma (Z, Y, X) float32 numpy, pass_rate, mean/max
    gamma over the analysed region, analysed voxel count, the mask,
    norm_dose, cap, subdiv and the number of search offsets.
    """
    if cap < 1.0:
        # values above cap are clamped and pass_rate counts g <= 1: a
        # sub-1 cap would report true failures as passes
        raise ValueError(f"gamma_index: cap must be >= 1, got {cap}")
    if isinstance(ref_dose, torch.Tensor):
        ref_dose = ref_dose.cpu().numpy()
    ref = np.asarray(ref_dose, np.float32)
    s, r, offsets, dist2 = (layout if layout is not None else
                            fine_grid_layout(spacing, dta_mm, subdiv, cap))
    expect = fine_grid_shape(ref.shape, s, r)
    if tuple(eval_fine.shape) != expect:
        raise ValueError(
            f"gamma_index: eval_fine shape {tuple(eval_fine.shape)} != "
            f"expected fine-grid shape {expect} for s={s} r={r}")

    if norm_dose is None:
        norm_dose = float(ref.max())
    if norm_dose <= 0:
        raise ValueError("gamma_index: non-positive normalisation dose")
    if local:
        dd = (dose_pct / 100.0) * np.maximum(np.abs(ref),
                                             1e-6 * norm_dose)
        dd2 = (dd * dd).astype(np.float32)
    else:
        dd = dose_pct / 100.0 * norm_dose
        dd2 = np.float32(dd * dd)

    device = eval_fine.device if isinstance(eval_fine, torch.Tensor) \
        else default_device()
    fine = torch.as_tensor(eval_fine, dtype=torch.float32, device=device)
    with trace("mia.gamma.scan"):
        gamma = _gamma_map(torch.as_tensor(ref, device=device), fine,
                           torch.as_tensor(dd2, device=device),
                           (s, r, offsets, dist2), dta_mm, cap,
                           chunk).cpu().numpy()

    mask = ref >= (threshold_pct / 100.0) * norm_dose
    n = int(mask.sum())
    if n:
        g = gamma[mask]
        pass_rate = float((g <= 1.0).mean() * 100.0)
        gmean, gmax = float(g.mean()), float(g.max())
    else:
        pass_rate, gmean, gmax = 100.0, 0.0, 0.0
    return {"gamma": gamma, "pass_rate": pass_rate, "mean": gmean,
            "max": gmax, "analysed_voxels": n, "mask": mask,
            "norm_dose": float(norm_dose), "cap": float(cap),
            "subdiv": s, "search_offsets": int(len(dist2))}


def fine_grid_shape(ref_shape, s, r):
    """Padded fine-grid dims for :func:`gamma_index`'s eval input."""
    return tuple((n - 1) * si + 2 * ri + 1
                 for n, si, ri in zip(ref_shape, s, r))


def fine_to_ref_pixel_matrix(s, r):
    """4x4 mapping fine-grid pixel (x, y, z, 1) -> reference-grid pixel:
    fine pixel f along an axis sits at reference pixel (f - r) / s.
    Composed with the reference -> eval pixel matrix it resamples the
    eval dose straight onto the fine grid in one interpolation."""
    sz, sy, sx = s
    rz, ry, rx = r
    A = np.eye(4, dtype=np.float64)
    A[0, 0], A[1, 1], A[2, 2] = 1.0 / sx, 1.0 / sy, 1.0 / sz
    A[0, 3], A[1, 3], A[2, 3] = -rx / sx, -ry / sy, -rz / sz
    return A


def upsample_to_fine(eval_on_ref_grid, s, r):
    """Trilinearly upsample an eval dose that already shares the
    reference grid onto the padded fine grid, endpoint-aligned (fine
    index f sits at reference pixel f/s exactly), as three full-float32
    matrix contractions; the pad ring holds the outside sentinel. A
    tensor stays on its device, an array goes to ``default_device()``;
    returns a float32 tensor there."""
    from .resample import _interp_matrix, _separable_apply

    device = eval_on_ref_grid.device \
        if isinstance(eval_on_ref_grid, torch.Tensor) else default_device()
    vol = torch.as_tensor(eval_on_ref_grid, dtype=torch.float32,
                          device=device)
    sz, sy, sx = s
    rz, ry, rx = r
    if (sz, sy, sx) != (1, 1, 1):
        mz, my, mx = (torch.as_tensor(_interp_matrix((n - 1) * si + 1, n,
                                                     1.0 / si),
                                      device=device)
                      for n, si in zip(vol.shape, (sz, sy, sx)))
        vol = _separable_apply(vol, mz, my, mx)
    return F.pad(vol, (rx, rx, ry, ry, rz, rz), value=float(_OUTSIDE))
