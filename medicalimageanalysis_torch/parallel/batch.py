"""Batched cohort operations, on one device.

Port of medicalimageanalysis_tpu/parallel/batch.py:

- ``make_preprocess_fn`` / ``preprocess_batch`` (:59-141): rescale -> FFS
  -> three interpolation-matrix contractions -> three Gaussian
  contractions -> external-threshold mask over a (B, Z, Y, X) batch.
  These are plain large products outside any kernel, so they run as
  ``torch.einsum`` (cuBLAS on the card, in full float32 under
  device.full_float32). The TPU's VMEM-cliff sub-batching has no
  counterpart; ``chunk`` is kept as a no-op argument so callers port line
  for line.
- ``dvh_batch`` (:339-401): the DVH panel of B (dose, mask) pairs, each
  through ops/dvh's core (the histogram kernel on the card).
- ``rasterize_batch`` (:667-735): every contour of B ROIs in one pooled
  pass (ops/rasterize).

A ``mesh`` (the JAX package's data-sharded path) raises: multi-device is
ROADMAP.md queue 1, item 11.
"""

from __future__ import annotations

import torch

from ..device import default_device, full_float32
from ..ops.filters import _gauss_kernel_matrix
from ..ops.resample import _interp_matrix

__all__ = ["dvh_batch", "make_preprocess_fn", "preprocess_batch",
           "rasterize_batch"]


def make_preprocess_fn(in_shape, out_shape, ffs_op="ax_rot2",
                       threshold=-250.0, sigma_vox=1.0, chunk="auto",
                       device=None):
    """Build the preprocess step for fixed shapes on ``device``.

    raw (B, Z, Y, X) stored values + per-series slope/intercept (B,)
    tensors on ``device`` (default: ``default_device()``) -> (volumes
    (B, oz, oy, ox) float32, masks uint8). ``chunk`` is accepted and
    ignored.
    """
    del chunk
    device = default_device() if device is None else torch.device(device)
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
    (default: ``default_device()``); returns device tensors."""
    from ..ops.volume import stored_to_float

    device = default_device() if device is None else torch.device(device)
    fn = make_preprocess_fn(raw.shape[1:], out_shape, ffs_op=ffs_op,
                            device=device)
    return fn(stored_to_float(raw, device),
              torch.as_tensor(slopes, dtype=torch.float32, device=device),
              torch.as_tensor(intercepts, dtype=torch.float32,
                              device=device))


def _no_mesh(name, mesh):
    if mesh is not None:
        raise NotImplementedError(
            f"{name} over a device mesh is not ported yet: multi-device — "
            "ROADMAP.md queue 1, item 11")


def dvh_batch(doses, masks, voxel_volume_cc, max_dose=150, increment=5,
              mesh=None, device=None):
    """Cohort DVH: the Dmin/Dmax/Dmean/Dmedian/Dstd + D1..D99 +
    VS{d}Gy panel for B (dose grid, ROI mask) pairs on ``device``
    (default: ``default_device()``); the mask is the validity input of
    ops/dvh's core, so nothing leaves the device until the (B,)
    reductions come back.

    doses/masks: (B, Z, Y, X) aligned grids (numpy or tensors);
    voxel_volume_cc: scalar or (B,). Returns a dict of float64 numpy
    arrays keyed like dvh_statistics. Pairs with an empty mask come back
    NaN (volume 0)."""
    import numpy as np

    from ..ops.dvh import D_VALUES, _dvh_core

    _no_mesh("dvh_batch", mesh)
    device = default_device() if device is None else torch.device(device)
    d = torch.as_tensor(doses, device=device).to(torch.float32)
    m = torch.as_tensor(masks, device=device)
    if d.shape != m.shape or d.dim() != 4:
        raise ValueError("dvh_batch: expected matching (B, Z, Y, X) "
                         f"stacks, got {tuple(d.shape)} vs {tuple(m.shape)}")
    B = d.shape[0]
    vox = np.broadcast_to(np.asarray(voxel_volume_cc, np.float32), (B,))
    n_bins = int(max_dose // increment + 2)
    d_pcts = torch.as_tensor(np.asarray(D_VALUES, np.float32), device=device)

    rows = [_dvh_core(d[b].reshape(-1), m[b].reshape(-1) > 0, d_pcts,
                      n_bins, float(increment)) for b in range(B)]
    dmin, dmax, mean, median, std, d_out, below, count = (
        torch.stack([r[i] for r in rows]).cpu().numpy().astype(np.float64)
        for i in range(8))
    empty = count == 0
    for stat in (dmin, dmax, mean, median, std, d_out):
        stat[empty] = np.nan
    res = {"Volume (cc)": count * vox,
           "Dmin": dmin, "Dmax": dmax, "Dmean": mean,
           "Dmedian": median, "Dstd": std}
    for i, p in enumerate(D_VALUES):
        res[f"D{p}"] = d_out[:, i]
    with np.errstate(invalid="ignore", divide="ignore"):
        for i in range(n_bins):
            g = i * increment
            if g > max_dose + increment:
                break
            res[f"VS{g}Gy_percent"] = below[:, i] / count * 100.0
            res[f"VS{g}Gy_cc"] = below[:, i] * vox
    return res


def rasterize_batch(contour_sets, dimensions, plane="Axial", mesh=None,
                    device=None):
    """Cohort contour rasterization: every contour of B ROIs in one
    pooled pass on ``device`` (default: ``default_device()``).

    contour_sets: list over B ROIs, each a list of (N, 3) pixel contours;
    dimensions: (Z, Y, X) of the shared grid; plane: the contours'
    slicing plane. Returns (B, Z, Y, X) uint8 numpy masks with per-slice
    XOR semantics."""
    import numpy as np

    from ..ops.rasterize import rasterize_polygons_grouped
    from ..utils.convert.contour import _plane_split, plane_canvas

    _no_mesh("rasterize_batch", mesh)
    S, H, W, axis = plane_canvas(dimensions, plane)
    grouped = [_plane_split(cs, plane) for cs in contour_sets]
    out = rasterize_polygons_grouped(grouped, S, H, W, device=device)
    if axis:
        out = np.moveaxis(out, 1, axis + 1)
    return (out > 0).astype(np.uint8)
