"""Batched cohort operations, on one device or over a mesh's data axis.

Port of medicalimageanalysis_tpu/parallel/batch.py:

- ``make_preprocess_fn`` / ``preprocess_batch`` (:59-141): rescale -> FFS
  -> three interpolation-matrix contractions -> three Gaussian
  contractions -> external-threshold mask over a (B, Z, Y, X) batch.
  These are plain large products outside any kernel, so they run as
  ``torch.einsum`` (cuBLAS on the card, in full float32 under
  device.full_float32). The TPU's VMEM-cliff sub-batching has no
  counterpart; ``chunk`` is kept as a no-op argument so callers port line
  for line.
- ``make_registration_step`` (:223-270): the batched 6-DoF intensity
  registration step, each pair sampled through the warp kernel's
  ``coords`` mode with its analytic coordinate VJP, Adam in optax's
  float32 order;
- ``compare_masks_batch`` (:273-313): the Dice / HD95 / ASSD /
  surface-Dice panel of B mask pairs (ops/edt);
- ``dvh_batch`` (:339-401): the DVH panel of B (dose, mask) pairs, each
  through ops/dvh's core (the histogram kernel on the card);
- ``gamma_batch`` (:404-486): gamma of B dose pairs on a shared grid
  (ops/gamma).
- ``rasterize_batch`` (:667-735): every contour of B ROIs in one pooled
  pass (ops/rasterize);
- ``demons_batch`` (:144-221): B deformable pairs, each the single-level
  solve of ``_demons_core`` (the ``disp`` mode on the card), the data
  rows stepped in lockstep (``_Demons``: every row's iteration i before
  any row's i + 1, ``LOCKSTEP`` counts the rounds); SyN one pair after
  another (``_syn_core``), assembled by ``_syn_assemble``;
- ``radiomics_batch`` (:489-585): the texture matrices of B (volume, ROI)
  pairs counted in one batched pass on the device (ops/radiomics), the
  formulas per pair on the host;
- ``n4_batch`` (:587-665): every N4 fitting level of B volumes as one
  batched loop (ops/n4), each lane gated on its own convergence
  statistic, so a lane follows its single-volume trajectory.

With ``mesh`` (parallel/mesh.make_mesh) the batch splits over the mesh's
``data`` axis (B must divide by it, or ValueError as in the JAX package):
each data row runs the function's ``mesh=None`` body on its slice of the
batch, on the device of the row's first ``space`` entry, the rows one
after another from this thread (``_data_sharded_call``), and the rows'
results merge in batch order, across processes too. ``demons_batch``
steps its rows in lockstep instead, a pair of each at a time, each on
its own device, so that the cards of the data axis work at once. The
JAX package
replicates each row over ``space``; the port computes it once, with the
same result. The return types are those of ``mesh=None``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import default_device, full_float32
from ..ops.filters import _gauss_kernel_matrix
from ..ops.resample import _interp_matrix
from ..telemetry import trace

__all__ = ["LOCKSTEP", "compare_masks_batch", "demons_batch", "dvh_batch",
           "gamma_batch", "make_preprocess_fn", "make_registration_step",
           "n4_batch", "preprocess_batch", "radiomics_batch",
           "rasterize_batch"]

# demons_batch's lockstep, as it ran, summed over calls: "rows", the
# solves stepped together (the data rows a call held); "rounds", the
# rounds, each one iteration of every row's pair. B pairs run one after
# another count one row and B x iterations rounds.
LOCKSTEP = {"rows": 0, "rounds": 0}


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
                     ffs_op="none", mesh=None, device=None):
    """Host wrapper: run the preprocess over a numpy batch on ``device``
    (default: ``default_device()``); returns device tensors. With
    ``mesh`` each data row's series run on the row's device and the
    results come back concatenated on the first row's."""
    from ..ops.volume import stored_to_float

    if mesh is not None:
        return _data_sharded_call(
            "preprocess_batch", mesh,
            lambda r, s, i, device: preprocess_batch(
                r, s, i, out_shape, ffs_op, device=device),
            [raw, slopes, intercepts])
    device = default_device() if device is None else torch.device(device)
    fn = make_preprocess_fn(raw.shape[1:], out_shape, ffs_op=ffs_op,
                            device=device)
    return fn(stored_to_float(raw, device),
              torch.as_tensor(slopes, dtype=torch.float32, device=device),
              torch.as_tensor(intercepts, dtype=torch.float32,
                              device=device))


def _data_rows(name, mesh, arrays):
    """[(row, device, the row's slices of ``arrays``)] for each data row
    this process holds, after checking that ``arrays`` share their batch
    size B and that B divides by the mesh's 'data' axis. The slices are
    taken on the host, or from the tensors given; the device is the row's
    first 'space' entry."""
    n_data = mesh.shape["data"]
    B = len(arrays[0])
    if any(len(a) != B for a in arrays):
        raise ValueError(f"{name}: expected matching batch sizes, got "
                         f"{[len(a) for a in arrays]}")
    if B % n_data:
        raise ValueError(f"{name}: batch {B} not divisible by the "
                         f"'data' axis ({n_data})")
    rows = B // n_data
    return [(r, mesh.devices[r, 0],
             [a[r * rows:(r + 1) * rows] for a in arrays])
            for r in mesh.local_rows()]


def _merge_rows(mesh, results):
    """{(row, 0): result} of this process's data rows -> one result in
    batch order (mesh._merge), across processes too
    (mesh.gather_blocks)."""
    from .mesh import _merge, gather_blocks

    everyone = gather_blocks(mesh, results)
    return _merge([everyone[(r, 0)] for r in range(mesh.shape["data"])])


def _data_sharded_call(name, mesh, body, arrays):
    """Run a cohort function over the mesh's 'data' axis: call
    ``body(*row_slices, device=...)`` for each data row this process holds
    (:func:`_data_rows`), the rows one after another, and merge the rows'
    results (:func:`_merge_rows`). The body uploads its own slices."""
    return _merge_rows(mesh, {(r, 0): body(*part, device=dev)
                              for r, dev, part in _data_rows(name, mesh,
                                                             arrays)})


def make_registration_step(vol_shape, lr=0.05, stride=2, device=None):
    """Batched 6-DoF intensity-registration train step.

    State: poses (B, 6) in scaled units and the Adam moments. Volumes
    (B, Z, Y, X) ``ref`` and ``mov`` share the grid (unit spacing, zero
    origin); the physical-geometry path is models/rigid_intensity. Each
    step samples every pair's moving volume through the warp kernel's
    ``coords`` mode with the coordinate gradients fused into the launch
    (ops/resample.make_trilinear_sampler); the reference values take no
    gradient (ops/resample.trilinear_gather). Returns (train_step, init):
    ``train_step(params, opt_state, refs, movs) -> (params, opt_state,
    loss)``, ``init(batch) -> (params, opt_state)`` on ``device``
    (default: ``default_device()``).
    """
    from ..models.rigid_intensity import (_POSE_SCALE, adam_init,
                                          adam_update, pose_to_matrix)
    from ..ops.resample import make_trilinear_sampler, trilinear_gather

    device = default_device() if device is None else torch.device(device)
    Z, Y, X = vol_shape
    opts = dict(dtype=torch.float32, device=device)
    zz = torch.arange(0, Z, stride, **opts)
    yy = torch.arange(0, Y, stride, **opts)
    xx = torch.arange(0, X, stride, **opts)
    Zg, Yg, Xg = torch.meshgrid(zz, yy, xx, indexing="ij")
    coords = torch.stack([Xg.reshape(-1), Yg.reshape(-1), Zg.reshape(-1)],
                         dim=-1)
    coords_h = torch.cat([coords, torch.ones_like(coords[:, :1])], dim=1)
    center = torch.tensor([X / 2, Y / 2, Z / 2], **opts)
    scale = torch.as_tensor(_POSE_SCALE, device=device)

    @full_float32()
    def loss_fn(params, refs, movs):
        losses = []
        for b in range(params.shape[0]):
            m = pose_to_matrix(params[b] * scale, center)
            mov_pix = coords_h @ m.T
            with torch.no_grad():
                ref_vals = trilinear_gather(refs[b], coords, 0.0)
            vals = make_trilinear_sampler(movs[b], 0.0)(mov_pix[:, :3])
            losses.append(torch.mean((vals - ref_vals) ** 2))
        return torch.mean(torch.stack(losses))

    def train_step(params, opt_state, refs, movs):
        params = params.detach().requires_grad_(True)
        loss = loss_fn(params, refs, movs)
        (g,) = torch.autograd.grad(loss, params)
        update, opt_state = adam_update(g, opt_state, lr)
        return (params.detach() + update).detach(), opt_state, \
            loss.detach()

    def init(batch):
        params = torch.zeros((batch, 6), **opts)
        return params, adam_init(params)

    return train_step, init


def compare_masks_batch(masks_a, masks_b, spacing, tolerance_mm=2.0,
                        mesh=None, device=None):
    """Cohort segmentation QA: the Dice / Jaccard / volumes / HD / HD95 /
    ASSD / surface-Dice panel (ops/edt.surface_metrics) for B mask pairs
    on ``device`` (default: the stacks' device for tensors, else
    ``default_device()``), one pair after another, so the EDT's working
    set is one pair's whatever B is.

    masks_a/masks_b: (B, Z, Y, X) bool/uint8 (numpy or tensors); spacing
    [sx, sy, sz] mm, shared. Returns a dict of (B,) float32 numpy arrays
    with the keys of ops.edt.surface_metrics."""
    from ..ops.edt import _as_bool, _surface_metrics

    if masks_a.shape != masks_b.shape or len(masks_a.shape) != 4:
        raise ValueError("compare_masks_batch: expected matching "
                         f"(B, Z, Y, X) stacks, got {tuple(masks_a.shape)} "
                         f"vs {tuple(masks_b.shape)}")
    if mesh is not None:
        return _data_sharded_call(
            "compare_masks_batch", mesh,
            lambda a, b, device: compare_masks_batch(
                a, b, spacing, tolerance_mm, device=device),
            [masks_a, masks_b])
    sp = tuple(float(v) for v in np.asarray(spacing).reshape(-1))
    rows = [_surface_metrics(_as_bool(masks_a[b], device),
                             _as_bool(masks_b[b], device), sp,
                             float(tolerance_mm))
            for b in range(masks_a.shape[0])]
    return {k: torch.stack([r[k] for r in rows]).cpu().numpy()
            for k in rows[0]}


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
    from ..ops.dvh import D_VALUES, _dvh_core

    if mesh is not None:
        # each row's body checks its stacks
        vox = np.broadcast_to(np.asarray(voxel_volume_cc, np.float32),
                              (len(doses),))
        return _data_sharded_call(
            "dvh_batch", mesh,
            lambda d, m, v, device: dvh_batch(d, m, v, max_dose, increment,
                                              device=device),
            [doses, masks, vox])
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
    slicing plane. Returns (B, Z, Y, X) uint8 0/1 numpy masks with
    per-slice XOR semantics, C-contiguous: the whole batch is brought
    down from the device in one copy (``_rasterize_batch_device`` keeps
    it there)."""
    if mesh is not None:
        return _data_sharded_call(
            "rasterize_batch", mesh,
            lambda sets, device: rasterize_batch(sets, dimensions, plane,
                                                 device=device),
            [list(contour_sets)])
    out = _rasterize_batch_device(contour_sets, dimensions, plane, device)
    return np.ascontiguousarray(out.cpu().numpy())


def _rasterize_batch_device(contour_sets, dimensions, plane, device=None):
    """``rasterize_batch``'s body without the copy down: the (B, Z, Y, X)
    uint8 0/1 tensor on ``device`` (a strided view of the canvas for the
    Coronal and Sagittal planes)."""
    from ..ops import rasterize
    from ..utils.convert.contour import _plane_split, plane_canvas

    S, H, W, axis = plane_canvas(dimensions, plane)
    grouped = [_plane_split(cs, plane) for cs in contour_sets]
    out = rasterize.rasterize_polygons_grouped(grouped, S, H, W,
                                               device=device, host=False)
    return out.movedim(1, axis + 1) if axis else out


def gamma_batch(ref_doses, eval_doses, spacing, dose_pct=3.0,
                dta_mm=3.0, local=False, threshold_pct=10.0,
                subdiv=None, cap=2.0, mesh=None, return_maps=False,
                device=None):
    """Cohort gamma-index QA: B (reference, evaluated) dose pairs on a
    shared grid (cross-grid pairs: ``Dose.compute_gamma`` per pair), one
    pair after another on ``device`` (default: the stacks' device for
    tensors, else ``default_device()``).

    The TG-218 sub-voxel search of ops.gamma.gamma_index: one fine-grid
    upsample (ops.gamma.upsample_to_fine) and the offset scan per pair,
    exact up to ``cap``; each pair normalises to max(ref), in float32 as
    the JAX package's batch does. Returns a dict of (B,) numpy arrays:
    pass_rate, mean, max (float32), analysed_voxels (exact int32),
    norm_dose, plus 'subdiv', 'search_offsets' and, with
    ``return_maps``, the (B, Z, Y, X) 'gamma' maps. An all-zero
    reference reports pass rate 100 with 0 analysed voxels (the per-pair
    path raises instead).
    """
    from ..ops.gamma import _gamma_map, fine_grid_layout, upsample_to_fine

    if ref_doses.shape != eval_doses.shape or len(ref_doses.shape) != 4:
        raise ValueError("gamma_batch: expected matching (B, Z, Y, X) "
                         f"stacks, got {tuple(ref_doses.shape)} vs "
                         f"{tuple(eval_doses.shape)}")
    if cap < 1.0:
        raise ValueError(f"gamma_batch: cap must be >= 1, got {cap}")
    if mesh is not None:
        return _data_sharded_call(
            "gamma_batch", mesh,
            lambda r, e, device: gamma_batch(
                r, e, spacing, dose_pct, dta_mm, local, threshold_pct,
                subdiv, cap, return_maps=return_maps, device=device),
            [ref_doses, eval_doses])
    if device is None:
        device = ref_doses.device if isinstance(ref_doses, torch.Tensor) \
            else default_device()
    layout = fine_grid_layout(spacing, dta_mm, subdiv, cap)
    s, r = layout[0], layout[1]
    opts = dict(dtype=torch.float32, device=device)
    pct = torch.tensor(np.float32(dose_pct / 100.0), **opts)
    thr = torch.tensor(np.float32(threshold_pct / 100.0), **opts)
    tiny = torch.tensor(np.float32(1e-6), **opts)

    stats, maps = {k: [] for k in ("pass_rate", "mean", "max",
                                   "analysed_voxels", "norm_dose")}, []
    for b in range(ref_doses.shape[0]):
        ref_v = torch.as_tensor(ref_doses[b], **opts)
        ev_v = torch.as_tensor(eval_doses[b], **opts)
        norm = ref_v.max()
        norm_safe = torch.maximum(norm, tiny)
        if local:
            dd = pct * torch.maximum(ref_v.abs(), tiny * norm_safe)
            dd2 = dd * dd
        else:
            dd = pct * norm_safe
            dd2 = dd * dd
        gam = _gamma_map(ref_v, upsample_to_fine(ev_v, s, r), dd2, layout,
                         dta_mm, cap)
        mask = (ref_v >= thr * norm) & (norm > 0)
        n = mask.sum()
        nf = torch.clamp(n, min=1).to(torch.float32)
        zero = torch.zeros((), **opts)
        passed = (mask & (gam <= 1.0)).sum().to(torch.float32)
        stats["pass_rate"].append(torch.where(
            n > 0, passed / nf * 100.0, torch.full((), 100.0, **opts)))
        stats["mean"].append(torch.where(mask, gam, zero).sum() / nf)
        stats["max"].append(torch.where(mask, gam, zero).max())
        stats["analysed_voxels"].append(n.to(torch.int32))
        stats["norm_dose"].append(norm)
        if return_maps:
            maps.append(gam)
    out = {k: torch.stack(v).cpu().numpy() for k, v in stats.items()}
    out["subdiv"] = s
    out["search_offsets"] = int(len(layout[3]))
    if return_maps:
        out["gamma"] = torch.stack(maps).cpu().numpy()
    return out


def demons_batch(fixed_batch, moving_batch, spacing_xyz=(1.0, 1.0, 1.0),
                 method="fast", iterations=30, std=1.0, step=2.0,
                 intensity_threshold=0.001, smooth=True, mesh=None,
                 forces="ssd", lncc_radius=3, device=None):
    """Deformable registration of B (fixed, moving) pairs (B, Z, Y, X) on
    ``device`` (default: ``default_device()``), or with ``mesh`` on the
    device of each pair's data row. Each pair is the single-level solve
    of ``demons_registration`` (one ``disp`` launch per iteration on the
    card). Returns the (B, Z, Y, X, 3) float32 numpy DVFs in mm.

    The pairs run by position within their data row: pair j of every
    row is cast and uploaded to the row's device and set up (``_Demons``),
    then the rows' solves run in lockstep from this thread, round i
    issuing iteration i of every row's pair j, each on its own device, so
    that the cards of a mesh work at once; then every card's field comes
    to the host, and pair j + 1 starts. So each device holds one solve at
    a time, and with no mesh the pairs run one after another. The rounds
    give the bits of one pair after another. method='syn' runs its pairs
    one after another, each u2 o u1^{-1} assembled through
    ``_syn_assemble`` (``invert_dvf`` / ``compose_dvf``)."""
    from ..device import as_f32
    from ..ops.registration.demons import _Demons

    if forces not in ("ssd", "lncc"):
        raise ValueError(f"demons_batch: forces must be 'ssd' or "
                         f"'lncc', got {forces!r}")
    method = str(method).lower()
    if method not in ("demons", "fast", "diffeomorphic",
                      "biomechanical", "syn"):
        raise ValueError(f"demons_batch: unknown method {method!r}")
    if method == "syn":
        return _syn_batch(fixed_batch, moving_batch, spacing_xyz,
                          iterations, std, step, intensity_threshold, smooth,
                          mesh, forces, lncc_radius, device)
    if mesh is None:
        rows = [(0, default_device() if device is None
                 else torch.device(device), [fixed_batch, moving_batch])]
    else:
        rows = _data_rows("demons_batch", mesh, [fixed_batch, moving_batch])

    def lockstep(j):
        """Pair j of every row, solved in lockstep: the fields, one a
        row, on the rows' devices."""
        solves = []
        for _, dev, (fixed, moving) in rows:
            with trace("mia.batch.inputs"):
                # up in the stored dtype, cast on the device: an int16
                # series crosses the bus at half the bytes of its float32
                # cast, and the host casts nothing
                solves.append(_Demons(
                    torch.as_tensor(fixed[j], device=dev).to(torch.float32),
                    torch.as_tensor(moving[j], device=dev).to(torch.float32),
                    as_f32(spacing_xyz, dev), float(std), float(step),
                    float(intensity_threshold), method, bool(smooth),
                    forces=forces, lncc_radius=int(lncc_radius)))
        with trace("mia.batch.lockstep"):
            for _ in range(int(iterations)):
                for s in solves:
                    s.step()
            return [s.field_mm() for s in solves]

    with trace("mia.batch.demons"):
        per_row = len(rows[0][2][0]) if rows else 0
        out = np.empty((len(rows) * per_row,)
                       + tuple(np.shape(fixed_batch)[1:]) + (3,), np.float32)
        for j in range(per_row):
            fields = lockstep(j)
            with trace("mia.batch.fields_out"):
                _to_host(fields, [out[k * per_row + j]
                                  for k in range(len(rows))])
            del fields          # off the cards before the next pair's set-up
    # a process that holds no data row runs no round
    LOCKSTEP["rows"] += len(rows) if per_row else 0
    LOCKSTEP["rounds"] += int(iterations) * per_row
    if mesh is None or not mesh.multiprocess:
        return out                  # every row is here, in batch order
    return _merge_rows(mesh, {(r, 0): out[k * per_row:(k + 1) * per_row]
                              for k, (r, _, _) in enumerate(rows)})


def _to_host(fields, outs):
    """Copy each device tensor of ``fields`` into the host array of
    ``outs`` beside it. A card's field goes first into a pinned staging
    tensor, every card's copy issued before any is waited on, so that the
    cards copy at once and at the bus's pinned rate; the caller gets
    pageable memory, and the staging returns to PyTorch's pinned cache
    (one field a card, reused by the next copy)."""
    staged = []
    for f, o in zip(fields, outs):
        if f.is_cuda:
            s = torch.empty(f.shape, dtype=f.dtype, pin_memory=True)
            s.copy_(f, non_blocking=True)
            staged.append((s, f.device, o))
        else:
            torch.from_numpy(o).copy_(f)
    for s, dev, o in staged:
        torch.cuda.current_stream(dev).synchronize()
        torch.from_numpy(o).copy_(s)


def _syn_batch(fixed_batch, moving_batch, spacing_xyz, iterations, std,
               step, intensity_threshold, smooth, mesh, forces, lncc_radius,
               device):
    """:func:`demons_batch` of method 'syn': the pairs one after another,
    and with ``mesh`` the data rows one after another."""
    from ..device import as_f32
    from ..ops.registration.demons import _syn_assemble, _syn_core

    if mesh is not None:
        return _data_sharded_call(
            "demons_batch", mesh,
            lambda f, m, device: _syn_batch(
                f, m, spacing_xyz, iterations, std, step,
                intensity_threshold, smooth, None, forces, lncc_radius,
                device),
            [fixed_batch, moving_batch])
    device = default_device() if device is None else torch.device(device)
    fixed = as_f32(fixed_batch, device)
    moving = as_f32(moving_batch, device)
    sp = as_f32(spacing_xyz, device)
    outs = []
    for f, m in zip(fixed, moving):
        u1, u2 = _syn_core(f, m, sp, float(std), float(step),
                           float(intensity_threshold), int(iterations),
                           bool(smooth), forces, int(lncc_radius))
        outs.append(_syn_assemble(u1, u2, sp))
    return torch.stack(outs).cpu().numpy()


def radiomics_batch(volumes, masks, spacing, bin_width=None, n_bins=32,
                    alpha=0, families=None, mesh=None, device=None):
    """Cohort radiomics: the texture matrices of B (volume, ROI) pairs
    (B, Z, Y, X), pre-cropped to a shared bounding shape, counted in one
    batched pass on ``device`` (default: ``default_device()``) at the
    largest level count and the shared run-length cap; each pair's
    formulas then run on the host at its own level count. Returns a list
    of B dicts with the ``ops.radiomics.compute_radiomics`` schema."""
    from ..ops import radiomics as rad

    vols = np.asarray(volumes, np.float32)
    ms = np.asarray(masks) > 0
    if vols.shape != ms.shape or vols.ndim != 4:
        raise ValueError("radiomics_batch: expected matching "
                         f"(B, Z, Y, X) stacks, got {vols.shape} vs "
                         f"{ms.shape}")
    if mesh is not None:
        return _data_sharded_call(
            "radiomics_batch", mesh,
            lambda v, m, device: radiomics_batch(
                v, m, spacing, bin_width, n_bins, alpha, families,
                device=device),
            [vols, ms])
    if families is None:
        families = rad.ALL_FAMILIES
    device = default_device() if device is None else torch.device(device)
    B = vols.shape[0]
    sp = np.asarray(spacing, np.float64).reshape(-1)
    levels = np.zeros(vols.shape, np.int32)
    ngs = []
    for b in range(B):
        levels[b], ng = rad._discretize(vols[b], ms[b], bin_width, n_bins)
        ngs.append(ng)
    ng_max = max(ngs)

    mats = None
    if any(f in families for f in rad._TEXTURE_FAMILIES):
        out = rad._texture_matrices(
            torch.as_tensor(levels, device=device),
            torch.as_tensor(ms, device=device), ng_max,
            max(vols.shape[1:]), int(alpha))
        mats = {k: v.cpu().numpy().astype(np.float64)
                for k, v in out.items()}

    results = []
    for b in range(B):
        ng = ngs[b]  # each pair's own level count: Ng enters Idn / Idmn
        n_vox = int(ms[b].sum())
        own = None if mats is None else {
            "glcm": mats["glcm"][b][:, :ng, :ng],
            "glrlm": mats["glrlm"][b][:, :ng, :],
            "gldm": mats["gldm"][b][:ng],
            "ngtdm_s": mats["ngtdm_s"][b][:ng],
            "ngtdm_n": mats["ngtdm_n"][b][:ng],
            "hist": mats["hist"][b][:ng]}
        res = rad._panel(families, vols[b], ms[b], sp, levels[b], ng, own,
                         n_vox, device)
        res["meta"] = {"Ng": ng, "voxels": n_vox, "bin_width": bin_width,
                       "n_bins": (None if bin_width is not None
                                  else n_bins)}
        results.append(res)
    return results


def n4_batch(volumes, masks=None, shrink=4, n_bins=200, fwhm=0.15,
             noise=0.01, levels=4, max_iterations=50,
             conv_threshold=1e-3, min_control_spacing=32.0,
             return_fields=False, mesh=None, device=None):
    """Cohort N4 bias correction: every fitting level of B volumes (B, Z,
    Y, X) as one batched loop on ``device`` (default:
    ``default_device()``). Each lane's update is gated on its own
    convergence statistic, so each follows its single-volume trajectory
    while the loop runs until the slowest lane converges; each lane's
    fit inputs are made as ``n4_bias_correction`` makes them (the log in
    float64 on the host). Returns the corrected (B, Z, Y, X) float32
    numpy volumes (and the multiplicative fields with
    ``return_fields``). Other knobs as ops/n4.n4_bias_correction."""
    from ..ops import n4 as _n4

    vols = np.asarray(volumes, np.float32)
    if vols.ndim != 4:
        raise ValueError(f"n4_batch: expected (B, Z, Y, X), got "
                         f"{vols.shape}")
    m = (np.ones(vols.shape, bool) if masks is None
         else np.asarray(masks) > 0)
    if m.shape != vols.shape:
        raise ValueError(f"n4_batch: masks shape {m.shape} != "
                         f"volumes shape {vols.shape}")
    if mesh is not None:
        return _data_sharded_call(
            "n4_batch", mesh,
            lambda v, mk, device: n4_batch(
                v, mk, shrink, n_bins, fwhm, noise, levels, max_iterations,
                conv_threshold, min_control_spacing, return_fields,
                device=device),
            [vols, m])
    device = default_device() if device is None else torch.device(device)
    corrected, fields = _n4._n4_lanes(
        vols, m & (vols > 0), max(1, int(shrink)), device, levels,
        max_iterations, n_bins, fwhm, noise, conv_threshold,
        min_control_spacing)
    if return_fields:
        return corrected.cpu().numpy(), fields.cpu().numpy()
    return corrected.cpu().numpy()
