"""B-spline free-form deformable registration.

Port of medicalimageanalysis_tpu/ops/registration/bspline.py
(``_cubic_bspline``, ``bspline_basis_matrix``, ``_bspline_fit``,
``bspline_registration``, ``elastix_registration``, ``_elastix_staged``):
a cubic B-spline control grid (default 50 mm spacing) is densified to a
displacement field by three separable basis-matrix contractions, the
masked loss differentiates through the warp, and Adam (written out in
``optax.adam``'s float32 order) steps the control points.

The warp is the kernel's ``disp`` mode with its fused coordinate
gradients (``ops.warp.make_disp_sampler``), on the card and, through its
plain twin, on the CPU alike: the backward pass restacks the gradients
the forward launch wrote and never gathers again. The densify
contractions run in full float32. The JAX package's slab-window checks
and refits (``bspline.py:200-243``) have no counterpart: the kernel has
no slab, and neither has their TPU-only redo of an elastix level.

``elastix_registration`` runs the elastix-style pyramid: each level
halves the image and the control grid and warm-starts additively from
the field of the level before (``base_mm``, upsampled on the device).
``_elastix_staged`` runs a SimpleElastix vector of maps: the linear
stages on the port's ``register_rigid_intensity``, seeded by phase
correlation of the gradient magnitudes, then the final BSpline stage on
the linearly resampled moving image (the warp kernel's ``affine``
mode); every stage composes into one field.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...device import as_f32, default_device, full_float32
from ...models.rigid_intensity import _metric_loss, adam_init, adam_update
from ..warp import make_disp_sampler

__all__ = ["bspline_registration", "bspline_basis_matrix",
           "elastix_registration"]


def _cubic_bspline(t):
    """Uniform cubic B-spline basis values for fractional offsets t in
    [0,1): weights for control points floor(u)-1 .. floor(u)+2."""
    t2 = t * t
    t3 = t2 * t
    b0 = (1 - t) ** 3 / 6.0
    b1 = (3 * t3 - 6 * t2 + 4) / 6.0
    b2 = (-3 * t3 + 3 * t2 + 3 * t + 1) / 6.0
    b3 = t3 / 6.0
    return b0, b1, b2, b3


def bspline_basis_matrix(n_vox, n_ctrl, ctrl_spacing_vox):
    """(n_vox, n_ctrl) dense cubic B-spline evaluation matrix.

    Control point j sits at position (j - 1) * ctrl_spacing_vox (one
    phantom point before the volume, ITK initializer style)."""
    m = np.zeros((n_vox, n_ctrl), dtype=np.float32)
    for x in range(n_vox):
        u = x / ctrl_spacing_vox
        i = int(np.floor(u))
        t = u - i
        weights = _cubic_bspline(np.float64(t))
        for k, w in enumerate(weights):
            j = i + k  # control index offset: ctrl j covers grid i-1..i+2
            if 0 <= j < n_ctrl:
                m[x, j] = w
    return m


def _densify(ctrl, Bz, By, Bx):
    """ctrl (3, Gz, Gy, Gx) planar -> (3, Z, Y, X) by separable
    contractions (channel axis leads: no per-step transposes)."""
    out = torch.einsum("zg,cgyx->czyx", Bz, ctrl)
    out = torch.einsum("yh,czhx->czyx", By, out)
    return torch.einsum("xk,czyk->czyx", Bx, out)


@full_float32()
def _bspline_fit(fixed, moving, fixed_mask, moving_mask, Bz, By, Bx, sp,
                 lr, steps, metric="mse", bins=32, base_mm=None):
    """Adam on the control points. Tensors on one device; moving_mask
    None or a (Z, Y, X) mask warped with the image (ITK semantics: a
    sample counts only where the warped moving mask is on); metric
    'mse', or 'mi' / 'ncc' through the rigid model's ``_metric_loss``;
    ``base_mm`` None or a planar (3, Z, Y, X) mm field the spline adds to
    (an elastix level's warm start). Returns ((Z, Y, X, 3) mm field,
    losses (steps,)), both on the device; nothing here waits for the
    device."""
    with_mmask = moving_mask is not None
    stack = torch.stack([moving, moving_mask]) if with_mmask \
        else moving[None]
    sample_disp = make_disp_sampler(stack, 0.0)
    spc = sp[:, None, None, None]

    def total_disp(ctrl):
        d = _densify(ctrl, Bz, By, Bx)
        return d if base_mm is None else d + base_mm

    def loss_fn(ctrl):
        w_all = sample_disp(total_disp(ctrl) / spc)
        warped = w_all[0]
        w = fixed_mask * w_all[1] if with_mmask else fixed_mask
        if metric == "mse":
            diff = (fixed - warped) * w
            sim = torch.sum(diff * diff) / torch.clamp(torch.sum(w), min=1.0)
        else:
            sim = _metric_loss(metric, warped, fixed, w, bins=bins)
        # light bending-energy regularizer keeps the field smooth
        reg = torch.mean(torch.square(torch.diff(ctrl, dim=1))) \
            + torch.mean(torch.square(torch.diff(ctrl, dim=2))) \
            + torch.mean(torch.square(torch.diff(ctrl, dim=3)))
        return sim + 1e-3 * reg

    ctrl = torch.zeros((3, Bz.shape[1], By.shape[1], Bx.shape[1]),
                       dtype=torch.float32, device=fixed.device)
    state = adam_init(ctrl)
    losses = torch.empty(steps, dtype=torch.float32, device=fixed.device)
    for k in range(steps):
        ctrl.requires_grad_(True)
        loss = loss_fn(ctrl)
        (g,) = torch.autograd.grad(loss, ctrl)
        update, state = adam_update(g, state, lr)
        ctrl = (ctrl.detach() + update).detach()
        losses[k] = loss.detach()
    with torch.no_grad():
        return torch.movedim(total_disp(ctrl), 0, -1), losses


def bspline_registration(fixed, moving, spacing_xyz=(1.0, 1.0, 1.0),
                         control_spacing=None, mesh_size=None,
                         iterations=100, lr=0.5, fixed_mask=None,
                         moving_mask=None, device=None):
    """Fit a cubic B-spline FFD; returns ((Z, Y, X, 3) DVF mm, losses),
    both numpy.

    ``control_spacing`` in mm (default [50, 50, 50]); ``mesh_size``
    overrides the grid resolution. The returned field is the sampling
    field: moving(x + d(x)) ~ fixed(x). ``moving_mask`` (ITK semantics)
    warps with the image and gates the loss where the warped mask is
    on. ``device``: where the fit runs (default: the card when present);
    the volumes and masks may be arrays or tensors.
    """
    device = default_device() if device is None else torch.device(device)
    fixed = as_f32(fixed, device)
    moving = as_f32(moving, device)
    Z, Y, X = fixed.shape
    sp = np.asarray(spacing_xyz, dtype=np.float32)

    if control_spacing is None:
        control_spacing = [50.0, 50.0, 50.0]
    if mesh_size is None:
        physical = [X * sp[0], Y * sp[1], Z * sp[2]]
        mesh_size = [max(1, int(psz / csp))
                     for psz, csp in zip(physical, control_spacing)]
    # control grid: mesh_size spans + 3 (cubic support), per axis (x,y,z)
    gx, gy, gz = (int(m) + 3 for m in mesh_size)
    csx = X / max(mesh_size[0], 1)
    csy = Y / max(mesh_size[1], 1)
    csz = Z / max(mesh_size[2], 1)

    def dev(a):
        return as_f32(a, device)

    fmask = torch.ones_like(fixed) if fixed_mask is None else fixed_mask
    mmask = None if moving_mask is None else dev(moving_mask)
    dvf, losses = _bspline_fit(
        fixed, moving, dev(fmask), mmask,
        dev(bspline_basis_matrix(Z, gz, csz)),
        dev(bspline_basis_matrix(Y, gy, csy)),
        dev(bspline_basis_matrix(X, gx, csx)), dev(sp), float(lr),
        int(iterations))
    return dvf.cpu().numpy(), losses.cpu().numpy()


_ELASTIX_METRICS = {
    "AdvancedMeanSquares": "mse",
    "AdvancedMattesMutualInformation": "mi",
    "AdvancedNormalizedCorrelation": "ncc",
}

_ELASTIX_LINEAR_MODES = {
    "TranslationTransform": "rigid",
    "EulerTransform": "rigid",
    "SimilarityTransform": "similarity",
    "AffineTransform": "affine",
}


def _pm_flat(pm):
    """Elastix-style values are one-element string lists; flatten."""
    return {k: (v[0] if isinstance(v, (list, tuple)) else v)
            for k, v in dict(pm).items()}


def _linear_levels(resolutions, iterations):
    """Coarse-to-fine (stride, steps, lr) schedule for a linear stage
    from its elastix NumberOfResolutions / MaximumNumberOfIterations."""
    res = int(max(1, min(int(resolutions), 4)))
    steps = int(max(10, min(int(iterations), 400) // res))
    return tuple((2 ** (res - 1 - lev), steps, 0.3 * (0.33 ** lev))
                 for lev in range(res))


class _Grid:
    """Image-like shim: both volumes share the fixed grid (identity
    orientation, origin 0) by the time they reach the registration."""

    def __init__(self, arr, sp):
        self.array = arr
        self.matrix = np.eye(3)
        self.spacing = sp.copy()
        self.origin = np.zeros(3)


def _gradient_magnitude64(a):
    """|grad a| in float64 with central differences per voxel (the JAX
    package's np.gradient recipe), on the tensor's device."""
    gz, gy, gx = torch.gradient(a.to(torch.float64))
    return torch.sqrt(gz * gz + gy * gy + gx * gx)


def _elastix_staged(fixed, moving, spacing_xyz, stages, metric, bins,
                    iterations, fixed_mask, moving_mask, device,
                    info=None):
    """Elastix multi-stage parameter maps (the SimpleElastix vector-of-
    maps form): linear stage(s) — Translation/Euler/Similarity/Affine, on
    the rigid_intensity descent — warm-start the final BSpline stage. All
    stages compose into ONE point-displacement field on the fixed grid:
    moving(M @ (p + b(p))) ~ fixed(p), so d(p) = M (p + b(p)) - p with M
    the composed linear matrix (fixed -> moving physical) and b the
    B-spline field fitted between fixed and the M-resampled moving."""
    from ...models.rigid_intensity import (_MODE_NPARAMS,
                                           register_rigid_intensity)
    from ..resample import affine_resample
    from .phase_correlation import phase_correlation

    fixed = torch.as_tensor(fixed).to(device=device, dtype=torch.float32)
    moving = torch.as_tensor(moving).to(device=device, dtype=torch.float32)
    sp = np.asarray(spacing_xyz, np.float64).reshape(-1)
    S = np.diag([sp[0], sp[1], sp[2], 1.0])
    Sinv = np.linalg.inv(S)

    kinds = [st.get("Transform", "BSplineTransform") for st in stages]
    for k in kinds:
        if k != "BSplineTransform" and k not in _ELASTIX_LINEAR_MODES:
            raise ValueError(f"elastix: unsupported Transform {k!r}")
    if kinds.count("BSplineTransform") > 1:
        raise ValueError("elastix: at most one BSplineTransform stage")
    if "BSplineTransform" in kinds \
            and kinds.index("BSplineTransform") != len(kinds) - 1:
        raise ValueError("elastix: the BSplineTransform stage must be "
                         "last")

    M_total = np.eye(4)
    mov_cur = moving
    mmask_cur = moving_mask
    bg = float(moving.min())
    b_field = None
    losses_all = []
    stage_info = []
    for st in stages:
        kind = st.get("Transform", "BSplineTransform")
        t0 = time.perf_counter()
        if kind in _ELASTIX_LINEAR_MODES:
            st_metric = _ELASTIX_METRICS.get(str(st.get("Metric", "")),
                                             metric)
            levels = _linear_levels(
                st.get("NumberOfResolutions", 3),
                st.get("MaximumNumberOfIterations", 120))
            mode = _ELASTIX_LINEAR_MODES[kind]
            # elastix's AutomaticTransformInitialization (default on):
            # phase correlation of the GRADIENT MAGNITUDES (contrast-
            # inversion invariant) seeds the descent; differing-shape
            # pairs skip the seed
            pose0 = None
            response = None
            auto_init = str(st.get("AutomaticTransformInitialization",
                                   "true")).lower() != "false"
            if auto_init and fixed.shape != mov_cur.shape:
                auto_init = False
            if auto_init and np.allclose(M_total, np.eye(4)):
                shift, response = phase_correlation(
                    _gradient_magnitude64(fixed),
                    _gradient_magnitude64(mov_cur), spacing_xyz=sp)
                if response > 0.02:
                    pose0 = np.zeros(_MODE_NPARAMS[mode], np.float32)
                    pose0[3:6] = shift[::-1]  # (z,y,x) mm -> (x,y,z)
            mat, rinfo = register_rigid_intensity(
                _Grid(fixed, sp), _Grid(mov_cur, sp), metric=st_metric,
                mode=mode, pose0=pose0, levels=levels, device=device)
            losses_all.append(np.float32([rinfo["loss"]]))
            # mov_cur(p) = moving(M_total p) and the stage matched
            # mov_cur(mat p) to fixed(p): compose right
            M_total = M_total @ mat
            P = Sinv @ M_total @ S  # fixed voxel -> moving voxel
            mov_cur = affine_resample(moving, P, tuple(fixed.shape),
                                      background=bg)
            # warp the moving-domain mask with the image (ITK Mattes
            # semantics); a ones-mask stands in when none is given
            base_mask = torch.ones_like(moving) if moving_mask is None \
                else torch.as_tensor(moving_mask).to(
                    device=device, dtype=torch.float32)
            mmask_cur = (affine_resample(base_mask, P, tuple(fixed.shape),
                                         background=0.0) > 0.5) \
                .to(torch.float32)
            stage_info.append(dict(transform=kind, mode=mode,
                                   seed_response=response,
                                   seeded=pose0 is not None,
                                   level_seconds=rinfo["level_seconds"]))
        else:
            level_info = {}
            dvf, losses = _elastix_pyramid(
                fixed, mov_cur, sp, st, metric, bins, 4, 10.0, iterations,
                0.25, fixed_mask, mmask_cur, device, level_info)
            b_field = dvf.to(torch.float64)
            losses_all.append(losses.cpu().numpy().ravel())
            stage_info.append(dict(transform=kind, **level_info))
        stage_info[-1]["seconds"] = time.perf_counter() - t0

    Z, Y, X = fixed.shape
    with full_float32():
        p = torch.stack(torch.meshgrid(
            torch.arange(Z, dtype=torch.float64, device=device) * sp[2],
            torch.arange(Y, dtype=torch.float64, device=device) * sp[1],
            torch.arange(X, dtype=torch.float64, device=device) * sp[0],
            indexing="ij")[::-1], dim=-1)
        q = p if b_field is None else p + b_field
        R = torch.as_tensor(M_total[:3, :3], device=device)
        t = torch.as_tensor(M_total[:3, 3], device=device)
        d = ((q @ R.T + t) - p).to(torch.float32)
    losses = (np.concatenate(losses_all) if losses_all
              else np.zeros(0, np.float32))
    if info is not None:
        info["stages"] = stage_info
        info["matrix"] = M_total
    return d.cpu().numpy(), losses


def elastix_registration(fixed, moving, spacing_xyz=(1.0, 1.0, 1.0),
                         parameter_map=None, metric="mi", bins=32,
                         resolutions=4, final_grid_spacing=10.0,
                         iterations=256, lr=0.25, fixed_mask=None,
                         moving_mask=None, device=None, info=None):
    """Elastix-parity multi-resolution B-spline registration.

    The schedule of SimpleElastix's "nonrigid" default parameter map
    (reference utils/deformable/simpleitk.py:131-176): ``resolutions``
    levels coarse-to-fine, both the image and the control grid halving
    per level (grid spacing = final_grid_spacing * 2^l), Mattes mutual
    information (default), mean squares or normalized correlation, and
    ``iterations`` Adam steps a level. Each level warm-starts additively
    from the previous level's field: loss(ctrl) = metric(fixed_l,
    moving(x + base_mm + B ctrl)).

    ``parameter_map`` takes the elastix keys (values may be one-element
    string lists): Metric, NumberOfHistogramBins, NumberOfResolutions,
    FinalGridSpacingInPhysicalUnits, MaximumNumberOfIterations — or a
    SEQUENCE of stage maps keyed by Transform (see
    :func:`_elastix_staged`). Volumes (arrays or tensors) go to
    ``device`` (default: the card). Returns ((Z, Y, X, 3) DVF mm,
    losses), numpy; ``info`` receives the level shapes, control grids,
    steps and seconds (a staged map's: each stage's).
    """
    device = default_device() if device is None else torch.device(device)
    if parameter_map is not None and isinstance(
            parameter_map, (list, tuple)):
        return _elastix_staged(fixed, moving, spacing_xyz,
                               [_pm_flat(p) for p in parameter_map],
                               metric=metric, bins=bins,
                               iterations=iterations,
                               fixed_mask=fixed_mask,
                               moving_mask=moving_mask, device=device,
                               info=info)
    dvf, losses = _elastix_pyramid(
        fixed, moving, spacing_xyz, parameter_map, metric, bins,
        resolutions, final_grid_spacing, iterations, lr, fixed_mask,
        moving_mask, device, info)
    return dvf.cpu().numpy(), losses.cpu().numpy()


def _elastix_pyramid(fixed, moving, spacing_xyz, parameter_map, metric,
                     bins, resolutions, final_grid_spacing, iterations, lr,
                     fixed_mask, moving_mask, device, info):
    """The B-spline level pyramid of one map (its keys override the
    arguments); returns the (Z, Y, X, 3) field and the losses, tensors
    on ``device``."""
    if parameter_map:
        pm = _pm_flat(parameter_map)
        if "Metric" in pm:
            metric = _ELASTIX_METRICS.get(str(pm["Metric"]), metric)
        bins = int(pm.get("NumberOfHistogramBins", bins))
        resolutions = int(pm.get("NumberOfResolutions", resolutions))
        final_grid_spacing = float(
            pm.get("FinalGridSpacingInPhysicalUnits", final_grid_spacing))
        iterations = int(pm.get("MaximumNumberOfIterations", iterations))

    from .demons import _downsample_volume, _upsample_field

    def dev(a):
        return torch.as_tensor(a).to(device=device, dtype=torch.float32)

    fixed = dev(fixed)
    moving = dev(moving)
    if metric == "mi":
        # Mattes bins each image over its own range: normalize
        # independently to [0, 1] (zero-range volumes stay flat)
        def norm(a):
            lo, hi = float(a.min()), float(a.max())
            return (a - lo) / (hi - lo) if hi > lo else a * 0.0
        fixed = norm(fixed)
        moving = norm(moving)
    fmask = None if fixed_mask is None else dev(fixed_mask)
    mmask = None if moving_mask is None else dev(moving_mask)

    sp_full = np.asarray(spacing_xyz, np.float32)
    base_mm = None
    losses_all, shapes, grids, seconds = [], [], [], []
    for lev in range(int(resolutions)):
        t0 = time.perf_counter()
        factor = 2 ** (int(resolutions) - 1 - lev)

        def down(v):
            return _downsample_volume(v, factor) if factor > 1 else v

        f_l, m_l = down(fixed), down(moving)
        ratio = np.asarray([fixed.shape[2] / f_l.shape[2],
                            fixed.shape[1] / f_l.shape[1],
                            fixed.shape[0] / f_l.shape[0]], np.float32)
        sp_l = sp_full * ratio
        fm_l = torch.ones_like(f_l) if fmask is None else down(fmask)
        # MI/NCC must EXCLUDE out-of-domain samples, not see the fill
        # value: warp a ones-mask (ITK Mattes semantics) when no moving
        # mask is given
        if mmask is not None:
            mm_l = down(mmask)
        elif metric != "mse":
            mm_l = torch.ones_like(m_l)
        else:
            mm_l = None

        Zl, Yl, Xl = f_l.shape
        grid_mm = final_grid_spacing * factor
        mesh = [max(1, int(n * s / grid_mm))
                for n, s in zip((Xl, Yl, Zl), sp_l)]
        gx, gy, gz = (int(m) + 3 for m in mesh)
        base_l = None
        if base_mm is not None:
            base_l = torch.movedim(_upsample_field(base_mm, f_l.shape),
                                   -1, 0)                # planar mm
        base_mm, losses = _bspline_fit(
            f_l, m_l, fm_l, mm_l,
            dev(bspline_basis_matrix(Zl, gz, Zl / mesh[2])),
            dev(bspline_basis_matrix(Yl, gy, Yl / mesh[1])),
            dev(bspline_basis_matrix(Xl, gx, Xl / mesh[0])), dev(sp_l),
            float(lr), int(iterations), metric=metric, bins=int(bins),
            base_mm=base_l)
        losses_all.append(losses)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        shapes.append([Zl, Yl, Xl])
        grids.append([gz, gy, gx])
    if info is not None:
        info.update(level_shapes=shapes, control_grids=grids,
                    steps=int(iterations), level_seconds=seconds)
    return base_mm, torch.cat(losses_all)
