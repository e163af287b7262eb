"""B-spline free-form deformable registration.

Port of medicalimageanalysis_tpu/ops/registration/bspline.py
(``_cubic_bspline``, ``bspline_basis_matrix``, ``_bspline_fit``,
``bspline_registration``): a cubic B-spline control grid (default 50 mm
spacing) is densified to a displacement field by three separable
basis-matrix contractions, the masked loss differentiates through the
warp, and Adam (written out in ``optax.adam``'s float32 order) steps the
control points.

The warp is the kernel's ``disp`` mode with its fused coordinate
gradients (``ops.warp.make_disp_sampler``), on the card and, through its
plain twin, on the CPU alike: the backward pass restacks the gradients
the forward launch wrote and never gathers again. The densify
contractions run in full float32. The JAX package's slab-window checks
and refits (``bspline.py:200-243``) have no counterpart: the kernel has
no slab. ``elastix_registration`` and ``_elastix_staged`` wait for
``phase_correlation`` (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import as_f32, default_device, full_float32
from ...models.rigid_intensity import _metric_loss, adam_init, adam_update
from ..warp import make_disp_sampler

__all__ = ["bspline_registration", "bspline_basis_matrix"]


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
                 lr, steps, metric="mse", bins=32):
    """Adam on the control points. Tensors on one device; moving_mask
    None or a (Z, Y, X) mask warped with the image (ITK semantics: a
    sample counts only where the warped moving mask is on); metric
    'mse', or 'mi' / 'ncc' through the rigid model's ``_metric_loss``.
    (The JAX package's ``base_mm`` warm start serves only the elastix
    levels, which wait.) Returns ((Z, Y, X, 3) mm field, losses
    (steps,)), both on the device; nothing here waits for the device."""
    with_mmask = moving_mask is not None
    stack = torch.stack([moving, moving_mask]) if with_mmask \
        else moving[None]
    sample_disp = make_disp_sampler(stack, 0.0)
    spc = sp[:, None, None, None]

    def loss_fn(ctrl):
        w_all = sample_disp(_densify(ctrl, Bz, By, Bx) / spc)
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
        return torch.movedim(_densify(ctrl, Bz, By, Bx), 0, -1), losses


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
    on. ``device``: where the fit runs (default: the card when present).
    """
    fixed = np.asarray(fixed, dtype=np.float32)
    moving = np.asarray(moving, dtype=np.float32)
    Z, Y, X = fixed.shape
    sp = np.asarray(spacing_xyz, dtype=np.float32)
    device = default_device() if device is None else torch.device(device)

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

    fmask = np.ones_like(fixed) if fixed_mask is None else fixed_mask
    mmask = None if moving_mask is None else dev(moving_mask)
    dvf, losses = _bspline_fit(
        dev(fixed), dev(moving), dev(fmask), mmask,
        dev(bspline_basis_matrix(Z, gz, csz)),
        dev(bspline_basis_matrix(Y, gy, csy)),
        dev(bspline_basis_matrix(X, gx, csx)), dev(sp), float(lr),
        int(iterations))
    return dvf.cpu().numpy(), losses.cpu().numpy()
