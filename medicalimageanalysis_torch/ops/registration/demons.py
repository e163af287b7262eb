"""Demons deformable registration.

Port of medicalimageanalysis_tpu/ops/registration/demons.py: Thirion
demons and its fast (symmetric), diffeomorphic and biomechanical
variants, ANTs-CC LNCC forces, greedy SyN, and the coarse-to-fine
pyramid of ``demons_registration``.

Update rule (Thirion, as in ITK): for difference D = f - m(x+u) and
gradient g (fixed grad, or symmetric mean for the fast variant):
    du = D * g / (|g|^2 + D^2 / K),  K = mean voxel spacing squared
Diffeomorphic composes exp(du) into the field instead of adding.

The JAX package runs each level as one ``fori_loop`` inside one jit;
here each level is a plain Python loop over device tensors under
``torch.no_grad()``. Every warp of the loop is one launch of the warp
kernel's ``disp`` mode on the card (the moving image and its three
gradient components batched in one launch for the symmetric and LNCC
variants). The field smoothing and the LNCC box sums are full-float32
matrix contractions (``device.full_float32``): TF32 would destroy the
E[x^2] - E[x]^2 cancellation of the LNCC moments, as the TPU's bf16
default did in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import as_f32, default_device, full_float32
from ...telemetry import trace
from ..filters import _gauss_kernel_matrix
from ..resample import _separable_apply, separable_resample
from ..warp import warp_disp
from .dvf import _compose_planar, compose_dvf, invert_dvf

__all__ = ["demons_registration"]

METHODS = ("demons", "fast", "diffeomorphic", "biomechanical", "syn")


def _spatial_gradient_planar(vol, sp):
    """(3, Z, Y, X) planar gradient, rows (d/dx, d/dy, d/dz) / spacing."""
    gz, gy, gx = torch.gradient(vol)
    return torch.stack([gx / sp[0], gy / sp[1], gz / sp[2]])


@full_float32()
def _smooth_field(u, mz, my, mx):
    """Separable Gaussian over a planar (3, Z, Y, X) field: one batched
    contraction per axis, in full float32."""
    out = torch.einsum("ij,cjyx->ciyx", mz, u)
    out = torch.einsum("kj,czjx->czkx", my, out)
    return torch.einsum("lj,czyj->czyl", mx, out)


def _box_matrix(n, radius):
    """(n, n) banded ones matrix: applying it along an axis is the
    axis's windowed box sum (radius voxels each side)."""
    i = np.arange(n)
    return (np.abs(i[:, None] - i[None, :]) <= radius).astype(np.float32)


# Separable windowed sum over a (Z, Y, X) volume. Full float32 is
# load-bearing: the LNCC variances come from moment cancellation.
_box_sum = _separable_apply


def _lncc_moments(vol, lz, ly, lx, cnt):
    """Windowed (mean-removed value, variance) of one volume."""
    mu = _box_sum(vol, lz, ly, lx) / cnt
    var = torch.clamp(_box_sum(vol * vol, lz, ly, lx) / cnt - mu ** 2,
                      min=0.0)
    return vol - mu, var


def _lncc_force(i_a, var_a, i_b, var_b, cross, g_b, v_eps):
    """ANTs-CC gradient force pushing image b toward image a (Avants
    2008), riding b's own warped gradient g_b."""
    base = 2.0 * cross / (var_a * var_b + v_eps)
    return (base * (i_a - cross / (var_b + v_eps) * i_b))[None] * g_b


def _normalize(upd_mm, peak, cap_only):
    """Scale a planar update so its largest vector is ``peak`` mm; with
    ``cap_only`` (the SSD forces) only ever shrink it."""
    max_norm = torch.sqrt(torch.max(torch.sum(upd_mm * upd_mm, dim=0)))
    if cap_only:
        return upd_mm * torch.clamp(
            peak / torch.clamp(max_norm, min=1e-9), max=1.0)
    return upd_mm * (peak / torch.clamp(max_norm, min=1e-12))


def _thirion(diff, g, K, intensity_threshold):
    """Thirion's update D g / (|g|^2 + D^2 / K), 0 where |D| is below the
    threshold or the denominator vanishes."""
    denom = torch.sum(g * g, dim=0) + (diff * diff) / K
    active = (torch.abs(diff) > intensity_threshold) & (denom > 1e-9)
    return torch.where(active[None],
                       (diff / torch.clamp(denom, min=1e-9))[None] * g, 0.0)


def _exp_field(upd_vox):
    """exp of a planar voxel field by scaling and squaring (3 squarings)."""
    v = upd_vox / 8.0
    for _ in range(3):
        v = _compose_planar(v, v)
    return v


def _operators(shape, std_vox, lncc_radius, forces, device):
    """Gaussian smoothing matrices, and for LNCC the box matrices with
    the per-voxel window count."""
    def dev(m):
        return torch.as_tensor(m, device=device)

    gauss = [dev(_gauss_kernel_matrix(n, max(float(std_vox), 1e-3)))
             for n in shape]
    if forces != "lncc":
        return gauss, None
    box = [dev(_box_matrix(n, lncc_radius)) for n in shape]
    cnt = _box_sum(torch.ones(shape, dtype=torch.float32, device=device),
                   *box)
    return gauss, (box, cnt)


@torch.no_grad()
def _demons_core(fixed, moving, sp, std_vox, step, intensity_threshold,
                 iterations, method, smooth, elastic_lambda=0.2, u0=None,
                 forces="ssd", lncc_radius=3):
    """One level: returns the (Z, Y, X, 3) mm field.

    The loop holds the field planar (3, Z, Y, X) in voxels and warps
    through the ``disp`` mode. sp (and the update math) stays in
    (x, y, z) component order along the leading axis."""
    grad_f = _spatial_gradient_planar(fixed, sp)
    K = torch.mean(sp) ** 2
    spc = sp[:, None, None, None]
    (mz, my, mx), lncc = _operators(fixed.shape, std_vox, lncc_radius,
                                    forces, fixed.device)

    # the symmetric variants (and LNCC, whose force rides the moving
    # gradient) warp the moving image AND its gradient every iteration:
    # one launch for all four, sharing the coordinates
    symmetric = method in ("fast", "diffeomorphic", "biomechanical")
    if symmetric or forces == "lncc":
        warp_stack = torch.cat([moving[None],
                                _spatial_gradient_planar(moving, sp)])
    else:
        warp_stack = moving[None].contiguous()

    if lncc is not None:
        (lz, ly, lx), cnt = lncc
        # GLOBAL CENTERING is load-bearing numerics: LNCC is invariant
        # to a constant shift, and centering removes the E[x^2] - E[x]^2
        # cancellation on large raw intensities
        f_cent = fixed - torch.mean(fixed)
        m_shift = torch.mean(moving)
        i_f, var_f = _lncc_moments(f_cent, lz, ly, lx, cnt)
        mu_f = f_cent - i_f
        v_eps = 1e-5 * torch.clamp(torch.mean(var_f), min=1e-12)

    u = torch.zeros((3,) + tuple(fixed.shape), dtype=torch.float32,
                    device=fixed.device) if u0 is None else u0
    for _ in range(int(iterations)):
        w = warp_disp(warp_stack, u, 0.0)
        warped = w[0]
        if forces == "lncc":
            # the CC force differentiates wrt the warped moving image:
            # its own gradient is the only correct carrier
            g = w[1:4]
        elif symmetric:
            g = 0.5 * (grad_f + w[1:4])
        else:
            g = grad_f
        if forces == "lncc":
            w_cent = warped - m_shift
            i_m, var_m = _lncc_moments(w_cent, lz, ly, lx, cnt)
            mu_m = w_cent - i_m
            cross = _box_sum(f_cent * w_cent, lz, ly, lx) / cnt \
                - mu_f * mu_m
            upd_mm = _lncc_force(i_f, var_f, i_m, var_m, cross, g, v_eps)
            # smoothing before the peak normalisation (ANTs' update-field
            # smoothing), then normalise the peak update to `step` mm
            upd_mm = _normalize(_smooth_field(upd_mm, mz, my, mx), step,
                                False)
        else:
            upd_mm = _thirion(fixed - warped, g, K, intensity_threshold)
            if symmetric:
                upd_mm = _normalize(upd_mm, step, True)
        upd_vox = upd_mm / spc
        if method == "diffeomorphic":
            u_new = _compose_planar(u, _exp_field(upd_vox))
        else:
            u_new = u + upd_vox
        if smooth:
            u_new = _smooth_field(u_new, mz, my, mx)
        if method == "biomechanical":
            # linear-elastic relaxation: descent on 1/2 (div u)^2 ADDS
            # lambda * grad(div u)
            div = (torch.gradient(u_new[0], dim=2)[0]
                   + torch.gradient(u_new[1], dim=1)[0]
                   + torch.gradient(u_new[2], dim=0)[0])
            u_new = u_new + elastic_lambda * torch.stack(
                [torch.gradient(div, dim=2)[0],
                 torch.gradient(div, dim=1)[0],
                 torch.gradient(div, dim=0)[0]])
        u = u_new
    return torch.movedim(u, 0, -1) * sp               # voxels -> mm


@torch.no_grad()
def _syn_core(fixed, moving, sp, std_vox, step, intensity_threshold,
              iterations, smooth, forces, lncc_radius, u1_0=None,
              u2_0=None):
    """Greedy SyN (Avants et al., MedIA 2008): two diffeomorphic
    half-maps phi1 (fixed side) and phi2 (moving side) meet at the
    midpoint. Returns the half-fields (u1_mm, u2_mm), each (Z, Y, X, 3);
    the caller assembles u2 o u1^{-1} through :func:`invert_dvf`."""
    stack_f = torch.cat([fixed[None], _spatial_gradient_planar(fixed, sp)])
    stack_m = torch.cat([moving[None],
                         _spatial_gradient_planar(moving, sp)])
    K = torch.mean(sp) ** 2
    spc = sp[:, None, None, None]
    half = 0.5 * step
    (mz, my, mx), lncc = _operators(fixed.shape, std_vox, lncc_radius,
                                    forces, fixed.device)
    if lncc is not None:
        (lz, ly, lx), cnt = lncc
        # global centering constants (see _demons_core)
        f_shift = torch.mean(fixed)
        m_shift = torch.mean(moving)

    zero = torch.zeros((3,) + tuple(fixed.shape), dtype=torch.float32,
                       device=fixed.device)
    u1 = zero if u1_0 is None else u1_0
    u2 = zero if u2_0 is None else u2_0
    for _ in range(int(iterations)):
        wf = warp_disp(stack_f, u1, 0.0)
        wm = warp_disp(stack_m, u2, 0.0)
        fw, gfw = wf[0], wf[1:4]
        mw, gmw = wm[0], wm[1:4]
        if lncc is not None:
            fw_c = fw - f_shift
            mw_c = mw - m_shift
            i_fw, var_fw = _lncc_moments(fw_c, lz, ly, lx, cnt)
            i_mw, var_mw = _lncc_moments(mw_c, lz, ly, lx, cnt)
            cross = _box_sum(fw_c * mw_c, lz, ly, lx) / cnt \
                - (fw_c - i_fw) * (mw_c - i_mw)
            v_eps = 1e-5 * torch.clamp(torch.mean(var_fw), min=1e-12)
            f_m = _lncc_force(i_fw, var_fw, i_mw, var_mw, cross, gmw,
                              v_eps)
            f_f = _lncc_force(i_mw, var_mw, i_fw, var_fw, cross, gfw,
                              v_eps)
            f_m = _normalize(_smooth_field(f_m, mz, my, mx), half, False)
            f_f = _normalize(_smooth_field(f_f, mz, my, mx), half, False)
        else:
            diff = fw - mw
            f_m = _normalize(_thirion(diff, gmw, K, intensity_threshold),
                             half, True)
            f_f = _normalize(_thirion(-diff, gfw, K, intensity_threshold),
                             half, True)
        u1n = _compose_planar(u1, _exp_field(f_f / spc))
        u2n = _compose_planar(u2, _exp_field(f_m / spc))
        if smooth:
            u1n = _smooth_field(u1n, mz, my, mx)
            u2n = _smooth_field(u2n, mz, my, mx)
        u1, u2 = u1n, u2n
    return torch.movedim(u1, 0, -1) * sp, torch.movedim(u2, 0, -1) * sp


def _downsample_volume(vol, factor):
    Z, Y, X = vol.shape
    out = (max(Z // factor, 2), max(Y // factor, 2), max(X // factor, 2))
    return separable_resample(vol, out)


def _upsample_field(u_mm, out_shape):
    """Pyramid prolongation of a (Z, Y, X, 3) mm field: mm components
    are resolution-independent, so a separable trilinear resample per
    channel is exact."""
    return torch.stack([separable_resample(u_mm[..., c], out_shape)
                        for c in range(3)], dim=-1)


def demons_registration(fixed, moving, spacing_xyz=(1.0, 1.0, 1.0),
                        method="demons", smooth=True, std=1,
                        iterations=50, intensity_threshold=0.001,
                        step=2.0, elastic_lambda=0.2, pyramid=None,
                        forces="ssd", lncc_radius=3, device=None,
                        info=None):
    """Run a demons variant; returns the (Z, Y, X, 3) float32 numpy DVF
    in mm such that moving(x + d(x)) ~ fixed(x) on the fixed grid.

    method: 'demons' | 'fast' | 'diffeomorphic' | 'biomechanical' |
    'syn'; forces: 'ssd' | 'lncc'; pyramid: optional coarse-to-fine
    downsample factors, e.g. (4, 2, 1), each level running
    ``iterations`` iterations warm-started from the previous level's
    field (see the JAX package's ``demons_registration``).

    device: where the iterations run (default: the card when present).
    info: an optional dict that receives ``level_shapes``, the (Z, Y, X)
    grid of each level. Nothing here waits for the device: a level's
    time is read from a profiler trace, under its ``mia.demons.level``
    span.
    """
    if forces not in ("ssd", "lncc"):
        raise ValueError(f"demons: forces must be 'ssd' or 'lncc', "
                         f"got {forces!r}")
    method = str(method).lower()
    if method not in METHODS:
        raise ValueError(f"demons: unknown method {method!r}")
    device = default_device() if device is None else torch.device(device)
    with trace("mia.demons.inputs"):
        fixed = as_f32(fixed, device)
        moving = as_f32(moving, device)
        sp = as_f32(spacing_xyz, device)
    syn = method == "syn"

    if pyramid:
        pyramid = tuple(int(f) for f in pyramid)
        if pyramid[-1] != 1:
            # the contract is a fixed-grid field: finish at full size
            pyramid = pyramid + (1,)
    else:
        pyramid = (1,)
    out_mm = None
    halves_mm = None                     # (u1_mm, u2_mm) for syn
    shapes = []
    for factor in pyramid:
        with trace("mia.demons.level"):
            if factor > 1:
                f_l = _downsample_volume(fixed, factor)
                m_l = _downsample_volume(moving, factor)
            else:
                f_l, m_l = fixed, moving
            # physical voxel size grows with the factor
            ratio = torch.tensor(
                [fixed.shape[2] / f_l.shape[2],
                 fixed.shape[1] / f_l.shape[1],
                 fixed.shape[0] / f_l.shape[0]], dtype=torch.float32,
                device=device)
            sp_l = sp * ratio
            if syn:
                u1_0 = u2_0 = None
                if halves_mm is not None:
                    u1_0, u2_0 = [
                        torch.movedim(_upsample_field(h, f_l.shape) / sp_l,
                                      -1, 0).contiguous()
                        for h in halves_mm]
                halves_mm = _syn_core(
                    f_l, m_l, sp_l, float(std), float(step),
                    float(intensity_threshold), int(iterations),
                    bool(smooth), forces, int(lncc_radius), u1_0=u1_0,
                    u2_0=u2_0)
            else:
                u0 = None
                if out_mm is not None:
                    up = _upsample_field(out_mm, f_l.shape)
                    u0 = torch.movedim(up / sp_l, -1, 0).contiguous()
                out_mm = _demons_core(
                    f_l, m_l, sp_l, float(std), float(step),
                    float(intensity_threshold), int(iterations), method,
                    bool(smooth), float(elastic_lambda), u0=u0,
                    forces=forces, lncc_radius=int(lncc_radius))
        shapes.append(tuple(f_l.shape))
    if syn:
        # full map x -> phi2(phi1^{-1}(x)): with w = u1^{-1},
        # d = w + u2(x + w) = compose(u2, w); inverted once, at full size
        with torch.no_grad():
            w = invert_dvf(halves_mm[0], sp)
            out = compose_dvf(halves_mm[1], w, sp)
    else:
        out = out_mm
    if info is not None:
        info["level_shapes"] = shapes
    with trace("mia.demons.field_out"):
        return out.cpu().numpy()
