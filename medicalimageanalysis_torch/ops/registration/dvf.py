"""Displacement-vector-field primitives.

Port of medicalimageanalysis_tpu/ops/registration/dvf.py
(``warp_volume``, ``invert_dvf`` / ``_invert_planar``, ``compose_dvf`` /
``_compose_planar``, ``gradient_magnitude``):

- :func:`warp_volume` — out(x) = vol(x + d(x)), d in physical mm on the
  output grid;
- :func:`invert_dvf` — fixed-point inversion v <- -d(x + v(x));
- :func:`compose_dvf` — field composition (u after v);
- :func:`gradient_magnitude` — central differences over spacing.

Public fields are (Z, Y, X, 3) with mm components in (x, y, z) order.
Internally the iterations keep the field planar (3, Z, Y, X) in voxels
and feed it straight to the warp kernel's ``disp`` mode: every warp here
is one ``torch.ops.mia_torch.warp_disp`` launch on the card.

The JAX package sizes a slab window from each field, checks the kernel's
overflow counter and redoes the work on an XLA gather when it
overflowed; the CUDA kernel has no slab, so none of that is here.
``sample_dvf_at_points`` waits for the ROI-mesh slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import as_f32
from ..warp import warp_disp

__all__ = ["warp_volume", "invert_dvf", "compose_dvf", "gradient_magnitude"]


def _planar_vox(dvf_mm, sp):
    """(Z, Y, X, 3) mm -> contiguous (3, Z, Y, X) voxels."""
    return torch.movedim(dvf_mm / sp, -1, 0).contiguous()


def _same_kind(out, like):
    """``out`` as a tensor when ``like`` is one, else as a numpy array."""
    return out if isinstance(like, torch.Tensor) else out.cpu().numpy()


def warp_volume(volume, dvf_mm, spacing_xyz, background=0.0, device=None):
    """Warp: out(x) = volume(x + d(x)); d (Z, Y, X, 3) in mm on the same
    grid. Returns a float32 tensor on ``device`` (default: the volume's
    device when it is a tensor, else the card when present)."""
    vol = as_f32(volume, device)
    dvf = as_f32(dvf_mm, vol.device)
    sp = as_f32(spacing_xyz, vol.device)
    return warp_disp(vol, _planar_vox(dvf, sp), background)


def _invert_planar(field_b, iterations):
    """field_b (3, Z, Y, X) planar voxel displacements, rows (x, y, z);
    returns the inverse field in the same layout."""
    v = -field_b
    for _ in range(int(iterations)):
        v = -warp_disp(field_b, v, 0.0)
    return v


def invert_dvf(dvf_mm, spacing_xyz, iterations=20, device=None):
    """Fixed-point DVF inversion: returns v with (id + v) ~ (id + d)^-1,
    (Z, Y, X, 3) mm. A tensor in gives a tensor on its device; an array
    in gives an array (computed on ``device``, default the card when
    present)."""
    dvf = as_f32(dvf_mm, device)
    sp = as_f32(spacing_xyz, dvf.device)
    out = _invert_planar(_planar_vox(dvf, sp), iterations)
    return _same_kind(torch.movedim(out, 0, -1) * sp, dvf_mm)


def _compose_planar(u_b, v_b):
    """(u after v)(x) = u(x + v(x)) + v(x); planar (3, Z, Y, X) fields."""
    return warp_disp(u_b, v_b, 0.0) + v_b


def compose_dvf(u_mm, v_mm, spacing_xyz, device=None):
    """Compose two (Z, Y, X, 3) mm fields on the same grid; tensor or
    array out as :func:`invert_dvf`."""
    u = as_f32(u_mm, device)
    v = as_f32(v_mm, u.device)
    sp = as_f32(spacing_xyz, u.device)
    out = _compose_planar(_planar_vox(u, sp), _planar_vox(v, sp))
    return _same_kind(torch.movedim(out, 0, -1) * sp, u_mm)


def gradient_magnitude(volume, spacing_xyz=(1.0, 1.0, 1.0), device=None):
    """sitk.GradientMagnitude equivalent (central differences / spacing);
    a float32 tensor on the volume's device."""
    vol = as_f32(volume, device)
    sp = np.asarray(spacing_xyz, np.float32)
    gz, gy, gx = torch.gradient(vol)
    return torch.sqrt((gx / float(sp[0])) ** 2 + (gy / float(sp[1])) ** 2
                      + (gz / float(sp[2])) ** 2)
