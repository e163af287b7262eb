"""Displacement-vector-field primitives.

Port of medicalimageanalysis_tpu/ops/registration/dvf.py
(``warp_volume``, ``invert_dvf`` / ``_invert_planar``, ``compose_dvf`` /
``_compose_planar``, ``gradient_magnitude``):

- :func:`warp_volume` — out(x) = vol(x + d(x)), d in physical mm on the
  output grid;
- :func:`invert_dvf` — fixed-point inversion v <- -d(x + v(x));
- :func:`compose_dvf` — field composition (u after v);
- :func:`gradient_magnitude` — central differences over spacing;
- :func:`sample_dvf_at_points` — the field at physical points (ROI mesh
  and POI warps).

Public fields are (Z, Y, X, 3) with mm components in (x, y, z) order.
Internally the iterations keep the field planar (3, Z, Y, X) in voxels
and feed it straight to the warp kernel's ``disp`` mode: every warp here
is one ``torch.ops.mia_torch.warp_disp`` launch on the card, and the
point sample one ``warp_coords`` launch with B = 3 over the planar field.

The JAX package sizes a slab window from each field, checks the kernel's
overflow counter and redoes the work on an XLA gather when it
overflowed; the CUDA kernel has no slab, so none of that is here.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import as_f32
from ..warp import warp_disp

__all__ = ["warp_volume", "invert_dvf", "compose_dvf", "gradient_magnitude",
           "sample_dvf_at_points"]


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


def point_sample_inputs(dvf, points, origin, spacing_xyz, mode_nearest=True):
    """The ``warp_coords`` inputs of :func:`sample_dvf_at_points`: the
    planar (3, Z, Y, X) mm field and the (1, 1, N) float32 voxel
    coordinates cz, cy, cx of ``points`` (N, 3) mm on the float32 field
    tensor ``dvf``'s device. Voxel coordinates are computed in float64
    and, under ``mode_nearest``, clamped into the grid before the cast."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    voxel = (pts - np.asarray(origin)) / np.asarray(spacing_xyz)
    if mode_nearest:
        Z, Y, X = dvf.shape[:3]
        voxel = np.clip(voxel, 0, [X - 1, Y - 1, Z - 1])
    c = torch.as_tensor(voxel.astype(np.float32), device=dvf.device)
    cx, cy, cz = (c[:, k].reshape(1, 1, -1).contiguous() for k in range(3))
    return torch.movedim(dvf, -1, 0).contiguous(), cz, cy, cx


def sample_dvf_at_points(dvf_mm, points, origin, spacing_xyz,
                         mode_nearest=True, device=None):
    """Trilinear samples of the (Z, Y, X, 3) mm field at physical
    ``points`` (N, 3) mm -> (N, 3) float64 mm (mesh warping, reference
    structure/deformable.py:961-1001); samples outside the grid are 0.
    The three components are one ``warp_coords`` launch with B = 3 over
    the planar field (:func:`point_sample_inputs`), on the field's device
    (a tensor's own, else ``device`` or the card)."""
    dvf = as_f32(dvf_mm, device)
    if np.size(points) == 0:
        return np.zeros((0, 3))
    planar, cz, cy, cx = point_sample_inputs(dvf, points, origin,
                                             spacing_xyz, mode_nearest)
    out = torch.ops.mia_torch.warp_coords(planar, cz, cy, cx, 0.0, False)[0]
    return out.reshape(3, -1).T.to(torch.float64).cpu().numpy()
