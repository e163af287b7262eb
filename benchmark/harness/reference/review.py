"""A rigid overlay's view state and its three planes, written plainly.

The conventions the port's ``Rigid`` states (the reference package's
structure/rigid.py):

- the rigid ``matrix`` maps reference physical points to moving ones; a
  translation nudge t right-multiplies it by T(t) and moves the overlay's
  origin by -t without a reslice; a rotation nudge (Euler 'xyz' degrees)
  about the centre c = matrix @ (the reference's middle voxel, int(n/2)
  an axis) left-multiplies it by T(c) R T(-c), and the overlay is
  resliced;
- a reslice puts the moving volume onto an identity-direction grid with
  the reference's spacing that covers the moving volume's corners taken
  through the inverse matrix (lower corner at their minimum, round((hi -
  lo) / spacing) + 1 voxels an axis); a voxel at p samples the moving
  volume trilinearly at matrix @ p, the display background outside
  [0, n-1] on any axis;
- each plane is the overlay's slice through the reference display's
  centre voxel: index round((position - origin) / spacing), None where
  it falls outside.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation

PLANES = ("Axial", "Coronal", "Sagittal")


class ViewState:
    """The overlay's pose and grid, followed nudge by nudge in float64."""

    def __init__(self, ref_shape, ref_spacing, ref_origin, mov_shape,
                 mov_spacing, mov_origin):
        self.ref = (tuple(ref_shape), np.asarray(ref_spacing, np.float64),
                    np.asarray(ref_origin, np.float64))
        self.mov = (tuple(mov_shape), np.asarray(mov_spacing, np.float64),
                    np.asarray(mov_origin, np.float64))
        self.matrix = np.eye(4)
        self.grid = None               # (origin, dims (x, y, z), matrix)
        self.origin = None

    def reference_point(self, zyx_index):
        shape, sp, org = self.ref
        return org + sp * np.asarray(zyx_index[::-1], np.float64)

    def centre(self):
        shape, _, _ = self.ref
        mid = [int(n / 2) for n in shape]
        return (self.matrix @ np.append(self.reference_point(mid), 1.0))[:3]

    def reslice(self):
        shape, sp_m, org_m = self.mov
        Z, Y, X = shape
        corners = np.array([[x, y, z] for z in (0, Z - 1)
                            for y in (0, Y - 1) for x in (0, X - 1)],
                           np.float64) * sp_m + org_m
        inv = np.linalg.inv(self.matrix)
        out = corners @ inv[:3, :3].T + inv[:3, 3]
        lo, hi = out.min(0), out.max(0)
        sp = self.ref[1]
        dims = np.maximum(np.round((hi - lo) / sp).astype(int) + 1, 1)
        self.grid = (lo.copy(), dims, self.matrix.copy())
        self.origin = lo.copy()

    def translate(self, t):
        T = np.eye(4)
        T[:3, 3] = t
        self.matrix = self.matrix @ T
        if self.origin is not None:
            self.origin = self.origin - np.asarray(t, np.float64)

    def rotate(self, angles_deg):
        c = self.centre()
        R = np.eye(4)
        R[:3, :3] = Rotation.from_euler("xyz", angles_deg,
                                        degrees=True).as_matrix()
        Tn, Tp = np.eye(4), np.eye(4)
        Tn[:3, 3], Tp[:3, 3] = -c, c
        self.matrix = (Tp @ R @ Tn) @ self.matrix
        self.reslice()

    def plane_indices(self):
        """(z, y, x) indices of the planes in the overlay's grid."""
        shape, _, _ = self.ref
        mid = [int(n / 2) for n in shape]
        position = self.reference_point(mid)
        sp = self.ref[1]
        return np.flip(np.round((position - self.origin) / sp)
                       .astype(np.int32))

    def planes(self, moving, background, dtype, device):
        """{plane: (H, W) float64 numpy or None} of the overlay, sampled
        from ``moving`` (Z, Y, X) in ``dtype`` on ``device``."""
        lo, dims, matrix = self.grid
        sp = self.ref[1]
        nx, ny, nz = (int(v) for v in dims)
        kz, ky, kx = (int(v) for v in self.plane_indices())
        vol = torch.as_tensor(moving, device=device).to(dtype)
        out = {}
        for plane, k, n in (("Axial", kz, nz), ("Coronal", ky, ny),
                            ("Sagittal", kx, nx)):
            if not 0 <= k < n:
                out[plane] = None
                continue
            z = np.arange(nz) if plane != "Axial" else np.array([k])
            y = np.arange(ny) if plane != "Coronal" else np.array([k])
            x = np.arange(nx) if plane != "Sagittal" else np.array([k])
            zz, yy, xx = np.meshgrid(z, y, x, indexing="ij")
            p = np.stack([xx, yy, zz], -1).astype(np.float64) * sp + lo
            q = p @ matrix[:3, :3].T + matrix[:3, 3]
            shape_m, sp_m, org_m = self.mov
            pix = (q - org_m) / sp_m
            vals = sample(vol, torch.as_tensor(pix, device=device)
                          .to(dtype), background)
            out[plane] = np.squeeze(vals.to(torch.float64).cpu().numpy(),
                                    axis={"Axial": 0, "Coronal": 1,
                                          "Sagittal": 2}[plane])
        return out


def sample(vol, pix, background):
    """vol (Z, Y, X) at pixel coordinates pix (..., 3) (x, y, z):
    trilinear, taps clamped, ``background`` outside [0, n-1]."""
    Z, Y, X = vol.shape
    x, y, z = pix[..., 0], pix[..., 1], pix[..., 2]
    inside = ((x >= 0) & (x <= X - 1) & (y >= 0) & (y <= Y - 1)
              & (z >= 0) & (z <= Z - 1))
    flat = vol.reshape(-1)
    acc = 0
    parts = []
    for c, n in ((z, Z), (y, Y), (x, X)):
        # the taps in integers: a low precision cannot hold n - 1
        floor = torch.floor(c)
        f = c - floor
        i0 = torch.clamp(torch.nan_to_num(floor.double(), nan=0.0), 0,
                         n - 1).long()
        i1 = torch.clamp(i0 + 1, max=n - 1)
        parts.append(((i0, 1 - f), (i1, f)))
    for zi, wz in parts[0]:
        for yi, wy in parts[1]:
            for xi, wx in parts[2]:
                acc = acc + flat[(zi * Y + yi) * X + xi] * (wz * wy * wx)
    return torch.where(inside, acc, torch.tensor(background, dtype=vol.dtype,
                                                 device=vol.device))
