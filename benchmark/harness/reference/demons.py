"""Fast symmetric-forces demons and the deformed image, written plainly.

The algorithm the port's ``Deformable.compute_demons(method="fast")``
and ``create_image`` state (ITK's FastSymmetricForcesDemons, the JAX
package's ``demons_registration``), followed from the published
description and the package's documented choices:

- a pyramid of downsampling factors, each level a trilinear resample at
  the shape ratio, warm-started from the previous level's field
  resampled trilinearly (mm components carry over unchanged);
- per iteration: warp the moving image and its gradient by the field
  (trilinear, background 0 outside [0, n-1] on any axis, taps clamped to
  the grid), the symmetric gradient g = (grad f + grad m(x+u)) / 2, the
  update D g / (|g|^2 + D^2 / K) with D = f - m(x+u), K the mean voxel
  spacing squared, zero where |D| <= the threshold or the denominator
  vanishes; its largest vector capped at ``step`` mm; added to the field
  in voxels, which is then smoothed by a Gaussian of ``std`` voxels
  (taps to 4 sigma, edges replicated);
- gradients by central differences (one-sided at the edges) over the
  level's spacing;
- the solver's sampling field is stored as a point displacement by a
  fixed-point inversion, v <- -d(x + v), 20 steps from v = -d;
- the deformed image inverts the stored field again and samples the
  moving image there, with the display background outside.

``dtype`` float64 is the reference; float32 with ``tf32`` True is the
control one precision step below the port's stated float32.
``strict_faces`` plants an edge fault: a sample that lies exactly on the
last slice, row or column falls to the background, as it would in a
kernel whose bound were strict.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

CHUNK_VOXELS = 1 << 22      # output voxels a gather step takes


def interp_matrix(n_out, n_in):
    """(n_out, n_in) linear interpolation at the shape ratio: output i
    samples input i * n_in / n_out, clamped to the grid."""
    src = np.clip(np.arange(n_out, dtype=np.float64) * (n_in / n_out), 0,
                  n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = src - lo
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.arange(n_out), lo), 1 - f)
    np.add.at(m, (np.arange(n_out), hi), f)
    return m


def gauss_matrix(n, sigma):
    """(n, n) Gaussian of ``sigma`` voxels, taps to ceil(4 sigma), edges
    replicated."""
    radius = max(1, int(np.ceil(4 * sigma)))
    offs = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (offs / sigma) ** 2)
    k /= k.sum()
    m = np.zeros((n, n))
    idx = np.arange(n)
    for o, w in zip(offs, k):
        np.add.at(m, (idx, np.clip(idx + o, 0, n - 1)), w)
    return m


class Plain:
    """The reference's arithmetic in one dtype on one device."""

    def __init__(self, dtype, device, strict_faces=False):
        self.dtype, self.device = dtype, device
        self.strict_faces = strict_faces

    def t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def separable(self, vol, mz, my, mx):
        """Matrices applied along z, y, x of (..., Z, Y, X)."""
        out = torch.einsum("ij,...jyx->...iyx", mz, vol)
        out = torch.einsum("kj,...zjx->...zkx", my, out)
        return torch.einsum("lj,...zyj->...zyl", mx, out)

    def resample(self, vol, out_shape):
        mats = [self.t(interp_matrix(o, i))
                for o, i in zip(out_shape, vol.shape[-3:])]
        return self.separable(vol, *mats)

    def gradient(self, vol, sp):
        gz, gy, gx = torch.gradient(vol)
        return torch.stack([gx / sp[0], gy / sp[1], gz / sp[2]])

    def sample(self, vols, cz, cy, cx, background):
        """vols (B, Z, Y, X) at voxel coordinates -> (B, *coords)."""
        B, Z, Y, X = vols.shape
        flat = vols.reshape(B, -1)
        shape = cz.shape
        cz, cy, cx = cz.reshape(-1), cy.reshape(-1), cx.reshape(-1)
        out = torch.empty((B, cz.numel()), dtype=self.dtype,
                          device=self.device)
        for a in range(0, cz.numel(), CHUNK_VOXELS):
            b = a + CHUNK_VOXELS
            z, y, x = cz[a:b], cy[a:b], cx[a:b]
            if self.strict_faces:
                inside = ((x >= 0) & (x < X - 1) & (y >= 0) & (y < Y - 1)
                          & (z >= 0) & (z < Z - 1))
            else:
                inside = ((x >= 0) & (x <= X - 1) & (y >= 0)
                          & (y <= Y - 1) & (z >= 0) & (z <= Z - 1))
            z0f, y0f, x0f = torch.floor(z), torch.floor(y), torch.floor(x)
            fz, fy, fx = z - z0f, y - y0f, x - x0f

            def taps(f, hi):
                t0 = torch.nan_to_num(f, nan=0.0).clamp(0, hi).long()
                return t0, torch.clamp(t0 + 1, max=hi)

            z0, z1 = taps(z0f, Z - 1)
            y0, y1 = taps(y0f, Y - 1)
            x0, x1 = taps(x0f, X - 1)
            acc = 0
            for zi, wz in ((z0, 1 - fz), (z1, fz)):
                for yi, wy in ((y0, 1 - fy), (y1, fy)):
                    for xi, wx in ((x0, 1 - fx), (x1, fx)):
                        idx = (zi * Y + yi) * X + xi
                        acc = acc + flat[:, idx] * (wz * wy * wx)
            out[:, a:b] = torch.where(inside, acc,
                                      torch.tensor(background,
                                                   dtype=self.dtype,
                                                   device=self.device))
        return out.reshape((B,) + tuple(shape))

    def grid(self, shape):
        Z, Y, X = shape
        o = dict(dtype=self.dtype, device=self.device)
        return (torch.arange(Z, **o)[:, None, None],
                torch.arange(Y, **o)[None, :, None],
                torch.arange(X, **o)[None, None, :])

    def warp(self, vols, u, background):
        """vols (B, Z, Y, X) at p + u(p); u planar (3, Z, Y, X) voxels,
        rows (x, y, z)."""
        zz, yy, xx = self.grid(u.shape[1:])
        return self.sample(vols, zz + u[2], yy + u[1], xx + u[0],
                           background)

    def fast_demons(self, fixed, moving, sp, pyramid, iterations, step,
                    std, threshold):
        """The sampling field (Z, Y, X, 3) mm of the full grid."""
        out_mm = None
        full = fixed.shape
        for factor in pyramid:
            shape = tuple(max(n // factor, 2) for n in full)
            f = self.resample(fixed, shape) if factor > 1 else fixed
            m = self.resample(moving, shape) if factor > 1 else moving
            sp_l = sp * self.t([full[2] / shape[2], full[1] / shape[1],
                                full[0] / shape[0]])
            spc = sp_l[:, None, None, None]
            K = torch.mean(sp_l) ** 2
            mats = [self.t(gauss_matrix(n, float(std))) for n in shape]
            grad_f = self.gradient(f, sp_l)
            stack = torch.cat([m[None], self.gradient(m, sp_l)])
            if out_mm is None:
                u = torch.zeros((3,) + shape, dtype=self.dtype,
                                device=self.device)
            else:
                up = self.resample(torch.movedim(out_mm, -1, 0), shape)
                u = up / spc
            for _ in range(int(iterations)):
                w = self.warp(stack, u, 0.0)
                g = 0.5 * (grad_f + w[1:4])
                diff = f - w[0]
                denom = torch.sum(g * g, 0) + diff * diff / K
                active = (torch.abs(diff) > threshold) & (denom > 1e-9)
                upd = torch.where(active[None],
                                  (diff / torch.clamp(denom, min=1e-9))[None]
                                  * g, torch.zeros((), dtype=self.dtype,
                                                   device=self.device))
                peak = torch.sqrt(torch.max(torch.sum(upd * upd, 0)))
                upd = upd * torch.clamp(step / torch.clamp(peak, min=1e-9),
                                        max=1.0)
                u = self.separable(u + upd / spc, *mats)
            out_mm = torch.movedim(u, 0, -1) * sp_l
        return out_mm

    def invert(self, field_mm, sp, steps=20):
        d = torch.movedim(field_mm / sp, -1, 0)
        v = -d
        for _ in range(steps):
            v = -self.warp(d, v, 0.0)
        return torch.movedim(v, 0, -1) * sp


@contextlib.contextmanager
def matmul_tf32(on):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def register_and_warp(fixed, moving, spacing, solver, background,
                      dtype=torch.float64, tf32=False, device="cpu",
                      strict_faces=False):
    """(point-displacement field (Z, Y, X, 3) mm, deformed moving image
    (Z, Y, X)) as numpy arrays, from the fixed and moving HU arrays on one
    grid of ``spacing`` [sx, sy, sz] mm. ``solver``: pyramid, iterations,
    step, std, intensity_threshold."""
    p = Plain(dtype, device, strict_faces)
    with torch.no_grad(), matmul_tf32(tf32):
        f = p.t(fixed)
        m = p.t(moving)
        sp = p.t(spacing)
        sampling = p.fast_demons(f, m, sp, tuple(solver["pyramid"]),
                                 solver["iterations"], solver["step"],
                                 solver["std"],
                                 solver["intensity_threshold"])
        del f
        point = p.invert(sampling, sp)
        del sampling
        back = p.invert(point, sp)
        warped = p.warp(m[None], torch.movedim(back / sp, -1, 0),
                        background)[0]
        return point.cpu().numpy(), warped.cpu().numpy()
