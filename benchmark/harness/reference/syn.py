"""Greedy SyN with ANTs-CC forces and the deformed image, written plainly.

The algorithm the port's ``Deformable.compute_demons(method="syn",
forces="lncc")`` and ``create_image`` state (Avants et al., Med Image
Anal 2008;12:26, greedy SyN with the cross-correlation metric of ANTs),
followed from the published description and the port's documented
choices:

- a pyramid of downsampling factors, each level a trilinear resample at
  the shape ratio, both half-fields warm-started from the previous
  level's, resampled trilinearly (mm components carry over unchanged);
  each level runs its own iteration count;
- per iteration, each image and its gradient warped by its own half
  (trilinear, background 0 outside [0, n-1] on any axis); gradients by
  central differences (one-sided at the edges) over the level's spacing;
- the local cross-correlation's moments over a (2r+1)^3 window clipped
  to the grid, each windowed sum divided by the voxels the window holds
  there, on intensities centred by their global mean (LNCC is invariant
  to the shift, and the centring keeps E[x^2] - E[x]^2 from cancelling);
- the ANTs-CC force 2 <IJ> / (<II><JJ> + e) (I - <IJ> / (<JJ> + e) J)
  riding the warped gradient of the image it moves, e = 1e-5 times the
  mean fixed-side variance;
- each force smoothed by a Gaussian of ``std`` voxels (taps to 4 sigma,
  edges replicated) and scaled so its largest vector is half ``step`` mm;
- each half composed with exp of its update, by scaling by 1/8 and three
  squarings: phi <- phi o exp(v), (u o v)(x) = u(x + v(x)) + v(x);
- the total field's smoothing only where ``smooth`` (ANTs' total-field
  variance, 0 in the cell);
- at the end the fixed half inverted (20 fixed-point steps, v <- -d(x +
  v) from v = -d) and the moving half composed with that inverse: the
  sampling field u2 o u1^{-1} of the full grid.

The store and ``create_image`` then follow ``reference/demons.py``, whose
sampling, inversion and contractions this module uses. ``dtype`` float64
is the reference; float32 with ``tf32`` True the control one precision
step below the port's stated float32 on the card; ``contract`` bfloat16
puts every matrix contraction in bfloat16, the control of the CPU tests
(which have no TF32). ``strict_faces`` plants reference/demons.py's edge
fault: a sample exactly on the last slice, row or column falls to the
background.
"""

from __future__ import annotations

import numpy as np
import torch

from .demons import Plain, gauss_matrix, matmul_tf32


def box_matrix(n, radius):
    """(n, n) ones where |i - j| <= radius: a windowed sum along an axis,
    the window clipped to the grid."""
    i = np.arange(n)
    return (np.abs(i[:, None] - i[None, :]) <= radius).astype(np.float64)


class PlainSyn(Plain):
    """The reference's arithmetic in one dtype on one device, with the
    contractions optionally in a lower dtype."""

    def __init__(self, dtype, device, contract=None, strict_faces=False):
        super().__init__(dtype, device, strict_faces)
        self.contract = contract

    def separable(self, vol, mz, my, mx):
        if self.contract is None:
            return super().separable(vol, mz, my, mx)
        c = self.contract
        return super().separable(vol.to(c), mz.to(c), my.to(c),
                                 mx.to(c)).to(self.dtype)

    def compose(self, u, v):
        """(u o v)(x) = u(x + v(x)) + v(x), planar voxel fields."""
        return self.warp(u, v, 0.0) + v

    def exp(self, v):
        v = v / 8.0
        for _ in range(3):
            v = self.compose(v, v)
        return v

    def moments(self, vol, box, cnt):
        """(vol - windowed mean, windowed variance)."""
        mu = self.separable(vol, *box) / cnt
        var = torch.clamp(self.separable(vol * vol, *box) / cnt - mu * mu,
                          min=0.0)
        return vol - mu, var

    @staticmethod
    def cc_force(i_a, var_a, i_b, var_b, cross, g_b, eps):
        """The ANTs-CC force moving image b toward image a."""
        base = 2.0 * cross / (var_a * var_b + eps)
        return (base * (i_a - cross / (var_b + eps) * i_b))[None] * g_b

    def normalise(self, upd, peak):
        """``upd`` scaled so its largest vector is ``peak``."""
        norm = torch.sqrt(torch.max(torch.sum(upd * upd, 0)))
        return upd * (peak / torch.clamp(norm, min=1e-12))

    def syn(self, fixed, moving, sp, pyramid, iterations, step, std,
            radius, smooth):
        """The half-fields (u1, u2) (Z, Y, X, 3) mm of the full grid."""
        halves = None
        full = fixed.shape
        for factor, n_iter in zip(pyramid, iterations):
            shape = tuple(max(n // factor, 2) for n in full)
            f = self.resample(fixed, shape) if factor > 1 else fixed
            m = self.resample(moving, shape) if factor > 1 else moving
            sp_l = sp * self.t([full[2] / shape[2], full[1] / shape[1],
                                full[0] / shape[0]])
            spc = sp_l[:, None, None, None]
            gauss = [self.t(gauss_matrix(n, float(std))) for n in shape]
            box = [self.t(box_matrix(n, radius)) for n in shape]
            cnt = self.separable(torch.ones(shape, dtype=self.dtype,
                                            device=self.device), *box)
            stack_f = torch.cat([f[None], self.gradient(f, sp_l)])
            stack_m = torch.cat([m[None], self.gradient(m, sp_l)])
            f_mean, m_mean = torch.mean(f), torch.mean(m)
            if halves is None:
                u1 = torch.zeros((3,) + shape, dtype=self.dtype,
                                 device=self.device)
                u2 = u1
            else:
                u1, u2 = (self.resample(torch.movedim(h, -1, 0), shape)
                          / spc for h in halves)
            for _ in range(int(n_iter)):
                wf = self.warp(stack_f, u1, 0.0)
                wm = self.warp(stack_m, u2, 0.0)
                fc, mc = wf[0] - f_mean, wm[0] - m_mean
                i_f, var_f = self.moments(fc, box, cnt)
                i_m, var_m = self.moments(mc, box, cnt)
                cross = self.separable(fc * mc, *box) / cnt \
                    - (fc - i_f) * (mc - i_m)
                eps = 1e-5 * torch.clamp(torch.mean(var_f), min=1e-12)
                # push_m moves the moving image toward the fixed one
                # (its half u2), push_f the fixed toward the moving (u1)
                push_m = self.cc_force(i_f, var_f, i_m, var_m, cross,
                                       wm[1:4], eps)
                push_f = self.cc_force(i_m, var_m, i_f, var_f, cross,
                                       wf[1:4], eps)
                push_m = self.normalise(self.separable(push_m, *gauss),
                                        0.5 * step)
                push_f = self.normalise(self.separable(push_f, *gauss),
                                        0.5 * step)
                u1 = self.compose(u1, self.exp(push_f / spc))
                u2 = self.compose(u2, self.exp(push_m / spc))
                if smooth:
                    u1 = self.separable(u1, *gauss)
                    u2 = self.separable(u2, *gauss)
            halves = [torch.movedim(u, 0, -1) * sp_l for u in (u1, u2)]
        return halves

    def syn_field(self, fixed, moving, sp, solver):
        """The sampling field (Z, Y, X, 3) mm: u2 o u1^{-1}."""
        pyramid = tuple(int(f) for f in solver["pyramid"])
        if pyramid[-1] != 1:
            pyramid = pyramid + (1,)
        iterations = solver["iterations"]
        if np.ndim(iterations) == 0:
            iterations = [iterations] * len(pyramid)
        u1, u2 = self.syn(fixed, moving, sp, pyramid, iterations,
                          float(solver["step"]), float(solver["std"]),
                          int(solver["lncc_radius"]),
                          bool(solver["smooth"]))
        w = torch.movedim(self.invert(u1, sp) / sp, -1, 0)
        u2 = torch.movedim(u2 / sp, -1, 0)
        return torch.movedim(self.compose(u2, w), 0, -1) * sp


def register_and_warp(fixed, moving, spacing, solver, background,
                      dtype=torch.float64, tf32=False, contract=None,
                      device="cpu", strict_faces=False):
    """(point-displacement field (Z, Y, X, 3) mm, deformed moving image
    (Z, Y, X)) as numpy arrays, from the fixed and moving arrays on one
    grid of ``spacing`` [sx, sy, sz] mm. ``solver``: pyramid, iterations
    (an int or one a level), step, std, lncc_radius, smooth."""
    p = PlainSyn(dtype, device, contract, strict_faces)
    with torch.no_grad(), matmul_tf32(tf32):
        f = p.t(fixed)
        m = p.t(moving)
        sp = p.t(spacing)
        sampling = p.syn_field(f, m, sp, solver)
        del f
        point = p.invert(sampling, sp)
        del sampling
        back = p.invert(point, sp)
        warped = p.warp(m[None], torch.movedim(back / sp, -1, 0),
                        background)[0]
        return point.cpu().numpy(), warped.cpu().numpy()
