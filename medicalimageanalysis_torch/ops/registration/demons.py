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
``torch.no_grad()``; on the card a SyN level captures its iteration
once as a CUDA graph and replays it (:class:`_SynLevel`). Every warp of
the loop is one launch of the warp kernel's ``disp`` mode on the card
(the moving image and its three gradient components batched in one
launch for the symmetric and LNCC variants). The field smoothing and
the LNCC box sums are full-float32 matrix contractions
(``device.full_float32``): TF32 would destroy the E[x^2] - E[x]^2
cancellation of the LNCC moments, as the TPU's bf16 default did in the
JAX package.

``iterations`` is one count for every pyramid level, or one count a
level. SyN's work is counted on the host in :data:`SYN`, and its final
assembly, u2 o u1^{-1} at full size, runs under the ``mia.syn.assemble``
span; no span wraps a single iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import as_f32, default_device, full_float32
from ...telemetry import trace
from ..filters import _gauss_kernel_matrix
from ..resample import _interp_matrix, _separable_apply, separable_resample
from ..warp import (captured_launches, count_replays, launch_counts,
                    warp_disp)
from .dvf import _compose_planar, compose_dvf, invert_dvf

__all__ = ["SYN", "demons_registration"]

METHODS = ("demons", "fast", "diffeomorphic", "biomechanical", "syn")

# greedy SyN's work as it ran, summed over calls and counted on the host
# (nothing is read back from the device): "levels", the solves of
# _syn_core; "iterations", their iterations; "box_sums", the LNCC
# windowed sums those iterations launched (five an iteration with CC
# forces, none with SSD); "squarings", the compositions inside
# _exp_field (three an exp, two exps an iteration); "assembles", the
# u2 o u1^{-1} assemblies (_syn_assemble).
SYN = {"levels": 0, "iterations": 0, "box_sums": 0, "squarings": 0,
       "assembles": 0}


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


SQUARINGS = 3            # an exp's squarings, on a field scaled by 2^-3


def _exp_field(upd_vox):
    """exp of a planar voxel field by scaling and squaring."""
    v = upd_vox / 8.0
    for _ in range(SQUARINGS):
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


class _Demons:
    """One level of a demons solve, a step at a time: the set-up once,
    then each :meth:`step` one iteration u -> u_new, and
    :meth:`field_mm` the (Z, Y, X, 3) mm field. ``_demons_core`` runs
    the steps of one solve one after another; ``parallel.batch.
    demons_batch`` runs several solves' steps in lockstep, each on its own
    tensors' device. Nothing here waits for the device.

    The loop holds the field planar (3, Z, Y, X) in voxels and warps
    through the ``disp`` mode. sp (and the update math) stays in
    (x, y, z) component order along the leading axis."""

    @torch.no_grad()
    def __init__(self, fixed, moving, sp, std_vox, step,
                 intensity_threshold, method, smooth, elastic_lambda=0.2,
                 u0=None, forces="ssd", lncc_radius=3):
        self.fixed, self.sp = fixed, sp
        self.peak, self.threshold = step, intensity_threshold
        self.method, self.smooth, self.forces = method, smooth, forces
        self.elastic_lambda = elastic_lambda
        self.grad_f = _spatial_gradient_planar(fixed, sp)
        self.K = torch.mean(sp) ** 2
        self.spc = sp[:, None, None, None]
        self.gauss, lncc = _operators(fixed.shape, std_vox, lncc_radius,
                                      forces, fixed.device)

        # the symmetric variants (and LNCC, whose force rides the moving
        # gradient) warp the moving image AND its gradient every
        # iteration: one launch for all four, sharing the coordinates
        self.symmetric = method in ("fast", "diffeomorphic", "biomechanical")
        if self.symmetric or forces == "lncc":
            self.warp_stack = torch.cat([moving[None],
                                         _spatial_gradient_planar(moving,
                                                                  sp)])
        else:
            self.warp_stack = moving[None].contiguous()

        if lncc is not None:
            (lz, ly, lx), cnt = lncc
            self.box = (lz, ly, lx, cnt)
            # GLOBAL CENTERING is load-bearing numerics: LNCC is invariant
            # to a constant shift, and centering removes the E[x^2] -
            # E[x]^2 cancellation on large raw intensities
            self.f_cent = fixed - torch.mean(fixed)
            self.m_shift = torch.mean(moving)
            self.i_f, self.var_f = _lncc_moments(self.f_cent, lz, ly, lx,
                                                 cnt)
            self.mu_f = self.f_cent - self.i_f
            self.v_eps = 1e-5 * torch.clamp(torch.mean(self.var_f),
                                            min=1e-12)

        self.u = torch.zeros((3,) + tuple(fixed.shape), dtype=torch.float32,
                             device=fixed.device) if u0 is None else u0

    @torch.no_grad()
    def step(self):
        """One iteration: the field u -> u_new."""
        u, method, forces = self.u, self.method, self.forces
        mz, my, mx = self.gauss
        w = warp_disp(self.warp_stack, u, 0.0)
        warped = w[0]
        if forces == "lncc":
            # the CC force differentiates wrt the warped moving image:
            # its own gradient is the only correct carrier
            g = w[1:4]
        elif self.symmetric:
            g = 0.5 * (self.grad_f + w[1:4])
        else:
            g = self.grad_f
        if forces == "lncc":
            lz, ly, lx, cnt = self.box
            w_cent = warped - self.m_shift
            i_m, var_m = _lncc_moments(w_cent, lz, ly, lx, cnt)
            mu_m = w_cent - i_m
            cross = _box_sum(self.f_cent * w_cent, lz, ly, lx) / cnt \
                - self.mu_f * mu_m
            upd_mm = _lncc_force(self.i_f, self.var_f, i_m, var_m, cross, g,
                                 self.v_eps)
            # smoothing before the peak normalisation (ANTs' update-field
            # smoothing), then normalise the peak update to `step` mm
            upd_mm = _normalize(_smooth_field(upd_mm, mz, my, mx),
                                self.peak, False)
        else:
            upd_mm = _thirion(self.fixed - warped, g, self.K,
                              self.threshold)
            if self.symmetric:
                upd_mm = _normalize(upd_mm, self.peak, True)
        upd_vox = upd_mm / self.spc
        if method == "diffeomorphic":
            u_new = _compose_planar(u, _exp_field(upd_vox))
        else:
            u_new = u + upd_vox
        if self.smooth:
            u_new = _smooth_field(u_new, mz, my, mx)
        if method == "biomechanical":
            # linear-elastic relaxation: descent on 1/2 (div u)^2 ADDS
            # lambda * grad(div u)
            div = (torch.gradient(u_new[0], dim=2)[0]
                   + torch.gradient(u_new[1], dim=1)[0]
                   + torch.gradient(u_new[2], dim=0)[0])
            u_new = u_new + self.elastic_lambda * torch.stack(
                [torch.gradient(div, dim=2)[0],
                 torch.gradient(div, dim=1)[0],
                 torch.gradient(div, dim=0)[0]])
        self.u = u_new

    def field_mm(self):
        """The (Z, Y, X, 3) field in mm."""
        return torch.movedim(self.u, 0, -1) * self.sp        # voxels -> mm


@torch.no_grad()
def _demons_core(fixed, moving, sp, std_vox, step, intensity_threshold,
                 iterations, method, smooth, elastic_lambda=0.2, u0=None,
                 forces="ssd", lncc_radius=3):
    """One level: ``iterations`` steps of one :class:`_Demons`; returns
    the (Z, Y, X, 3) mm field."""
    solve = _Demons(fixed, moving, sp, std_vox, step, intensity_threshold,
                    method, smooth, elastic_lambda, u0, forces, lncc_radius)
    for _ in range(int(iterations)):
        solve.step()
    return solve.field_mm()


class _SynLevel:
    """One level of greedy SyN (Avants et al., MedIA 2008), an iteration
    at a time: two diffeomorphic half-maps phi1 (fixed side) and phi2
    (moving side) meet at the midpoint. The operators depend on the grid
    and the parameters alone; :meth:`load` takes a pair and its spacing,
    :meth:`run` iterates the planar voxel half-fields (u1, u2).

    On the card :meth:`run` captures one iteration as a CUDA graph (its
    first call) and replays it: a coarse level's iteration is ~130 small
    launches, which the host would otherwise issue one at a time. The
    graph reads and writes this object's tensors, so one object serves
    each (device, grid, parameters) (:func:`_syn_level`) and a new pair
    is copied into it. The bits are those of the same steps run eagerly,
    which is how the CPU runs them."""

    @torch.no_grad()
    def __init__(self, shape, std_vox, step, intensity_threshold, smooth,
                 forces, lncc_radius, device):
        self.half = 0.5 * step
        self.threshold, self.smooth = intensity_threshold, smooth
        self.gauss, lncc = _operators(shape, std_vox, lncc_radius, forces,
                                      device)
        self.box = None if lncc is None else (*lncc[0], lncc[1])
        self.inputs = {}
        self.graph = None             # (CUDAGraph, its warp launches)
        self.u1 = self.u2 = None      # the graph's half-fields

    @torch.no_grad()
    def load(self, fixed, moving, sp):
        """The pair (Z, Y, X) and its spacing (x, y, z) for the next
        :meth:`run`, copied into the tensors a captured graph reads."""
        new = {"stack_f": torch.cat([fixed[None],
                                     _spatial_gradient_planar(fixed, sp)]),
               "stack_m": torch.cat([moving[None],
                                     _spatial_gradient_planar(moving, sp)]),
               "spc": sp[:, None, None, None].clone(),
               "K": torch.mean(sp) ** 2}
        if self.box is not None:
            # global centering constants (see _Demons)
            new["f_shift"] = torch.mean(fixed)
            new["m_shift"] = torch.mean(moving)
        for name, t in new.items():
            if name in self.inputs:
                self.inputs[name].copy_(t)
            else:
                self.inputs[name] = t

    def step(self, u1, u2):
        """One iteration: the half-fields (u1, u2) -> (u1_new, u2_new)."""
        c = self.inputs
        mz, my, mx = self.gauss
        wf = warp_disp(c["stack_f"], u1, 0.0)
        wm = warp_disp(c["stack_m"], u2, 0.0)
        fw, gfw = wf[0], wf[1:4]
        mw, gmw = wm[0], wm[1:4]
        if self.box is not None:
            lz, ly, lx, cnt = self.box
            fw_c = fw - c["f_shift"]
            mw_c = mw - c["m_shift"]
            i_fw, var_fw = _lncc_moments(fw_c, lz, ly, lx, cnt)
            i_mw, var_mw = _lncc_moments(mw_c, lz, ly, lx, cnt)
            cross = _box_sum(fw_c * mw_c, lz, ly, lx) / cnt \
                - (fw_c - i_fw) * (mw_c - i_mw)
            v_eps = 1e-5 * torch.clamp(torch.mean(var_fw), min=1e-12)
            f_m = _lncc_force(i_fw, var_fw, i_mw, var_mw, cross, gmw,
                              v_eps)
            f_f = _lncc_force(i_mw, var_mw, i_fw, var_fw, cross, gfw,
                              v_eps)
            f_m = _normalize(_smooth_field(f_m, mz, my, mx), self.half,
                             False)
            f_f = _normalize(_smooth_field(f_f, mz, my, mx), self.half,
                             False)
        else:
            diff = fw - mw
            f_m = _normalize(_thirion(diff, gmw, c["K"], self.threshold),
                             self.half, True)
            f_f = _normalize(_thirion(-diff, gfw, c["K"], self.threshold),
                             self.half, True)
        u1n = _compose_planar(u1, _exp_field(f_f / c["spc"]))
        u2n = _compose_planar(u2, _exp_field(f_m / c["spc"]))
        if self.smooth:
            u1n = _smooth_field(u1n, mz, my, mx)
            u2n = _smooth_field(u2n, mz, my, mx)
        return u1n, u2n

    @torch.no_grad()
    def run(self, u1, u2, n):
        """``n`` iterations from (u1, u2): eagerly off the card, else as
        replays of the captured iteration. Nothing waits for the device."""
        if n <= 0:
            return u1, u2
        if u1.device.type != "cuda":
            for _ in range(n):
                u1, u2 = self.step(u1, u2)
            return u1, u2
        if self.graph is None:
            self._capture(u1, u2)         # runs the first iteration
            n -= 1
        else:
            self.u1.copy_(u1)
            self.u2.copy_(u2)
        graph, launches = self.graph
        for _ in range(n):
            graph.replay()
        count_replays(launches, n)
        return self.u1, self.u2

    def _capture(self, u1, u2):
        """Runs one iteration eagerly on a side stream (it also warms what
        the capture needs), leaves its result in the graph's half-fields,
        then captures the iteration that reads and overwrites them."""
        dev = u1.device
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        self.u1 = torch.empty_like(u1, memory_format=torch.contiguous_format)
        self.u2 = torch.empty_like(u2, memory_format=torch.contiguous_format)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.stream(side):
            a, b = self.step(u1, u2)
            self.u1.copy_(a)
            self.u2.copy_(b)
            del a, b
            mark = launch_counts()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                a, b = self.step(self.u1, self.u2)
                self.u1.copy_(a)
                self.u2.copy_(b)
                del a, b
            finally:
                graph.capture_end()
            self.graph = (graph, captured_launches(mark))
        current.wait_stream(side)


# the card's SyN levels, most recently used last: each holds its graph,
# the memory the graph's iteration uses, and a copy of its last pair
_SYN_LEVELS = {}
SYN_LEVELS_KEPT = 8


def _syn_level(shape, std_vox, step, intensity_threshold, smooth, forces,
               lncc_radius, device):
    """The :class:`_SynLevel` of these parameters: new off the card; on
    the card the one kept for them (at most SYN_LEVELS_KEPT are kept)."""
    args = (tuple(shape), std_vox, step, intensity_threshold, smooth,
            forces, lncc_radius)
    if device.type != "cuda":
        return _SynLevel(*args, device)
    key = (str(device),) + args
    level = _SYN_LEVELS.pop(key, None) or _SynLevel(*args, device)
    _SYN_LEVELS[key] = level
    while len(_SYN_LEVELS) > SYN_LEVELS_KEPT:
        _SYN_LEVELS.pop(next(iter(_SYN_LEVELS)))
    return level


@torch.no_grad()
def _syn_core(fixed, moving, sp, std_vox, step, intensity_threshold,
              iterations, smooth, forces, lncc_radius, u1_0=None,
              u2_0=None):
    """Greedy SyN's ``iterations`` at one level (:class:`_SynLevel`).
    Returns the half-fields (u1_mm, u2_mm), each (Z, Y, X, 3); the caller
    assembles u2 o u1^{-1} through :func:`_syn_assemble`. The solve's
    iterations, windowed sums and squarings add to :data:`SYN`."""
    level = _syn_level(fixed.shape, std_vox, step, intensity_threshold,
                       smooth, forces, lncc_radius, fixed.device)
    level.load(fixed, moving, sp)
    zero = torch.zeros((3,) + tuple(fixed.shape), dtype=torch.float32,
                       device=fixed.device)
    u1 = zero if u1_0 is None else u1_0
    u2 = zero if u2_0 is None else u2_0
    n_iter = int(iterations)
    u1, u2 = level.run(u1, u2, n_iter)
    SYN["levels"] += 1
    SYN["iterations"] += n_iter
    SYN["box_sums"] += 5 * n_iter if level.box is not None else 0
    SYN["squarings"] += 2 * SQUARINGS * n_iter
    return torch.movedim(u1, 0, -1) * sp, torch.movedim(u2, 0, -1) * sp


def _syn_assemble(u1_mm, u2_mm, sp):
    """SyN's full map x -> phi2(phi1^{-1}(x)) from its half-fields: with
    w = u1^{-1}, d = w + u2(x + w) = compose(u2, w), inverted once, at
    full size; under the ``mia.syn.assemble`` span, counted in
    :data:`SYN`."""
    with trace("mia.syn.assemble"), torch.no_grad():
        out = compose_dvf(u2_mm, invert_dvf(u1_mm, sp), sp)
    SYN["assembles"] += 1
    return out


def _level_counts(iterations, pyramid):
    """The iteration count of each level of ``pyramid``: an int (or any
    scalar ``int`` takes) for every level, else a sequence with one count
    a level."""
    if np.ndim(iterations) == 0:
        return (int(iterations),) * len(pyramid)
    counts = tuple(int(n) for n in iterations)
    if len(counts) != len(pyramid):
        raise ValueError(f"demons: {len(counts)} iteration counts for the "
                         f"{len(pyramid)} levels of the pyramid {pyramid}")
    return counts


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


# SyN's pyramid operators on the card, by what they map and the device:
# uploaded once, so that a level's set-up copies nothing to the device (a
# copy from the host waits for the previous level's replays)
_PYRAMID = {}
PYRAMID_KEPT = 64


def _pyramid_operator(kind, out_shape, in_shape, device):
    """``kind`` 'interp': :func:`separable_resample`'s (z, y, x)
    interpolation matrices from ``in_shape`` to ``out_shape``; 'ratio':
    the (x, y, z) ratio of the grids' voxel sizes. On ``device``, made
    once and kept (the last PYRAMID_KEPT)."""
    key = (kind, tuple(out_shape), tuple(in_shape), str(device))
    op = _PYRAMID.pop(key, None)
    if op is None and kind == "interp":
        op = [torch.as_tensor(_interp_matrix(int(o), i, i / int(o)),
                              device=device)
              for o, i in zip(out_shape, in_shape)]
    elif op is None:
        op = torch.tensor([in_shape[2] / out_shape[2],
                           in_shape[1] / out_shape[1],
                           in_shape[0] / out_shape[0]], dtype=torch.float32,
                          device=device)
    _PYRAMID[key] = op
    while len(_PYRAMID) > PYRAMID_KEPT:
        _PYRAMID.pop(next(iter(_PYRAMID)))
    return op


def _syn_inputs(fixed, moving, sp, factor, halves_mm):
    """A SyN level's pair, spacing and starting half-fields (planar voxel
    fields, None at the first level): the other methods' downsampling,
    ratio and prolongation, through :func:`_pyramid_operator`."""
    dev = fixed.device
    if factor > 1:
        Z, Y, X = fixed.shape
        shape = (max(Z // factor, 2), max(Y // factor, 2),
                 max(X // factor, 2))
        down = _pyramid_operator("interp", shape, fixed.shape, dev)
        f_l = _separable_apply(fixed, *down)
        m_l = _separable_apply(moving, *down)
    else:
        f_l, m_l = fixed, moving
    sp_l = sp * _pyramid_operator("ratio", f_l.shape, fixed.shape, dev)
    if halves_mm is None:
        return f_l, m_l, sp_l, None, None
    up = _pyramid_operator("interp", f_l.shape, halves_mm[0].shape[:3], dev)
    u1_0, u2_0 = [
        torch.movedim(torch.stack([_separable_apply(h[..., c], *up)
                                   for c in range(3)], dim=-1) / sp_l,
                      -1, 0).contiguous()
        for h in halves_mm]
    return f_l, m_l, sp_l, u1_0, u2_0


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
    downsample factors, e.g. (4, 2, 1), each level warm-started from the
    previous level's field (see the JAX package's
    ``demons_registration``); a pyramid that does not end at 1 gets a
    full-size level appended. iterations: one count for every level, or
    a sequence of one count a level, the appended level included (ANTs'
    schedule 100 x 70 x 50 x 20 over (8, 4, 2, 1) is
    ``iterations=(100, 70, 50, 20)``); a sequence of another length raises
    ValueError.

    device: where the iterations run (default: the card when present).
    info: an optional dict that receives ``level_shapes``, the (Z, Y, X)
    grid of each level. Nothing here waits for the device: a level's
    time is read from a profiler trace, under its ``mia.demons.level``
    span, and SyN's assembly of its two halves under ``mia.syn.assemble``
    (its work counted in :data:`SYN`). The field is :func:`_demons_field`'s,
    brought to the host (``mia.demons.field_out``).
    """
    out = _demons_field(fixed, moving, spacing_xyz, method, smooth, std,
                        iterations, intensity_threshold, step,
                        elastic_lambda, pyramid, forces, lncc_radius, device,
                        info)
    with trace("mia.demons.field_out"):
        return out.cpu().numpy()


def _demons_field(fixed, moving, spacing_xyz=(1.0, 1.0, 1.0),
                  method="demons", smooth=True, std=1, iterations=50,
                  intensity_threshold=0.001, step=2.0, elastic_lambda=0.2,
                  pyramid=None, forces="ssd", lncc_radius=3, device=None,
                  info=None):
    """:func:`demons_registration`'s field left where it was computed: a
    (Z, Y, X, 3) float32 tensor on ``device``. Float32 tensors already
    there go in without a copy (the deformable backend's volumes).
    ``iterations`` an int runs that many at every level; a sequence runs
    its counts level by level, one a level of the pyramid with its
    appended full-size level (ValueError otherwise). Each level runs
    under ``mia.demons.level``; SyN's halves are assembled after the
    last, under ``mia.syn.assemble`` (:func:`_syn_assemble`)."""
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
    counts = _level_counts(iterations, pyramid)
    out_mm = None
    halves_mm = None                     # (u1_mm, u2_mm) for syn
    shapes = []
    for factor, n_iter in zip(pyramid, counts):
        with trace("mia.demons.level"):
            if syn:
                f_l, m_l, sp_l, u1_0, u2_0 = _syn_inputs(
                    fixed, moving, sp, factor, halves_mm)
                halves_mm = _syn_core(
                    f_l, m_l, sp_l, float(std), float(step),
                    float(intensity_threshold), n_iter,
                    bool(smooth), forces, int(lncc_radius), u1_0=u1_0,
                    u2_0=u2_0)
            else:
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
                u0 = None
                if out_mm is not None:
                    up = _upsample_field(out_mm, f_l.shape)
                    u0 = torch.movedim(up / sp_l, -1, 0).contiguous()
                out_mm = _demons_core(
                    f_l, m_l, sp_l, float(std), float(step),
                    float(intensity_threshold), n_iter, method,
                    bool(smooth), float(elastic_lambda), u0=u0,
                    forces=forces, lncc_radius=int(lncc_radius))
        shapes.append(tuple(f_l.shape))
    out = _syn_assemble(*halves_mm, sp) if syn else out_mm
    if info is not None:
        info["level_shapes"] = shapes
    return out
