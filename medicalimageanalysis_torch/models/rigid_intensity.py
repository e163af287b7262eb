"""Intensity-based rigid / similarity / affine registration.

Port of medicalimageanalysis_tpu/models/rigid_intensity.py
(``pose_to_matrix``, the metrics, ``_register_level``,
``register_rigid_intensity`` and ``register_rigid_intensity_batch``). The
2/98-percentile normalisation and its uint16 quantisation run on the
device, bit-equal to the JAX package's host recipe
(:func:`_normalize`). One pyramid level downsamples both volumes
by three interpolation-matrix contractions, then runs Adam on the pose;
each step samples the moving volume through the CUDA warp kernel
(``coords`` mode, coordinate gradients fused into the same launch) on the
card, or through its plain twin on the CPU. The JAX package's slab-cap
guards (``fits_warp_caps`` and the XLA fallback) have no counterpart: the
kernel has no caps.

The descent keeps its losses on the device and synchronises once per
level, so a step costs its kernels and not a host round trip.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import default_device, full_float32
from ..ops import geometry as geo
from ..ops.resample import _interp_matrix
from ..ops.volume import stored_to_float
from ..ops.warp import affine_coords, make_warp_sampler

__all__ = ["register_rigid_intensity", "register_rigid_intensity_batch",
           "pose_to_matrix", "adam_init", "adam_update"]

_MODE_NPARAMS = {"rigid": 6, "similarity": 7, "affine": 12}


def _rot_mats(angles):
    ax, ay, az = angles[0], angles[1], angles[2]
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx])
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy])
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one])
    return rz.reshape(3, 3) @ ry.reshape(3, 3) @ rx.reshape(3, 3)


def pose_to_matrix(pose, center):
    """Pose -> 4x4 physical transform about ``center`` (float32 tensors);
    the parameter count selects the model:

    - (6,)  rigid:      angles(3) + translation(3)        M = R
    - (7,)  similarity: + log isotropic scale             M = e^s R
    - (12,) affine:     + log per-axis scales(3) + shears(3)
                        M = R @ diag(e^s) @ unit-upper-Shear
    """
    n = pose.shape[0]
    R = _rot_mats(pose[:3])
    t = pose[3:6]
    if n == 6:
        M = R
    elif n == 7:
        M = torch.exp(pose[6]) * R
    elif n == 12:
        S = torch.diag(torch.exp(pose[6:9]))
        one, zero = torch.ones_like(pose[0]), torch.zeros_like(pose[0])
        H = torch.stack([one, pose[9], pose[10], zero, one, pose[11],
                         zero, zero, one]).reshape(3, 3)
        M = R @ S @ H
    else:
        raise ValueError(f"pose length must be 6/7/12, got {n}")
    c = center
    top = torch.cat([M, (c + t - M @ c)[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=pose.dtype,
                          device=pose.device)
    return torch.cat([top, bottom], dim=0)


# Adam's per-parameter step equals lr in parameter units, so angles
# (radians), translations (mm) and log-scales/shears need different
# effective step sizes: pose = params * _pose_scale(n).
_POSE_SCALE = np.array([0.05, 0.05, 0.05, 5.0, 5.0, 5.0], np.float32)


def _pose_scale(n):
    """Per-parameter step scale for the 6/7/12-parameter models."""
    extra = {6: [], 7: [0.02], 12: [0.02] * 6}[int(n)]
    return np.concatenate([_POSE_SCALE, np.asarray(extra, np.float32)])


_MI_BINS = 32
# dense (N, bins) Parzen matrices are ~4 GB per 32M-voxel volume; past
# this many values the joint histogram accumulates in chunks whose
# weights are recomputed in the backward pass
_MI_CHUNK = 1 << 21


def _soft_bin_weights(vals, bins):
    """(N, bins) triangular soft-assignment weights for vals in [0, 1]."""
    centers = torch.arange(bins, dtype=torch.float32, device=vals.device)
    u = torch.clamp(vals, 0.0, 1.0) * (bins - 1)
    return torch.clamp(1.0 - torch.abs(u[:, None] - centers[None, :]),
                       min=0.0)


def _joint_chunk(v, r, w, bins):
    return (_soft_bin_weights(r, bins) * w[:, None]).T \
        @ _soft_bin_weights(v, bins)


def _mi_joint(v, r, w, bins=None, chunk=_MI_CHUNK):
    """(bins, bins) soft joint histogram. Small N: one matmul. Large N: a
    loop over ``chunk``-value slices, each checkpointed, so neither pass
    materialises the (N, bins) weight matrices."""
    B = bins or _MI_BINS
    N = v.shape[0]
    if N <= chunk:
        return _joint_chunk(v, r, w, B)
    joint = torch.zeros((B, B), dtype=torch.float32, device=v.device)
    for s in range(0, N, chunk):
        joint = joint + checkpoint(_joint_chunk, v[s:s + chunk],
                                   r[s:s + chunk], w[s:s + chunk], B,
                                   use_reentrant=False)
    return joint


def _metric_loss(metric, vals, ref_vals, inside, bins=None):
    """Similarity loss over flattened sampled values: 'mse' (masked mean
    squared error), 'ncc' (1 - NCC^2) or 'mi' (negative soft-binned
    mutual information; values pre-normalised to [0, 1])."""
    v = vals.reshape(-1)
    r = ref_vals.reshape(-1)
    w = inside.reshape(-1)
    n = torch.clamp(torch.sum(w), min=1.0)
    if metric == "mse":
        diff = (v - r) * w
        return torch.sum(diff * diff) / n
    if metric == "ncc":
        mv = torch.sum(v * w) / n
        mr = torch.sum(r * w) / n
        dv = (v - mv) * w
        dr = (r - mr) * w
        cov = torch.sum(dv * dr)
        var = torch.sum(dv * dv) * torch.sum(dr * dr)
        return 1.0 - (cov * cov) / torch.clamp(var, min=1e-12)
    if metric == "mi":
        joint = _mi_joint(v, r, w, bins or _MI_BINS)
        p = joint / torch.clamp(torch.sum(joint), min=1e-6)
        pr = torch.sum(p, dim=1, keepdim=True)
        pm = torch.sum(p, dim=0, keepdim=True)
        mi = torch.sum(p * (torch.log(p + 1e-12)
                            - torch.log(pr * pm + 1e-12)))
        return -mi
    raise ValueError(f"unknown metric {metric!r}")


# ---------------------------------------------------------------------------
# Adam, written out in optax.adam's float32 operation order
# ---------------------------------------------------------------------------
def adam_init(params):
    """(mu, nu, count) for :func:`adam_update`."""
    return torch.zeros_like(params), torch.zeros_like(params), 0


def adam_update(g, state, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One ``optax.adam(lr)`` update -> (update to add, new state).
    ``torch.optim.Adam`` rounds its denominator differently, hence this."""
    mu, nu, count = state
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * (g * g) + b2 * nu
    count += 1
    mu_hat = mu / np.float32(1 - np.float32(b1) ** np.float32(count))
    nu_hat = nu / np.float32(1 - np.float32(b2) ** np.float32(count))
    update = (mu_hat / (torch.sqrt(nu_hat) + eps)) * -lr
    return update, (mu, nu, count)


def _downsample(v, s):
    """Stride-s box-free downsample by three interpolation-matrix
    contractions (full float32 inside _register_level's full_float32)."""
    Z, Y, X = v.shape
    oz, oy, ox = max(Z // s, 2), max(Y // s, 2), max(X // s, 2)
    opts = dict(dtype=torch.float32, device=v.device)
    mz = torch.as_tensor(_interp_matrix(oz, Z, Z / oz), **opts)
    my = torch.as_tensor(_interp_matrix(oy, Y, Y / oy), **opts)
    mx = torch.as_tensor(_interp_matrix(ox, X, X / ox), **opts)
    out = torch.einsum("ij,jyx->iyx", mz, v)
    out = torch.einsum("kj,zjx->zkx", my, out)
    out = torch.einsum("lj,zyj->zyl", mx, out)
    return out, (Z, Y, X), (oz, oy, ox)


# ---------------------------------------------------------------------------
# the 2/98-percentile normalisation, on the device
# ---------------------------------------------------------------------------
_NORM_Q = (2.0, 98.0)          # percentiles that map to 0 and 1
_QUANT = 65535.0               # the uint16 code of 1.0


def _np_lerp(a, b, t):
    """numpy's ``_lerp`` of its 'linear' percentile (numpy/lib/
    _function_base_impl.py): a + (b - a) t, or b - (b - a)(1 - t) where
    t >= 0.5, in the dtypes numpy gives them (a, b float32 order
    statistics, t float64)."""
    diff = np.subtract(b, a)
    out = np.asanyarray(np.add(a, diff * t))
    np.subtract(b, diff * (1 - t), out=out, where=t >= 0.5,
                casting="unsafe", dtype=type(out.dtype))
    return out


def _percentile_bounds(vol):
    """``np.percentile(a, [2, 98])`` of the float32 volume ``vol`` (a
    tensor on any device), bit-equal to numpy's 'linear' method: the four
    order statistics come from a sort on the device, numpy's virtual
    indices and lerp run on the host. Returns (lo, hi) numpy float64."""
    n = vol.numel()
    virtual = (n - 1) * (np.asarray(_NORM_Q) / 100.0)
    below = np.floor(virtual)
    prev = below.astype(np.int64)
    nxt = prev + 1
    top = virtual >= n - 1
    prev[top] = nxt[top] = n - 1
    ranked = torch.sort(vol.reshape(-1)).values        # NaN sorts last
    picks = torch.as_tensor(np.concatenate([prev, nxt, [n - 1]]),
                            device=vol.device)
    vals = ranked[picks].cpu().numpy().astype(np.float32)
    if np.isnan(vals[-1]):                             # numpy: NaN poisons
        return np.float64(np.nan), np.float64(np.nan)
    # numpy's gamma is taken against the replaced index (-1 at the top)
    gamma = virtual - np.where(top, -1.0, below)
    lo, hi = _np_lerp(vals[:2], vals[2:4], gamma)
    return lo, hi


def _quantize(vol, lo, hi):
    """The host recipe ``(clip((a - lo) / max(hi - lo, 1e-6), 0, 1) *
    65535 + 0.5).astype(uint16)`` on the device, in the type numpy
    computes it in: float64 under numpy 2 (``lo`` is a float64 scalar,
    NEP 50), float32 under numpy 1. Returns the codes as an int32 tensor.
    Every scalar is a 0-d tensor on the device: a CUDA division by a host
    scalar multiplies by its reciprocal, which rounds differently."""
    wide = (np.zeros(1, np.float32) - lo).dtype
    dt = torch.float64 if wide == np.float64 else torch.float32
    den = max(hi - lo, 1e-6)

    def scalar(v):
        return torch.tensor(np.asarray(v).astype(wide), device=vol.device)

    x = vol.to(torch.float32).to(dt)
    x.sub_(scalar(lo)).div_(scalar(den)).clamp_(0, 1)
    x.mul_(scalar(_QUANT)).add_(scalar(0.5))
    return x.to(torch.int32)


def _normalize(vol):
    """The 2/98-percentile normalisation of one volume (float32 tensor),
    as the uint16 codes (int32 tensor) the JAX package's host recipe
    gives; ``* (1 / 65535)`` dequantises them."""
    lo, hi = _percentile_bounds(vol)
    return _quantize(vol, lo, hi)


@full_float32()
def _register_level(ref_vol, mov_vol, ref_pix2pos, mov_pos2pix, center,
                    pose0, lr, steps, stride, intensity_scale=1.0,
                    metric="mse"):
    """One pyramid level of Adam descent on the masked similarity metric.

    Tensors on one device: volumes (any real dtype), 4x4 float32 geometry
    matrices, (3,) center, (n,) pose0. Returns (pose, losses (steps,)),
    both on that device; nothing here waits for the device. Every matmul
    of the level, forward and backward, runs in full float32.
    """
    ref_vol = ref_vol.to(torch.float32) * intensity_scale
    mov_vol = mov_vol.to(torch.float32) * intensity_scale
    s = stride[0]
    if s > 1:
        ref_vol, (Z, Y, X), (oz, oy, ox) = _downsample(ref_vol, s)
        mov_vol, (MZf, MYf, MXf), (mzo, myo, mxo) = _downsample(mov_vol, s)
        # low-res pixel i maps to full-res pixel i * (full/low)
        opts = dict(dtype=torch.float32, device=ref_vol.device)
        scale_ref = torch.diag(torch.tensor(
            [X / ox, Y / oy, Z / oz, 1.0], **opts))
        ref_pix2pos = ref_pix2pos @ scale_ref
        inv_scale = torch.diag(torch.tensor(
            [mxo / MXf, myo / MYf, mzo / MZf, 1.0], **opts))
        mov_pos2pix = inv_scale @ mov_pos2pix

    shape = ref_vol.shape
    MZ, MY, MX = mov_vol.shape
    scale = torch.as_tensor(_pose_scale(pose0.shape[0]),
                            device=ref_vol.device)
    sample_mov = make_warp_sampler(mov_vol, 0.0)

    def loss_fn(params):
        m = pose_to_matrix(params * scale, center)           # ref->mov
        P = mov_pos2pix @ m @ ref_pix2pos    # ref pixel -> mov pixel
        cz, cy, cx = affine_coords(P, shape)
        vals = sample_mov(cz, cy, cx)
        with torch.no_grad():
            inside = ((cx >= 0) & (cx <= MX - 1) & (cy >= 0)
                      & (cy <= MY - 1) & (cz >= 0)
                      & (cz <= MZ - 1)).to(torch.float32)
        return _metric_loss(metric, vals, ref_vol, inside)

    params = (pose0 / scale).detach()
    state = adam_init(params)
    losses = torch.empty(steps, dtype=torch.float32, device=ref_vol.device)
    for k in range(steps):
        params.requires_grad_(True)
        loss = loss_fn(params)
        (g,) = torch.autograd.grad(loss, params)
        update, state = adam_update(g, state, lr)
        params = (params.detach() + update).detach()
        losses[k] = loss.detach()
    return params * scale, losses


def _descend(refs, movs, ref_pix2pos, mov_pos2pix, centers, poses, levels,
             intensity_scale, metric):
    """The coarse-to-fine descent of P pairs, one ``_register_level`` per
    pair and level, one pair after another (the warp kernel samples its
    volumes at one set of coordinates, and every pair has its own pose).
    Yields after each level the poses (P, n) and the level's losses (P,
    steps), on the device; nothing here waits for it."""
    for stride, steps, lr in levels:
        out = [_register_level(refs[p], movs[p], ref_pix2pos[p],
                               mov_pos2pix[p], centers[p], poses[p],
                               float(lr), int(steps), (stride,) * 3,
                               intensity_scale, metric=metric)
               for p in range(len(refs))]
        poses = torch.stack([pose for pose, _ in out])
        yield poses, torch.stack([losses for _, losses in out])


def _volume_on(a, device):
    """An image's array as float32 on ``device``: a numpy volume crosses
    in its stored type (stored_to_float), a tensor already on the device
    stays there."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return stored_to_float(np.asarray(a), device)


def register_rigid_intensity(reference_image, moving_image, pose0=None,
                             levels=((4, 60, 0.3), (2, 40, 0.1),
                                     (1, 25, 0.03)),
                             normalize=True, metric="mse", mode="rigid",
                             device=None):
    """Register moving onto reference by gradient descent on a masked
    similarity metric.

    reference_image, moving_image : objects with .array/.matrix/.spacing/
        .origin (Image instances or equivalents; .array numpy or a tensor)
    levels : (stride, steps, lr) coarse-to-fine schedule
    metric : 'mse' | 'ncc' | 'mi' (requires normalize=True)
    mode : 'rigid' (6-DoF) | 'similarity' | 'affine'
    device : where the descent runs (default: the card when present)

    Returns (matrix4 ``reference -> moving``, info dict with 'pose',
    'loss', 'losses', 'level_seconds' and 'prep_seconds': the work before
    the descent, split into 'upload' (the arrays in their stored type,
    widened to float32 on the device), and with ``normalize`` the device
    normalisation's 'percentile' and 'quantize').
    """
    if metric == "mi" and not normalize:
        raise ValueError("metric='mi' requires normalize=True "
                         "([0, 1] intensities for the Parzen bins)")
    if mode not in _MODE_NPARAMS:
        raise ValueError(f"unknown mode {mode!r}; pick from "
                         f"{sorted(_MODE_NPARAMS)}")
    n_params = _MODE_NPARAMS[mode]
    if pose0 is not None and np.shape(pose0) != (n_params,):
        raise ValueError(
            f"pose0 must have shape ({n_params},) for mode={mode!r}, "
            f"got {np.shape(pose0)}")
    device = default_device() if device is None else torch.device(device)
    clock = time.perf_counter

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return clock()

    prep_seconds = {}
    t0 = clock()
    refd = _volume_on(reference_image.array, device)
    movd = _volume_on(moving_image.array, device)
    prep_seconds["upload"] = synced() - t0
    intensity_scale = 1.0
    if normalize:
        # the JAX package's uint16 quantisation of the [0,1]-normalised
        # volumes, on the device (dequantised in _register_level via
        # intensity_scale; 1.5e-5 quantization error << interp noise)
        t0 = clock()
        bounds = [_percentile_bounds(v) for v in (refd, movd)]
        prep_seconds["percentile"] = clock() - t0     # ends in a download
        t0 = clock()
        refd, movd = (_quantize(v, lo, hi)
                      for v, (lo, hi) in zip((refd, movd), bounds))
        prep_seconds["quantize"] = synced() - t0
        intensity_scale = 1.0 / _QUANT

    ref_pix2pos = geo.pixel_to_position_matrix(
        reference_image.matrix, reference_image.spacing,
        reference_image.origin).astype(np.float32)
    mov_pos2pix = geo.position_to_pixel_matrix(
        moving_image.matrix, moving_image.spacing,
        moving_image.origin).astype(np.float32)
    center = np.asarray(reference_image.compute_center()
                        if hasattr(reference_image, "compute_center")
                        else geo.apply_homogeneous(
                            [refd.shape[2] / 2, refd.shape[1] / 2,
                             refd.shape[0] / 2], ref_pix2pos),
                        dtype=np.float32)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    pose = torch.zeros(n_params, dtype=torch.float32, device=device) \
        if pose0 is None else dev(pose0)
    losses_all, level_seconds = [], []
    t0 = clock()
    for poses, losses in _descend(
            [refd], [movd], dev(ref_pix2pos)[None], dev(mov_pos2pix)[None],
            dev(center)[None], pose[None], levels, intensity_scale, metric):
        pose = poses[0]
        losses_all.append(losses[0].cpu().numpy())   # the level's one sync
        level_seconds.append(clock() - t0)
        t0 = clock()

    matrix = pose_to_matrix(pose, dev(center)).cpu().numpy() \
        .astype(np.float64)
    return matrix, {"pose": pose.cpu().numpy(),
                    "loss": float(losses_all[-1][-1]),
                    "losses": losses_all, "level_seconds": level_seconds,
                    "prep_seconds": prep_seconds}


def _mi_range_guard(name, vols, scale):
    """metric='mi' bins intensities over [0, 1] and clip has zero
    gradient outside it: raise on grossly unnormalised input (the span of
    every volume of ``vols`` times ``scale``), warn with the share of
    voxels outside [0, 1] otherwise (JAX models/rigid_intensity.py:
    351-385)."""
    lo = min(float(v.min()) for v in vols) * scale
    hi = max(float(v.max()) for v in vols) * scale
    if not (lo >= -0.05 and hi <= 1.5):
        raise ValueError(
            "metric='mi' needs intensities normalized to "
            f"[0, 1] (after intensity_scale; {name} span "
            f"[{lo:.3g}, {hi:.3g}]) — see "
            "register_rigid_intensity's normalize=True recipe")
    if lo < 0.0 or hi > 1.0:
        outside = sum(int(((v.to(torch.float32) * scale < 0.0)
                           | (v.to(torch.float32) * scale > 1.0)).sum())
                      for v in vols)
        frac = outside / sum(v.numel() for v in vols)
        if frac > 0:
            import warnings
            warnings.warn(
                f"metric='mi': {frac:.2%} of {name} voxels "
                "fall outside [0, 1] after intensity_scale "
                "and will clip into zero-gradient edge Parzen "
                "bins, weakening the registration",
                stacklevel=3)


def register_rigid_intensity_batch(refs, movs, ref_pix2pos, mov_pos2pix,
                                   centers, poses0=None,
                                   levels=((4, 60, 0.3), (2, 40, 0.1),
                                           (1, 25, 0.03)),
                                   intensity_scale=1.0, mesh=None,
                                   metric="mse", mode="rigid", device=None):
    """Cohort registration: P volume pairs through the descent of
    :func:`register_rigid_intensity` (``_descend``, which that function
    runs with P = 1), so a pair's pose equals that function's for the
    pair alone.

    refs, movs : (P, Z, Y, X) arrays or tensors, or sequences of P
        volumes (any real dtype; pre-normalised, e.g. by
        register_rigid_intensity's uint16 recipe with intensity_scale
        1/65535). Tensors stay on their device unless ``device`` is given;
        arrays go to ``device`` (default: the card when present).
    ref_pix2pos, mov_pos2pix : (P, 4, 4) float32 geometry matrices
    centers : (P, 3) rotation centers (mm)
    mesh : a parallel.mesh.make_mesh mesh: the pairs split over its
        'data' axis (P must divide by it), each data row's pairs through
        ``_descend`` on the row's device (parallel.batch.
        _data_sharded_call); a pair's pose is the same as without it
    Returns (poses (P, n_params), final_losses (P,)) as numpy float32.
    """
    if mode not in _MODE_NPARAMS:
        raise ValueError(f"unknown mode {mode!r}; pick from "
                         f"{sorted(_MODE_NPARAMS)}")
    P_n = len(refs)
    n_params = _MODE_NPARAMS[mode]
    if poses0 is not None and np.shape(poses0) != (P_n, n_params):
        raise ValueError(
            f"poses0 must have shape ({P_n}, {n_params}) for "
            f"mode={mode!r}, got {np.shape(poses0)}")
    if mesh is not None:
        from ..parallel.batch import _data_sharded_call

        per_pair = [refs, movs, ref_pix2pos, mov_pos2pix, centers]
        if poses0 is not None:
            per_pair.append(np.asarray(poses0, np.float32))

        def row(r, m, rp, mp, c, *p0, device):
            return register_rigid_intensity_batch(
                r, m, rp, mp, c, poses0=p0[0] if p0 else None,
                levels=levels, intensity_scale=intensity_scale,
                metric=metric, mode=mode, device=device)

        return _data_sharded_call("register_rigid_intensity_batch", mesh,
                                  row, per_pair)
    if device is None:
        device = refs[0].device if isinstance(refs[0], torch.Tensor) \
            else default_device()
    device = torch.device(device)

    def volume(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return stored_to_float(np.asarray(v), device)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    refs = [volume(v) for v in refs]
    movs = [volume(v) for v in movs]
    ref_pix2pos, mov_pos2pix, centers = (
        dev(a) for a in (ref_pix2pos, mov_pos2pix, centers))
    poses = torch.zeros((P_n, n_params), dtype=torch.float32,
                        device=device) if poses0 is None else dev(poses0)
    losses = torch.zeros((P_n,), dtype=torch.float32, device=device)
    scale = float(intensity_scale)
    if metric == "mi":
        for name, vols in (("refs", refs), ("movs", movs)):
            _mi_range_guard(name, vols, scale)
    for poses, level_losses in _descend(refs, movs, ref_pix2pos,
                                        mov_pos2pix, centers, poses, levels,
                                        scale, metric):
        losses = level_losses[:, -1]
    return poses.cpu().numpy(), losses.cpu().numpy()
