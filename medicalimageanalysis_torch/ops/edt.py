"""Exact Euclidean distance transform and surface-distance QA.

Port of medicalimageanalysis_tpu/ops/edt.py: ``squared_edt``, ``edt``,
``distance_transform``, ``boundary_mask``, ``masked_percentile`` and
``surface_metrics``, with ``BIG_D2``. The JAX package has no Pallas
kernel here: these are XLA programs there and plain PyTorch on the
device here (a hand kernel follows only if a card measurement asks for
one; PERF.md §6 records their time against their bound).

The separable exact squared EDT: along each axis the 1-D transform is the
min-plus convolution

    out[i] = min_j  in[j] + (s * (i - j))**2

evaluated brute force, each pass taking the previous pass's squared
distances, so the result is the true minimum over feature voxels of
sum_axis (s_axis * delta_axis)^2. XLA fuses the broadcast add into the
minimum; eager PyTorch materialises the (rows, outputs, L) sums, so each
step is sized from a fixed byte budget (``_STEP_BYTES``) and memory stays
bounded at any volume size and batch. Every sum rounds to float32 once
and the minimum is exact, so the squared distances are bit-equal to the
JAX package's.

Conventions: arrays are (..., Z, Y, X); ``spacing`` is [sx, sy, sz] mm.
Feature voxels are True; the transform is the distance from every voxel
to the nearest feature voxel. ``distance_transform`` follows scipy's
convention (distance from nonzero voxels to the nearest zero voxel).
Boundary extraction is scipy.ndimage.binary_erosion's cross structuring
element with border_value=0, so mask voxels on the array edge count as
boundary.

A numpy input goes to ``default_device()`` (or the ``device`` of
``squared_edt`` / ``edt`` / ``surface_metrics``); a tensor stays on its
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import default_device

__all__ = ["edt", "squared_edt", "distance_transform", "boundary_mask",
           "masked_percentile", "surface_metrics", "BIG_D2"]

# Squared-mm "infinity": real squared distances top out around
# 3 * (512 voxels * 5 mm)^2 ~ 2e7, and float32 keeps BIG_D2 + w == BIG_D2
# for every reachable parabola weight, so feature-free lines stay
# saturated until a later axis pass finds a feature in another line.
BIG_D2 = np.float32(1e10)

# bytes of the (rows, outputs, L) float32 sums one min-plus step holds
_STEP_BYTES = 1 << 28


def _as_bool(mask, device=None):
    if device is None:
        device = mask.device if isinstance(mask, torch.Tensor) \
            else default_device()
    m = torch.as_tensor(mask, device=device)
    return m if m.dtype == torch.bool else m > 0


def _edt_1d_lastaxis(d2, step):
    """One separable pass along the last axis: d2 (..., L) float32
    squared distances from the previous pass, ``step`` mm per index."""
    L = d2.shape[-1]
    lead = d2.shape[:-1]
    flat = d2.reshape(-1, L)
    M = flat.shape[0]
    opts = dict(dtype=torch.float32, device=d2.device)
    idx = torch.arange(L, **opts) * torch.tensor(float(step), **opts)
    diff = idx[:, None] - idx[None, :]
    w = diff * diff                          # w[i, j] = (s (i - j))^2
    pairs = max(1, _STEP_BYTES // (4 * L))   # (row, output) pairs a step
    rows = min(M, pairs)
    outs = min(L, max(1, pairs // rows))
    out = torch.empty_like(flat)
    for r0 in range(0, M, rows):
        block = flat[r0:r0 + rows, None, :]
        for i0 in range(0, L, outs):
            out[r0:r0 + rows, i0:i0 + outs] = torch.amin(
                block + w[i0:i0 + outs], dim=-1)
    return out.reshape(*lead, L)


def squared_edt(feature, spacing=(1.0, 1.0, 1.0), device=None):
    """Exact squared EDT in mm^2 over the trailing (Z, Y, X) axes.

    feature: bool-ish (..., Z, Y, X), True = feature set; spacing
    [sx, sy, sz]. Voxels with no feature anywhere in the volume saturate
    at BIG_D2 (see ``edt`` for the inf mapping). Returns a float32
    tensor on the feature's device."""
    f = _as_bool(feature, device)
    sx, sy, sz = (float(v) for v in spacing)
    d2 = torch.where(f, torch.tensor(0.0, device=f.device),
                     torch.tensor(float(BIG_D2), device=f.device))
    d2 = _edt_1d_lastaxis(d2, sx)                                  # x
    d2 = _edt_1d_lastaxis(d2.transpose(-1, -2), sy).transpose(-1, -2)  # y
    d2 = _edt_1d_lastaxis(d2.movedim(-3, -1), sz).movedim(-1, -3)  # z
    return d2.contiguous()


def edt(feature, spacing=(1.0, 1.0, 1.0), device=None):
    """Exact EDT in mm: distance from every voxel to the nearest True
    voxel (0 on features; +inf when the volume has no features)."""
    spacing = tuple(float(v) for v in np.asarray(spacing).reshape(-1))
    d2 = squared_edt(feature, spacing, device)
    return torch.where(d2 >= BIG_D2 * np.float32(0.5),
                       torch.tensor(float("inf"), device=d2.device),
                       torch.sqrt(d2))


def distance_transform(mask, spacing=(1.0, 1.0, 1.0)):
    """scipy.ndimage.distance_transform_edt semantics: distance from
    each NONZERO voxel to the nearest zero voxel (zeros map to 0)."""
    return edt(~_as_bool(mask), spacing)


def boundary_mask(mask):
    """Surface voxels: mask minus its cross-structured erosion with a
    ZERO border (scipy binary_erosion defaults: array-edge mask voxels
    are boundary). (..., Z, Y, X) bool-ish in, bool tensor out."""
    m = _as_bool(mask)
    eroded = m
    for axis in (-3, -2, -1):
        n = m.shape[axis]
        edge = torch.zeros_like(m.narrow(axis, 0, 1))
        below = torch.cat([edge, m.narrow(axis, 0, n - 1)], dim=axis)
        above = torch.cat([m.narrow(axis, 1, n - 1), edge], dim=axis)
        eroded = eroded & below & above
    return m & ~eroded


# ---------------------------------------------------------------------------
# masked_percentile: order statistics by a bit-level binary search
# ---------------------------------------------------------------------------
_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


def _float_keys(vals_f32):
    """Monotonic radix key of the full float32 line, as int64 holding the
    uint32 value (torch's uint32 has too few operators on the card):
    negatives bit-flip entirely, non-negatives set the sign bit, so key
    order == float order with -inf < ... < -0.0 < +0.0 < ... < +inf."""
    u = vals_f32.contiguous().view(torch.int32).to(torch.int64) & _U32
    return torch.where(u >= _SIGN, _U32 - u, u | _SIGN)


def _key_to_float(key):
    u = torch.where(key >= _SIGN, key & 0x7FFFFFFF, _U32 - key)
    u = torch.where(u >= _SIGN, u - (1 << 32), u)        # as int32 bits
    return u.to(torch.int32).view(torch.float32)


def _order_stat(keys, valid, rank):
    """Exact ``rank``-th smallest (1-indexed) key among the valid entries:
    a binary search over the key range, 32 masked counts instead of a
    sort, with the overflow-free midpoint. Returns the key (always one
    actually present)."""
    lo = torch.zeros((), dtype=torch.int64, device=keys.device)
    hi = torch.full((), _U32, dtype=torch.int64, device=keys.device)
    for _ in range(32):
        mid = lo + (hi - lo) // 2            # (lo + hi) overflowed int32
        take = (valid & (keys <= mid)).sum() >= rank
        lo = torch.where(take, lo, mid + 1)
        hi = torch.where(take, mid, hi)
    return hi


def masked_percentile(values, valid, q):
    """np.percentile(values[valid], q) with 'linear' interpolation, with
    no host synchronisation, for ANY float32 values (negatives and +-inf
    included). valid: same-shape bool-ish; q in [0, 100]. Returns a 0-d
    float32 tensor: nan when valid is empty or any valid value is NaN."""
    device = values.device if isinstance(values, torch.Tensor) \
        else default_device()
    vals = torch.as_tensor(values, device=device).to(torch.float32) \
        .reshape(-1)
    vmask = _as_bool(valid, vals.device).reshape(-1)
    keys = _float_keys(vals)
    n = vmask.sum()
    f32 = dict(dtype=torch.float32, device=vals.device)
    # a device scalar as divisor: a CUDA division by a host scalar
    # multiplies by its reciprocal, which rounds differently
    pos = torch.tensor(np.float32(q), **f32) / torch.tensor(100.0, **f32) \
        * torch.clamp(n - 1, min=0).to(torch.float32)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo.to(torch.float32)
    k_lo = _order_stat(keys, vmask, lo + 1)
    v_lo = _key_to_float(k_lo)
    # ranks lo+1 and hi+1 differ by at most one: if duplicates of v_lo
    # cover rank hi+1 it IS v_lo, else it is the smallest valid key above
    c_lo = (vmask & (keys <= k_lo)).sum()
    k_next = torch.where(vmask & (keys > k_lo), keys,
                         torch.full_like(keys, _U32)).min()
    v_hi = torch.where(c_lo >= hi + 1, v_lo, _key_to_float(k_next))
    # frac == 0 returns v_lo verbatim: v_hi can be +inf and inf * 0 = NaN
    val = torch.where(frac > 0, v_lo * (1.0 - frac) + v_hi * frac, v_lo)
    bad = (vmask & torch.isnan(vals)).any()
    return torch.where((n > 0) & ~bad, val,
                       torch.tensor(float("nan"), **f32))


# ---------------------------------------------------------------------------
# the surface panel
# ---------------------------------------------------------------------------
def surface_metrics(mask_a, mask_b, spacing=(1.0, 1.0, 1.0),
                    tolerance_mm=2.0, device=None):
    """Segmentation-QA panel on the device, matching the host
    utils/metrics panel (KD-tree between boundary voxel centers): the EDT
    of each mask's boundary set sampled at the other mask's boundary
    voxels is the exact nearest-neighbour distance between voxel-center
    point sets.

    Returns a dict of 0-d float32 tensors: dice, jaccard, volume_a_cc,
    volume_b_cc, hausdorff_mm, hd95_mm, assd_mm, surface_dice
    (@tolerance). Surface stats are nan when either mask is empty.
    """
    sp = tuple(float(v) for v in np.asarray(spacing).reshape(-1))
    return _surface_metrics(_as_bool(mask_a, device),
                            _as_bool(mask_b, device), sp,
                            float(tolerance_mm))


def _surface_metrics(a, b, sp, tolerance_mm):
    """The panel of two bool masks on one device (the JAX package's
    ``_surface_metrics_jit``)."""
    f32 = dict(dtype=torch.float32, device=a.device)

    def count(m):
        return m.sum().to(torch.float32)

    def where0(cond, v):
        return torch.where(cond, v, torch.zeros((), **f32))

    na, nb = count(a), count(b)
    inter, union = count(a & b), count(a | b)
    vox_cc = torch.tensor(np.float32(np.prod(sp) / 1000.0), **f32)
    one = torch.ones((), **f32)
    dice = torch.where(na + nb > 0, 2.0 * inter / (na + nb), one)
    jac = torch.where(union > 0, inter / union, one)

    ba, bb = boundary_mask(a), boundary_mask(b)
    d_to_b = edt(bb, sp)     # distance field to b's surface
    d_to_a = edt(ba, sp)
    n_ba, n_bb = count(ba), count(bb)
    sum_ab = where0(ba, d_to_b).sum()
    sum_ba = where0(bb, d_to_a).sum()
    n_both = torch.clamp(n_ba + n_bb, min=1.0)
    assd = (sum_ab + sum_ba) / n_both
    hits = ((ba & (d_to_b <= tolerance_mm)).sum()
            + (bb & (d_to_a <= tolerance_mm)).sum()).to(torch.float32)
    sdice = hits / n_both
    neg_inf = torch.tensor(float("-inf"), **f32)
    hd = torch.maximum(torch.where(ba, d_to_b, neg_inf).max(),
                       torch.where(bb, d_to_a, neg_inf).max())
    hd95 = torch.maximum(masked_percentile(d_to_b, ba, 95.0),
                         masked_percentile(d_to_a, bb, 95.0))
    both = (na > 0) & (nb > 0)
    nan = torch.tensor(float("nan"), **f32)
    return {
        "dice": dice, "jaccard": jac,
        "volume_a_cc": na * vox_cc, "volume_b_cc": nb * vox_cc,
        "hausdorff_mm": torch.where(both, hd, nan),
        "hd95_mm": torch.where(both, hd95, nan),
        "assd_mm": torch.where(both, assd, nan),
        "surface_dice": torch.where(both, sdice, nan),
    }
