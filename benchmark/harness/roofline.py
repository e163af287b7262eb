"""The least time the card could take for the port's hand kernels.

Published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
sheet, dense, outside the tensor cores): 3.35 TB/s of HBM, 67 TFLOP/s in
float32. A kernel's bound is the larger of its bytes over the memory rate
and its operations over the float32 rate, each input byte read once and
each output byte written once. The card's power limit is printed beside
every share (``run.py``), since a card set below 700 W is slower.

The launch shapes come from the port's wrapper counters
(``ops/warp.LAUNCH_SHAPES``, ``ops/hist.LAUNCH_SHAPES``).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """Seconds: the larger of the bytes' and the operations' times."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def warp_bound_s(n_in, n_out, B, n_coord_inputs, want_grad):
    """A warp launch: B volumes of n_in voxels and ``n_coord_inputs``
    float32 coordinate or displacement volumes of n_out voxels read once,
    B (4 B with gradients) outputs written once; 30 float32 operations
    an output sample (the 7 lerps of 3 and the taps' weights), 30 more
    with gradients."""
    outs = B * (4 if want_grad else 1)
    nbytes = 4 * (B * n_in + n_coord_inputs * n_out + outs * n_out)
    return bound_s(nbytes, B * n_out * (60 if want_grad else 30))


def affine_bound_s(n_in, n_out, B):
    """An ``affine`` launch: the map's 12 coefficients are arguments, so
    only volumes and outputs move. Where the map has fewer outputs than
    volume voxels (a downsampling), at least one voxel an output is read:
    n_out, a lower count, so that the share is never over-stated."""
    return warp_bound_s(min(n_in, n_out), n_out, B, 0, False)


def hist_bound_s(n, n_bins):
    """The dose histogram at N voxels and n_bins thresholds: dose and
    valid read once, thresholds read, counts written; ceil(log2(n_bins +
    1)) compares a voxel (a binary search of the sorted thresholds)."""
    return bound_s(4 * (2 * n + n_bins) + 8 * n_bins,
                   n * math.ceil(math.log2(n_bins + 1)))


def launch_bounds_s(warp_shapes, hist_shapes):
    """Sum of the bounds of the launches counted in a window, by wrapper
    name. ``warp_shapes``: {(op, B, grad, out dims, volume dims): n};
    ``hist_shapes``: {(n, n_bins): launches}."""
    out = {}
    for (op, B, grad, shape, vin), n in warp_shapes.items():
        n_out, n_in = math.prod(shape), math.prod(vin)
        if op in ("warp_affine", "warp_affine_axis", "warp_affine_shear"):
            b = affine_bound_s(n_in, n_out, B)
        else:             # coords and disp: three coordinate volumes read
            b = warp_bound_s(n_in, n_out, B, 3, bool(grad))
        out[op] = out.get(op, 0.0) + n * b
    for (n_vox, n_bins), n in hist_shapes.items():
        out["dose_hist"] = out.get("dose_hist", 0.0) \
            + n * hist_bound_s(n_vox, n_bins)
    return out


def kernel_share(bounds_s, kernel_s):
    """Sum of bounds over sum of device time of the hand kernels that
    launched in the window, as a percentage; None where none did, or where
    a kernel's launches were counted but its device time is missing (a
    kernel renamed or off the path: the metric then reads nothing)."""
    names = [k for k, v in bounds_s.items() if v > 0]
    if not names or any(kernel_s.get(k, 0.0) <= 0 for k in names):
        return None
    return 100.0 * sum(bounds_s[k] for k in names) \
        / sum(kernel_s[k] for k in names)
