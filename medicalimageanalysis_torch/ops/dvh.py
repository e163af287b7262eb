"""Dose-volume-histogram reductions on the device.

Port of medicalimageanalysis_tpu/ops/dvh.py: Dmin/Dmax/Dmean/Dmedian/Dstd,
the D1..D99 percentiles and the VS{d}Gy percent/cc bins of a masked dose
array, as plain torch ops (a sort and reductions). The VS-bin counts are
the function ``dose_below_histogram`` computes, so they come from the
port's ops/hist (the CUDA kernel on the card). Counts are exact int64 and
turn into float32 wherever the JAX package holds float32, so the returned
dict matches the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from .hist import dose_below_histogram

__all__ = ["D_VALUES", "dvh_statistics"]

D_VALUES = (1, 2, 5, 10, 15, 20, 25, 30, 35, 40, 45, 50, 55, 60, 65, 70,
            75, 80, 85, 90, 95, 98, 99)


def _dvh_core(dose, valid, d_percents, n_bins, increment):
    """dose (N,) float32 and valid (N,) bool tensors on one device ->
    (dmin, dmax, mean, median, std, d_out (len(d_percents),), below
    (n_bins,) int64, n) as tensors; float32 in the JAX operation order,
    percentiles by numpy's 'linear' interpolation on the sorted valid
    prefix."""
    big = 3.4e38
    n = valid.sum()
    sorted_vals = torch.sort(torch.where(valid, dose, big)).values
    dmin = sorted_vals[0]
    dmax = torch.where(valid, dose, -big).max()
    mean = torch.where(valid, dose, 0.0).sum() / n
    var = torch.where(valid, (dose - mean) ** 2, 0.0).sum() / n

    def percentile(q):                     # q float32 tensor of percents
        pos = q / 100.0 * (n - 1).to(torch.float32)
        lo = torch.floor(pos).to(torch.int64).clamp(0, dose.numel() - 1)
        hi = torch.ceil(pos).to(torch.int64).clamp(0, dose.numel() - 1)
        frac = pos - torch.floor(pos)
        return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac

    median = percentile(torch.tensor(50.0, device=dose.device))
    d_out = percentile(100.0 - d_percents)
    thresholds = torch.arange(n_bins, dtype=torch.float32,
                              device=dose.device) * increment
    below = dose_below_histogram(dose, valid, thresholds)
    return dmin, dmax, mean, median, torch.sqrt(var), d_out, below, n


def dvh_statistics(dose_in_roi, voxel_volume_cc, roi_name="",
                   max_dose=150, increment=5):
    """Full DVH dict with the reference's keys
    (reference structure/dose.py:774-816). ``dose_in_roi``: the ROI's
    dose values, numpy or a tensor (which stays on its device; numpy
    goes to ``default_device()``)."""
    from ..device import default_device

    device = dose_in_roi.device if isinstance(dose_in_roi, torch.Tensor) \
        else default_device()
    dose = torch.as_tensor(dose_in_roi, device=device).to(
        torch.float32).reshape(-1)
    n = dose.numel()
    if n == 0:
        return {"ROI": roi_name, "Volume (cc)": 0.0}
    n_bins = max_dose // increment + 2
    d_pcts = torch.as_tensor(np.asarray(D_VALUES, np.float32), device=device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    dmin, dmax, mean, median, std, d_out, below, _ = _dvh_core(
        dose, valid, d_pcts, int(n_bins), float(increment))

    dvh = {"ROI": roi_name,
           "Volume (cc)": float(n * voxel_volume_cc),
           "Dmin": float(dmin), "Dmax": float(dmax),
           "Dmean": float(mean), "Dmedian": float(median),
           "Dstd": float(std)}
    d_out = d_out.cpu().numpy()
    for i, d in enumerate(D_VALUES):
        dvh[f"D{d}"] = float(d_out[i])
    # the JAX kernel's counts are float32: the same arithmetic on them
    below = below.cpu().numpy().astype(np.float32)
    for i in range(n_bins):
        d = i * increment
        if d > max_dose + increment:
            break
        dvh[f"VS{d}Gy_percent"] = float(below[i] / n * 100.0)
        dvh[f"VS{d}Gy_cc"] = float(below[i] * voxel_volume_cc)
    return dvh
