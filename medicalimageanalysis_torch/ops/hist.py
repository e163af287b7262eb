"""Cumulative dose histogram: a hand-written CUDA kernel and its plain twin.

Port of ``dose_below_histogram`` in
medicalimageanalysis_tpu/ops/pallas_kernels.py, whose TPU kernel
(``_hist_kernel``) becomes csrc/hist.cu:

    counts[i] = sum_j (valid[j] > 0) & (dose[j] < thresholds[i])

It is registered as the PyTorch operator ``torch.ops.mia_torch.dose_hist``.
The dispatcher picks the implementation by the tensors' device and
nothing else: a CPU tensor runs the plain twin ``_hist_plain``, a CUDA
tensor launches the kernel or raises.

The counts are exact int64. The TPU kernel accumulates in float32, exact
only up to 2^24 voxels per bin; above that the port's counts are the
right ones (ROADMAP.md queue 3). Its padding of the voxels to a multiple
of 2048 has no counterpart: the kernel walks a ragged last tile.

The kernel searches sorted thresholds: :func:`sort_thresholds` sorts them
on their device with their permutation (NaN last) before each launch,
and the kernel's finish step scatters the counts back through it.
"""

from __future__ import annotations

from collections import Counter

import torch
from torch import Tensor

__all__ = ["LAUNCHES", "LAUNCH_SHAPES", "dose_below_histogram",
           "sort_thresholds"]

# Kernel launches; a run reads it to show that its path went through the
# kernel. Only the CUDA implementation adds to it, once per call.
LAUNCHES = {"dose_hist": 0}
# The CUDA implementation's calls by (voxels N, thresholds n_bins).
LAUNCH_SHAPES = Counter()

# bound on thresholds x voxels per chunk of the plain twin's compare
_PLAIN_CHUNK = 1 << 24


def _hist_plain(dose, valid, thresholds):
    """The plain twin: ((dose < thr) & (valid > 0)).sum over voxels,
    chunked over voxels; (n_bins,) int64 on the input's device."""
    dose = dose.reshape(-1)
    valid = valid.reshape(-1)
    counts = torch.zeros(thresholds.numel(), dtype=torch.int64,
                         device=dose.device)
    step = max(1, _PLAIN_CHUNK // max(1, thresholds.numel()))
    for s in range(0, dose.numel(), step):
        below = (dose[None, s:s + step] < thresholds[:, None]) \
            & (valid[None, s:s + step] > 0)
        counts += below.sum(1)
    return counts


def sort_thresholds(thresholds):
    """(sorted thresholds, permutation) on the thresholds' device, with
    sorted == thresholds[perm]: ascending, NaN last, ties in any order
    (equal thresholds have equal counts; -0.0 == 0.0). No host sync."""
    return torch.sort(thresholds)


@torch.library.custom_op("mia_torch::dose_hist", mutates_args=(),
                         device_types="cpu")
def _dose_hist_op(dose: Tensor, valid: Tensor, thresholds: Tensor) -> Tensor:
    return _hist_plain(dose, valid, thresholds)


@_dose_hist_op.register_kernel("cuda")
def _dose_hist_cuda(dose, valid, thresholds):
    from ._build import load_hist_library

    dev = dose.device
    for name, t in (("dose", dose), ("valid", valid),
                    ("thresholds", thresholds)):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(
                f"dose_hist kernel: {name} must be a contiguous 1-d float32 "
                f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if valid.numel() != dose.numel():
        raise ValueError("dose_hist kernel: dose and valid differ in size "
                         f"({dose.numel()} vs {valid.numel()})")
    n, n_bins = dose.numel(), thresholds.numel()
    if n == 0 or n_bins == 0:
        return torch.zeros(n_bins, dtype=torch.int64, device=dev)
    if n_bins >= 2 ** 30:
        raise ValueError(f"dose_hist kernel: {n_bins} thresholds, beyond "
                         "the kernel's int32 search over 2^30")
    lib = load_hist_library()
    with torch.cuda.device(dev):
        srt, perm = sort_thresholds(thresholds)
        interval = torch.zeros(n_bins, dtype=torch.int64, device=dev)
        counts = torch.empty(n_bins, dtype=torch.int64, device=dev)
        err = lib.mia_dose_hist(dose.data_ptr(), valid.data_ptr(), n,
                                srt.data_ptr(), perm.data_ptr(), n_bins,
                                interval.data_ptr(), counts.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dose_hist launch failed: CUDA error {err}")
    LAUNCHES["dose_hist"] += 1
    LAUNCH_SHAPES[(n, n_bins)] += 1
    return counts


def dose_below_histogram(dose, valid, thresholds):
    """counts[i] = sum(valid > 0 & dose < thresholds[i]) as (n_bins,)
    int64 on the dose's device (a tensor stays where it is; anything else
    goes to ``default_device()``). ``valid`` may be bool or numeric."""
    from ..device import default_device

    device = dose.device if isinstance(dose, Tensor) else default_device()

    def flat(a):
        return torch.as_tensor(a, device=device).to(
            torch.float32).reshape(-1).contiguous()

    return _dose_hist_op(flat(dose), flat(valid), flat(thresholds))
