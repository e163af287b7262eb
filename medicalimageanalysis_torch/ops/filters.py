"""Gaussian taps, Toeplitz matrices and the separable Gaussian blur.

Carried over from medicalimageanalysis_tpu/ops/filters.py (``gauss_taps``,
``_gauss_kernel_matrix``, ``gaussian_filter``); importing the original
pulls in jax. The blur is three dense matrix contractions run in full
float32 (``resample._separable_apply``, cuBLAS on the card). Morphology, windowing and the
other filters wait for a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .resample import _separable_apply


__all__ = ["gauss_taps", "gaussian_filter"]


def gauss_taps(sigma_vox, dtype=np.float32):
    """Normalized 1-D Gaussian taps truncated at 4 sigma ->
    (taps (2r+1,), radius)."""
    radius = max(1, int(np.ceil(4 * sigma_vox)))
    offsets = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (offsets / sigma_vox) ** 2)
    return (k / k.sum()).astype(dtype), radius


def _gauss_kernel_matrix(n, sigma_vox, dtype=np.float32):
    """(n, n) Toeplitz Gaussian matrix: out = G @ x along one axis;
    edge-replicated, truncated at 4 sigma."""
    k64, radius = gauss_taps(sigma_vox, dtype=np.float64)
    offsets = np.arange(-radius, radius + 1)
    m = np.zeros((n, n), dtype=np.float64)
    idx = np.arange(n)
    for off, w in zip(offsets, k64):
        src = np.clip(idx + off, 0, n - 1)  # edge-replicate
        np.add.at(m, (idx, src), w)
    return m.astype(dtype)


def gaussian_filter(volume, sigma_mm, spacing_xyz=(1.0, 1.0, 1.0)):
    """Separable Gaussian blur; sigma in mm, converted per axis to voxels
    (sitk SmoothingRecursiveGaussian semantics). volume (Z, Y, X) array
    or tensor -> float32 tensor on the tensor's device (the CPU for an
    array)."""
    vol = torch.as_tensor(volume).to(torch.float32)
    if np.isscalar(sigma_mm):
        sigma_mm = [sigma_mm] * 3
    sig = (sigma_mm[2] / spacing_xyz[2], sigma_mm[1] / spacing_xyz[1],
           sigma_mm[0] / spacing_xyz[0])
    mz, my, mx = (torch.as_tensor(_gauss_kernel_matrix(n, max(sv, 1e-3)),
                                  device=vol.device)
                  for n, sv in zip(vol.shape, sig))
    return _separable_apply(vol, mz, my, mx)
