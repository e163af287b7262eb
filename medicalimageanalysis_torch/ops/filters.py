"""Gaussian tap and Toeplitz-matrix builders (numpy host code).

Carried over from medicalimageanalysis_tpu/ops/filters.py (``gauss_taps``,
``_gauss_kernel_matrix``); importing the original pulls in jax. The device
filters wait for a later slice.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gauss_taps"]


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
