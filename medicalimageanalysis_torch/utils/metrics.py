"""Geometric metrics.

Carried over from medicalimageanalysis_tpu/utils/metrics.py
(``voxel_volume_cc``). The overlap, surface-distance and percentile
metrics wait for the dose and QA slice's remainder (ROADMAP.md queue 1,
item 8).
"""

from __future__ import annotations

import numpy as np

__all__ = ["voxel_volume_cc"]


def voxel_volume_cc(spacing):
    """One voxel's volume in cc (spacing [sx, sy, sz] mm) — the single
    home of the mm3-to-cc conversion."""
    return float(np.prod(np.asarray(spacing, float))) / 1000.0
