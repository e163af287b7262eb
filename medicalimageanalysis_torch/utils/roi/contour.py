"""Per-plane mask -> pixel contour extraction
(reference utils/roi/contour.py:15-39).

Port of medicalimageanalysis_tpu/utils/roi/contour.py on the port's own
border tracer (native.trace_external, cv2's RETR_EXTERNAL /
CHAIN_APPROX_SIMPLE contours without cv2).
"""

from __future__ import annotations

import numpy as np

__all__ = ["contours_from_mask"]


def contours_from_mask(mask, plane="Axial"):
    """Outer contours of every slice along ``plane`` -> list of (N, 3)
    float64 pixel contours (x, y, z), slice by slice."""
    from ...native import trace_external

    axis = {"Axial": 0, "Coronal": 1}.get(plane, 2)
    stack = np.moveaxis(np.asarray(mask).astype(np.uint8), axis, 0)
    contours = []
    for ii, found in enumerate(trace_external(stack)):
        for t in found:
            k = np.full((len(t), 1), float(ii))
            if axis == 0:
                contours.append(np.concatenate((t, k), axis=1))
            elif axis == 1:
                contours.append(np.concatenate((t[:, :1], k, t[:, 1:]),
                                               axis=1))
            else:
                contours.append(np.concatenate((k, t), axis=1))
    return contours
