"""External-contour thresholding (reference utils/image/threshold.py:17-49).

Port of medicalimageanalysis_tpu/utils/image/threshold.py. The threshold
runs on the device; the 26-connected labelling, the largest component
and the per-slice hole fill run on the host with scipy, as in the JAX
package, on the downloaded boolean mask.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from ...device import default_device

__all__ = ["external"]


def external(array, threshold=-250, min_volume=100, only_mask=True,
             less_than=False, device=None):
    """Largest thresholded component with per-slice fill/centroids.

    The comparison runs on ``device`` (default: a tensor's own device,
    else ``default_device()``). Returns the mask only (default, float64
    0/1) or (mask, centroid_external, external_components, bounds) like
    the reference.
    """
    if isinstance(array, torch.Tensor):
        t = array if device is None else array.to(device)
    else:
        t = torch.tensor(np.asarray(array), device=device or default_device())
    binary = ((t < threshold) if less_than else (t > threshold)).cpu().numpy()
    shape = binary.shape

    # full-connectivity labeling (skimage.measure.label default)
    labels, n = ndimage.label(binary, structure=np.ones((3, 3, 3)))
    if n == 0:
        mask = np.zeros(shape)
        if only_mask:
            return mask
        return mask, np.zeros((0, 2)), np.zeros((0, 1)), (0, 0, 0, 0, 0, 0)

    counts = np.bincount(labels.ravel())
    counts[0] = 0
    comp = labels == int(np.argmax(counts))
    objs = ndimage.find_objects(comp.astype(np.int8))[0]
    # bbox as (z0, y0, x0, z1, y1, x1) like skimage regionprops
    bounds = (objs[0].start, objs[1].start, objs[2].start,
              objs[0].stop, objs[1].stop, objs[2].stop)
    box_image = comp[objs]

    mask = np.zeros(shape)
    centroid_external = np.zeros((box_image.shape[0], 2))
    external_components = np.zeros((box_image.shape[0], 1))
    structure2d = np.ones((3, 3))
    for ii in range(box_image.shape[0]):
        filled_image = ndimage.binary_fill_holes(box_image[ii, :, :])
        fill_labels, n2 = ndimage.label(filled_image, structure=structure2d)
        areas = np.bincount(fill_labels.ravel())[1:] if n2 else []
        external_components[ii] = len(
            [a for a in areas if a > min_volume])
        if filled_image.any():
            centroid_external[ii, :] = np.round(
                np.mean(np.argwhere(filled_image), axis=0))
        mask[ii + bounds[0], bounds[1]:bounds[4],
             bounds[2]:bounds[5]] = 1 * filled_image

    if only_mask:
        return mask
    return mask, centroid_external, external_components, bounds
