"""4D (temporally resolved) series utilities.

Port of medicalimageanalysis_tpu/utils/fourd.py. The reader splits gated
4D acquisitions into one image per respiratory or cardiac phase
(read/dicom.py ``_split_temporal_phases``); these helpers work on the
resulting phase sets:

- ``find_phase_groups``: the registered images that are phases of one 4D
  acquisition (same series and grid), temporally ordered (host).
- ``combine_phases``: collapse phases into an AIP / MIP / MinIP volume
  registered as an Image: one reduction over the stacked phases on the
  device.
- ``compute_itv``: ITV = union of a structure across phases (AAPM
  TG-76), resampled through ``affine_resample`` (one ``affine`` launch on
  the card) when the target's grid differs.
"""

from __future__ import annotations

import numpy as np

from ..data import Data

__all__ = ["find_phase_groups", "combine_phases", "compute_itv",
           "temporal_sort_key"]


def temporal_sort_key(image):
    """Temporal ordering key for a phase image: (priority, value) from
    TemporalPositionIdentifier, else TriggerTime, else AcquisitionNumber,
    else the registry name."""
    from ..dicom.dataset import value_or

    ds = image.tags[0] if image.tags else None
    if ds is not None:
        tpi = value_or(ds, "TemporalPositionIdentifier", None)
        if tpi is not None:
            try:
                return (0, float(tpi))
            except (TypeError, ValueError):
                pass
        trig = value_or(ds, "TriggerTime", None)
        if trig is not None:
            try:
                return (1, float(trig))
            except (TypeError, ValueError):
                pass
    try:
        return (2, float(image.acq_number))
    except (TypeError, ValueError):
        return (3, 0.0)


def _group_key(image):
    return (
        str(image.series_uid),
        str(image.plane),
        tuple(int(v) for v in image.dimensions),
        tuple(np.round(np.asarray(image.spacing, float), 4)),
        tuple(np.round(np.asarray(image.origin, float), 3)),
        tuple(np.round(np.asarray(image.orientation, float), 4)),
    )


def find_phase_groups(image_names=None):
    """Group registered images that are temporal phases of one
    acquisition: same SeriesInstanceUID AND identical grid geometry,
    2+ members. Returns a list of name-lists, each temporally ordered
    (TemporalPositionIdentifier > TriggerTime > AcquisitionNumber >
    name)."""
    names = list(image_names) if image_names is not None \
        else list(Data.image_list)
    buckets = {}
    for n in names:
        img = Data.image[n]
        buckets.setdefault(_group_key(img), []).append(n)
    groups = []
    for members in buckets.values():
        if len(members) < 2:
            continue
        members.sort(key=lambda n: (temporal_sort_key(Data.image[n]), n))
        groups.append(members)
    groups.sort(key=lambda g: g[0])
    return groups


def _check_same_grid(images, caller):
    first = images[0]
    for img in images[1:]:
        if (tuple(img.dimensions) != tuple(first.dimensions)
                or not np.allclose(img.spacing, first.spacing, atol=1e-4)
                or not np.allclose(img.origin, first.origin, atol=1e-3)
                or not np.allclose(img.matrix, first.matrix, atol=1e-6)):
            raise ValueError(
                f"{caller}: phase images must share one grid "
                f"({img.image_name} differs from {first.image_name})")


def combine_phases(image_names, method="mean", name=None, device=None):
    """Collapse temporal phases into one volume registered as a
    first-class Image: 'mean' (AIP — the average CT used for 4D dose
    calculation), 'mip' (lung-tumor ITV delineation aid) or 'minip'.
    One reduction over the stacked phases on ``device`` (default:
    ``default_device()``). Returns the new Image."""
    import torch

    from ..device import default_device
    from .creation import CreateImageFromMask

    if method not in ("mean", "mip", "minip"):
        raise ValueError(f"combine_phases: unknown method {method!r} "
                         "('mean' | 'mip' | 'minip')")
    if len(image_names) < 2:
        raise ValueError("combine_phases: need at least 2 phase images")
    images = [Data.image[n] if isinstance(n, str) else n
              for n in image_names]
    _check_same_grid(images, "combine_phases")

    device = default_device() if device is None else torch.device(device)
    stack = torch.stack([torch.as_tensor(np.asarray(img.array),
                                         device=device).to(torch.float32)
                         for img in images])
    red = {"mean": lambda t: t.mean(dim=0), "mip": lambda t: t.amax(dim=0),
           "minip": lambda t: t.amin(dim=0)}[method]
    out = red(stack).cpu().numpy()
    src_dtype = np.asarray(images[0].array).dtype
    if np.issubdtype(src_dtype, np.integer):
        info = np.iinfo(src_dtype)
        out = np.rint(np.clip(out, info.min, info.max)).astype(src_dtype)
    else:
        out = out.astype(src_dtype)

    first = images[0]
    if name is None:
        name = f"{first.image_name} {method.upper()}"
    if name in Data.image_list:
        ii = 1
        while f"{name}_{ii}" in Data.image_list:
            ii += 1
        name = f"{name}_{ii}"
    created = CreateImageFromMask(
        out, list(np.asarray(first.origin, float)),
        list(np.asarray(first.spacing, float)), name,
        dimensions=tuple(first.dimensions),
        orientation=list(np.asarray(first.orientation, float)),
        plane=first.plane,
        description=f"{method} of {len(images)} phases",
        modality=first.modality)
    created.add_image()
    return Data.image[name]


def compute_itv(image_names, roi_name, target=None, itv_name=None,
                color=None, device=None):
    """ITV = union of ``roi_name``'s mask across the phase images
    (AAPM TG-76 motion-encompassing target). ``target`` (name/Image,
    default the first phase) receives the new ROI — pass the AIP/MIP
    image from ``combine_phases`` to put the ITV on the planning
    volume. A target on another grid gets the union resampled on
    ``device`` (default: the target's). Returns the new Roi."""
    if len(image_names) < 2:
        raise ValueError("compute_itv: need at least 2 phase images")
    images = [Data.image[n] if isinstance(n, str) else n
              for n in image_names]
    _check_same_grid(images, "compute_itv")

    union = None
    for img in images:
        if roi_name not in img.rois:
            raise KeyError(
                f"compute_itv: {img.image_name} has no ROI {roi_name!r}")
        mask = np.asarray(img.rois[roi_name].compute_mask()) > 0
        union = mask if union is None else (union | mask)

    if target is None:
        target = images[0]
    elif isinstance(target, str):
        target = Data.image[target]
    first = images[0]
    same_grid = (
        tuple(target.dimensions) == tuple(first.dimensions)
        and np.allclose(target.spacing, first.spacing, atol=1e-4)
        and np.allclose(target.origin, first.origin, atol=1e-3)
        and np.allclose(target.matrix, first.matrix, atol=1e-6))
    if not same_grid:
        # geometrically different target (e.g. a coarser planning CT):
        # resample the union mask onto its grid instead of transplanting
        # voxels (a dims-only check used to let that through silently)
        from ..ops.resample import affine_resample, compose_pixel_matrix
        A = compose_pixel_matrix(first.matrix, first.spacing,
                                 first.origin, target.matrix,
                                 target.spacing, target.origin)
        union = (affine_resample(
            union.astype(np.float32), A,
            tuple(int(v) for v in target.dimensions), background=0.0,
            device=device or target._compute_device()) >= 0.5).cpu().numpy()
        if not union.any():
            raise ValueError(
                "compute_itv: the phase-union ROI does not intersect "
                f"the target grid ({target.image_name})")
    itv_name = itv_name or f"ITV_{roi_name}"
    target.create_roi(name=itv_name,
                      color=color or images[0].rois[roi_name].color)
    target.rois[itv_name].convert_mask(union)
    return target.rois[itv_name]
