"""Multi-fraction dose accumulation and clinical-goal evaluation.

Port of medicalimageanalysis_tpu/utils/dose.py: ``register_dose_grid``
(a float grid as a first-class ``Data.dose`` entry, on the port's own
``dicom.Dataset``), ``accumulate_dose`` (rigid entries resampled by the
warp kernel's ``affine`` mode, deformable entries through
``Deformable.update_dose``, summed on the device) and
``evaluate_constraints`` (DVH goals from the sorted ROI doses in host
float64, as the JAX package computes them). A goal on a mesh-only ROI
reads the mesh voxelized on the card (``Roi.compute_mask``).
"""

from __future__ import annotations

import re
import types

import numpy as np
import torch

from ..data import Data
from ..device import default_device

__all__ = ["accumulate_dose", "register_dose_grid",
           "evaluate_constraints"]


def register_dose_grid(array, like, name=None, description="derived",
                       misc=None):
    """Register a float dose grid as a first-class ``Data.dose`` entry
    on the geometry of ``like`` (an Image or Dose: needs plane/spacing/
    origin/matrix/frame_ref). Re-registering an explicit ``name``
    replaces the previous entry. Returns the Dose object."""
    from ..dicom import Dataset, generate_uid
    from ..read.dicom import create_dose_name
    from ..structure.dose import Dose

    array = np.asarray(array, np.float32)
    ds = Dataset()
    ds.Modality = "RTDOSE"
    ds.SOPInstanceUID = generate_uid()
    ds.SeriesInstanceUID = generate_uid()
    if callable(getattr(like, "get_study_uid", None)) \
            and getattr(like, "tags", None):
        ds.StudyInstanceUID = like.get_study_uid()
    if getattr(like, "frame_ref", None):
        ds.FrameOfReferenceUID = like.frame_ref
    ds.SeriesDescription = description
    ds.filename = f"<{description}>"

    carrier = types.SimpleNamespace(
        image_set=[ds],
        array=array,
        dose_name=(name if name is not None
                   else create_dose_name("RTDOSE")),
        modality="RTDOSE",
        filepaths=[str(ds.filename)],
        sops=[str(ds.SOPInstanceUID)],
        plane=like.plane,
        spacing=np.asarray(like.spacing, np.float64),
        dimensions=np.asarray(array.shape),
        orientation=np.asarray(like.orientation, np.float64),
        origin=np.asarray(like.origin, np.float64),
        image_matrix=np.asarray(like.matrix, np.float64),
    )
    dose_obj = Dose(carrier)
    if misc:
        dose_obj.misc.update(misc)
    if carrier.dose_name not in Data.dose:
        Data.dose_list += [carrier.dose_name]
    Data.dose[carrier.dose_name] = dose_obj
    return dose_obj


def accumulate_dose(image_name, contributions, weights=None, name=None,
                    register=True):
    """Sum dose grids on the grid of ``Data.image[image_name]``.

    Parameters
    ----------
    contributions : list
        Each entry is either a dose name (rigidly resampled onto the
        image grid — already in or co-registered to its frame), or a
        ``(dose_name, deformable_name)`` pair — the dose is warped
        through that Deformable (whose ``reference_name`` must be
        ``image_name``) via ``Deformable.update_dose``.
    weights : list of float, optional
        Per-contribution scale (e.g. fraction weighting); default 1.
    name : str, optional
        Dose name to register under; default sequential RTDOSE name.
    register : bool
        When True (default) the summed grid is registered in
        ``Data.dose`` as a Dose and returned; when False a plain
        volume dict is returned instead.
    """
    from ..ops.resample import affine_resample, compose_pixel_matrix

    if not contributions:
        raise ValueError("accumulate_dose: empty contributions")
    if image_name not in Data.image:
        raise KeyError(f"accumulate_dose: unknown image {image_name!r}")
    ref = Data.image[image_name]
    if weights is None:
        weights = [1.0] * len(contributions)
    if len(weights) != len(contributions):
        raise ValueError("accumulate_dose: len(weights) != "
                         "len(contributions)")

    device = ref.device if getattr(ref, "device", None) is not None \
        else default_device()
    shape = tuple(int(v) for v in ref.dimensions)
    total = torch.zeros(shape, dtype=torch.float32, device=device)
    source_doses = []
    for entry, w in zip(contributions, weights):
        if isinstance(entry, (tuple, list)):
            dose_name, deformable_name = entry
            defo = Data.deformable[deformable_name]
            if defo.reference_name != image_name:
                raise ValueError(
                    f"accumulate_dose: deformable {deformable_name!r} "
                    f"reference is {defo.reference_name!r}, not "
                    f"{image_name!r}")
            vol = defo.update_dose(dose_name)
            arr = torch.as_tensor(vol["array"], device=device)
            source_doses.append(vol["dose_name"])
        else:
            dose = Data.dose[entry]
            A = compose_pixel_matrix(dose.matrix, dose.spacing,
                                     dose.origin, ref.matrix,
                                     ref.spacing, ref.origin)
            arr = affine_resample(np.asarray(dose.array, np.float32), A,
                                  shape, background=0.0, device=device)
            source_doses.append(entry)
        # the weight's product, then the sum: two float32 roundings, as
        # numpy's total += w * arr
        total += torch.as_tensor(np.float32(w), device=device) \
            * arr.to(torch.float32)
    total = total.cpu().numpy()

    if not register:
        return {"array": total, "origin": np.asarray(ref.origin),
                "spacing": np.asarray(ref.spacing),
                "direction": np.asarray(ref.matrix),
                "source_doses": source_doses}

    # re-running with the same explicit name replaces the previous
    # result instead of leaving a duplicate dose_list entry
    return register_dose_grid(
        total, ref, name=name,
        description="accumulated: " + ", ".join(source_doses),
        misc={"source_doses": source_doses})


# --------------------------------------------------------------------
# clinical-goal evaluation
# --------------------------------------------------------------------
_GOAL_RE = re.compile(
    r"^\s*([DV])\s*"
    r"(max|min|mean|median|[0-9]+(?:\.[0-9]+)?\s*(?:%|cc|Gy))\s*"
    r"(<=|>=|<|>)\s*"
    r"([0-9]+(?:\.[0-9]+)?)\s*"
    r"(Gy|%|cc)\s*$",
    re.IGNORECASE)


def _parse_goal(goal):
    m = _GOAL_RE.match(goal)
    if not m:
        raise ValueError(
            f"evaluate_constraints: cannot parse goal {goal!r} "
            "(expected e.g. 'D95% >= 70Gy', 'Dmax < 50Gy', "
            "'D2cc <= 30Gy', 'V20Gy <= 35%', 'V30Gy <= 500cc')")
    kind = m.group(1).upper()
    qual = m.group(2).replace(" ", "")
    comparator = m.group(3)
    limit = float(m.group(4))
    unit = {"gy": "Gy", "%": "%", "cc": "cc"}[m.group(5).lower()]
    ql = qual.lower()
    if kind == "D":
        if unit != "Gy":
            raise ValueError(
                f"evaluate_constraints: D-metric limit must be in Gy "
                f"({goal!r})")
        if ql not in ("max", "min", "mean", "median") \
                and not (ql.endswith("%") or ql.endswith("cc")):
            raise ValueError(
                f"evaluate_constraints: bad D qualifier in {goal!r}")
    else:
        if not ql.endswith("gy"):
            raise ValueError(
                f"evaluate_constraints: V-metric threshold must be in "
                f"Gy ({goal!r})")
        if unit not in ("%", "cc"):
            raise ValueError(
                f"evaluate_constraints: V-metric limit must be % or cc "
                f"({goal!r})")
    return kind, qual, comparator, limit, unit


def _metric_value(kind, qual, unit, dose_in_roi, voxel_cc):
    d = np.asarray(dose_in_roi, np.float64)
    ql = qual.lower()
    if kind == "D":
        if ql == "max":
            return float(d.max())
        if ql == "min":
            return float(d.min())
        if ql == "mean":
            return float(d.mean())
        if ql == "median":
            return float(np.median(d))
        if ql.endswith("%"):
            p = float(ql[:-1])
            if not 0.0 < p <= 100.0:
                raise ValueError(
                    f"evaluate_constraints: D{qual} out of (0, 100]")
            # dose received by at least p% of the volume
            return float(np.percentile(d, 100.0 - p))
        # D<v>cc: dose to the hottest v cc
        v = float(ql[:-2])
        k = int(np.clip(round(v / voxel_cc), 1, d.size))
        return float(np.sort(d)[::-1][k - 1])
    # V<d>Gy
    thresh = float(ql[:-2])
    covered = d >= thresh
    if unit == "%":
        return float(100.0 * covered.mean())
    return float(covered.sum() * voxel_cc)


def evaluate_constraints(dose, goals, image_name=None):
    """Evaluate clinical DVH goals against a dose — BEYOND-PARITY
    (plan-QA tooling the reference lacks; its DVH support stops at the
    statistics dict, reference structure/dose.py:774-816).

    Parameters
    ----------
    dose : Dose or str
        Dose object or registered ``Data.dose`` name.
    goals : dict
        ``{roi_name: [goal, ...]}``. Each goal is a string in the
        QUANTEC/TPS idiom: ``D``-metrics (``Dmax/Dmin/Dmean/Dmedian``,
        ``D95%`` dose covering 95% of the volume, ``D2cc`` dose to the
        hottest 2 cc) compared against Gy, and ``V``-metrics
        (``V20Gy`` volume receiving >= 20 Gy) compared against ``%``
        or ``cc``. Comparators: ``<= >= < >``.
    image_name : str, optional
        Image whose ROIs the goals reference; defaults to the single
        registered image.

    Returns a list of dicts ``{roi, goal, metric, value, comparator,
    limit, unit, passed, dose_grid_coverage}`` (``value`` is NaN and
    ``passed`` False for an empty ROI), in the given order. Exact
    voxel-level evaluation (sorting/percentiles of the masked dose),
    not a binned approximation.

    ``dose_grid_coverage`` is the fraction of ROI voxels inside the
    dose grid: voxels beyond it enter the metrics as 0 Gy (RTDOSE
    grids are often cropped), which silently biases V-goals and
    Dmean/Dmin toward passing — any ROI with coverage < 1 also raises
    a ``UserWarning`` naming the ROI.
    """
    import warnings

    dose = Data.dose[dose] if isinstance(dose, str) else dose
    if image_name is None:
        if len(Data.image_list) != 1:
            raise ValueError(
                "evaluate_constraints: image_name required when "
                f"{len(Data.image_list)} images are registered")
        image_name = Data.image_list[0]
    spacing = Data.image[image_name].spacing
    voxel_cc = float(np.prod(np.asarray(spacing, np.float64))) / 1000.0

    ops = {"<=": np.less_equal, ">=": np.greater_equal,
           "<": np.less, ">": np.greater}
    results = []
    image = Data.image[image_name]
    for roi_name, goal_list in goals.items():
        roi = image.rois.get(roi_name)
        if roi is None:
            raise KeyError(
                f"evaluate_constraints: image {image_name!r} has no "
                f"ROI {roi_name!r}")
        if not roi.contour_position and roi.mesh is None:
            dose_in_roi = np.zeros(0, np.float32)  # empty ROI
            coverage = 1.0
        else:
            dose_in_roi, coverage = dose.compute_roi_dose_array(
                image_name, roi_name, return_coverage=True)
        if coverage < 1.0:
            warnings.warn(
                f"evaluate_constraints: only {100.0 * coverage:.1f}% of "
                f"ROI {roi_name!r} lies inside the dose grid — the "
                "uncovered voxels count as 0 Gy, so these goal results "
                "are unreliable", UserWarning, stacklevel=2)
        for goal in goal_list:
            kind, qual, comparator, limit, unit = _parse_goal(goal)
            if dose_in_roi.size == 0:
                value, passed = float("nan"), False
            else:
                value = _metric_value(kind, qual, unit, dose_in_roi,
                                      voxel_cc)
                passed = bool(ops[comparator](value, limit))
            results.append({
                "roi": roi_name, "goal": goal,
                "metric": f"{kind}{qual}", "value": value,
                "comparator": comparator, "limit": limit,
                "unit": unit, "passed": passed,
                "dose_grid_coverage": coverage,
            })
    return results
