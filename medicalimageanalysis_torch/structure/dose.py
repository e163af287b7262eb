"""Dose domain object + DVH analytics.

Port of medicalimageanalysis_tpu/structure/dose.py: the ``Dose``
constructor, the view operations (``ViewOpsMixin``, the off-axis reslice
of the image Display), ``create_volume``, ``compute_dose_statistics``,
``compute_roi_dose_array`` (the dose grid resampled onto the image grid by
the warp kernel's ``affine`` mode, background 0 Gy),
``compute_roi_dose_statistics`` (ops/dvh) and ``compute_dvh_curve``
(ops/hist, the CUDA histogram kernel on the card). Gamma, isodose
contours, radiobiology, the RTDOSE writer, save/load and
``evaluate_constraints`` raise naming their ROADMAP.md items.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..data import Data
from ..device import default_device
from ..dicom import generate_uid
from ..ops.dvh import dvh_statistics
from ..ops.hist import dose_below_histogram
from ..ops.resample import affine_resample, compose_pixel_matrix
from .common import GeometryQueriesMixin, MetadataMixin, ViewOpsMixin, waits
from .image import Display as ImageDisplay

__all__ = ["Display", "Dose"]


_waits = partial(waits, "Dose")


class Display(ImageDisplay):
    """The image Display's slicing machinery (reference
    structure/dose.py:35-314 duplicates it verbatim)."""


class Dose(MetadataMixin, GeometryQueriesMixin, ViewOpsMixin):
    """3D dose grid + metadata + DVH analytics
    (reference structure/dose.py:317-1124). The array stays a numpy
    float32 array in Gy, like the JAX package's."""

    def __init__(self, dose):
        self.tags = dose.image_set
        self.array = dose.array

        self.dose_name = dose.dose_name
        self.modality = dose.modality

        self.patient_name = self.get_patient_name()
        self.mrn = self.get_mrn()
        self.birthdate = self.get_birthdate()
        self.date = self.get_date()
        self.time = self.get_time()
        self.local_uid = generate_uid()
        self.series_uid = self.get_series_uid()
        self.acq_number = self.get_acq_number()
        self.frame_ref = self.get_frame_ref()
        self.window = self.get_window()

        self.filepaths = dose.filepaths
        self.sops = dose.sops

        self.plane = dose.plane
        self.spacing = dose.spacing
        self.dimensions = dose.dimensions
        self.orientation = dose.orientation
        self.origin = dose.origin
        self.matrix = dose.image_matrix

        self.camera_position = None
        self.misc = {}

        self.rois = {}
        self.display = Display(self)

    def create_volume(self):
        """Grid bundle (replaces create_sitk_image, dose.py:894-918)."""
        return {"array": np.asarray(self.array),
                "origin": np.asarray(self.origin, dtype=float),
                "spacing": np.asarray(self.spacing, dtype=float),
                "direction": np.asarray(self.matrix, dtype=float)}

    create_sitk_image = create_volume

    # -- DVH analytics ----------------------------------------------------
    def compute_dose_statistics(self):
        """Whole-grid dose statistics: min/max/mean/median/std over the
        dose grid plus the integral dose in Gy*cc."""
        arr = np.asarray(self.array, np.float32)
        voxel_cc = float(np.prod(np.asarray(self.spacing))) / 1000.0
        return {
            "min": float(arr.min()),
            "max": float(arr.max()),
            "mean": float(arr.mean()),
            "median": float(np.median(arr)),
            "std": float(arr.std()),
            "integral_gy_cc": float(arr.sum() * voxel_cc),
            "grid_volume_cc": float(arr.size * voxel_cc),
        }

    def _roi_dose(self, image_name, roi_name, device):
        """(the dose resampled onto the image grid and masked by the ROI,
        as a 1-d float32 tensor on ``device``; the image -> dose pixel
        matrix; the mask)."""
        image = Data.image[image_name]
        mask = image.rois[roi_name].compute_mask()
        A = compose_pixel_matrix(self.matrix, self.spacing, self.origin,
                                 image.matrix, image.spacing, image.origin)
        resampled = affine_resample(np.asarray(self.array, np.float32), A,
                                    image.array.shape, background=0.0,
                                    device=device)
        inside = torch.as_tensor(mask, device=device) > 0
        return resampled[inside], A, mask

    def compute_roi_dose_array(self, image_name, roi_name,
                               return_coverage=False):
        """Resample the dose grid onto the image grid and extract the
        masked voxels (reference structure/dose.py:738-772), as a numpy
        float32 array.

        With ``return_coverage=True`` also returns the fraction of ROI
        voxels whose center falls inside the dose grid (voxels outside it
        enter the array as background 0 Gy)."""
        values, A, mask = self._roi_dose(image_name, roi_name,
                                         default_device())
        values = values.cpu().numpy()
        if not return_coverage:
            return values
        idx = np.argwhere(mask > 0)
        if idx.size == 0:
            return values, 1.0
        hom = np.concatenate(
            [idx[:, ::-1].astype(np.float64),
             np.ones((idx.shape[0], 1))], axis=1)        # (N, 4) xyz1
        dose_px = hom @ np.asarray(A, np.float64).T
        dims_xyz = np.asarray(self.dimensions, np.float64)[::-1]
        inside = np.all((dose_px[:, :3] >= -0.5)
                        & (dose_px[:, :3] <= dims_xyz - 0.5), axis=1)
        return values, float(inside.mean())

    def compute_roi_dose_statistics(self, image_name, roi_name,
                                    max_dose=150, increment=5):
        """Volume cc, Dmin/Dmax/Dmean/Dmedian/Dstd, D1..D99, VS{d}Gy bins
        (reference structure/dose.py:774-816), on the device."""
        spacing = Data.image[image_name].spacing
        dose_in_roi, _, _ = self._roi_dose(image_name, roi_name,
                                           default_device())
        voxel_vol_cc = np.prod(spacing) / 1000.0
        return dvh_statistics(dose_in_roi, voxel_vol_cc,
                              roi_name=roi_name, max_dose=max_dose,
                              increment=increment)

    def compute_dvh_curve(self, image_name, roi_name, n_bins=300,
                          max_dose=None):
        """Cumulative DVH curve: (dose_gy (n_bins,) float64,
        volume_percent (n_bins,) float32), the percentages from the
        histogram kernel's counts."""
        dose_in_roi, _, _ = self._roi_dose(image_name, roi_name,
                                           default_device())
        if dose_in_roi.numel() == 0:
            return np.zeros(0), np.zeros(0)
        if max_dose is None:
            max_dose = float(dose_in_roi.max()) * 1.05 + 1e-6
        bins = np.linspace(0.0, max_dose, n_bins)
        below = dose_below_histogram(
            dose_in_roi, torch.ones_like(dose_in_roi), bins)
        # the JAX kernel's counts are float32: the same arithmetic on them
        below = below.cpu().numpy().astype(np.float32)
        volume_percent = 100.0 * (1.0 - below / dose_in_roi.numel())
        return bins, volume_percent

    evaluate_constraints = _waits("evaluate_constraints",
                                  "item 8, utils/dose")
    compute_gamma = _waits("compute_gamma", "item 8, ops/gamma")
    compute_isodose_contours = _waits(
        "compute_isodose_contours", "item 6, MaskToContour without cv2")
    compute_eqd2 = _waits("compute_eqd2", "item 8, utils/radiobiology")
    compute_bed = _waits("compute_bed", "item 8, utils/radiobiology")
    compute_geud = _waits("compute_geud", "item 8, utils/radiobiology")
    compute_ntcp = _waits("compute_ntcp", "item 8, utils/radiobiology")
    compute_tcp = _waits("compute_tcp", "item 8, utils/radiobiology")
    create_rtdose = _waits("create_rtdose", "item 8, the RTDOSE writer")
    save_image = _waits("save_image", "item 8, dose save/load")
    load_image = classmethod(_waits("load_image", "item 8, dose save/load"))
    compute_corner_sides = _waits("compute_corner_sides", "item 9, mesh")
