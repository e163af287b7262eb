"""Dose domain object + DVH analytics.

Port of medicalimageanalysis_tpu/structure/dose.py: the ``Dose``
constructor, the view operations (``ViewOpsMixin``, the off-axis reslice
of the image Display), ``create_volume``, ``compute_dose_statistics``,
``compute_roi_dose_array`` (the dose grid resampled onto the image grid by
the warp kernel's ``affine`` mode, background 0 Gy, gathered inside the
ROI's mask crop from the image's mask cache on the device; its dose-grid
coverage counted on the device from that crop),
``compute_roi_dose_statistics`` (ops/dvh), ``compute_dvh_curve``
(ops/hist, the CUDA histogram kernel on the card), the plan-QA methods
``evaluate_constraints`` (utils/dose), ``compute_gamma`` (the evaluated
dose resampled onto the fine search grid by the ``affine`` mode, then
ops/gamma), the radiobiology (utils/radiobiology), the isodose contours,
the RTDOSE writer ``create_rtdose`` and ``save_image`` / ``load_image``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..data import Data
from ..device import default_device
from ..dicom import generate_uid
from ..ops.dvh import dvh_statistics
from ..ops.hist import dose_below_histogram
from ..ops.resample import affine_resample, compose_pixel_matrix
from ..telemetry import trace
from .common import (GeometryQueriesMixin, MetadataMixin, ViewOpsMixin,
                     host_array)
from .image import Display as ImageDisplay

__all__ = ["COVERAGE", "Display", "Dose"]

# dose-grid coverage evaluations by the path they took: "axis" where the
# image -> dose pixel matrix has its six off-diagonal coefficients 0 (a
# dose grid aligned with its image), "general" for every other map
COVERAGE = {"axis": 0, "general": 0}

_OFF_DIAGONAL = ~np.eye(3, dtype=bool)


def _covered_count(bbox, crop, A, dims_xyz):
    """How many voxels of the ROI, the (Z, Y, X) bool tensor ``crop``
    inside ``bbox`` (z0, z1, y0, y1, x0, x1) of the image grid, have
    their centre inside the dose grid: each coordinate of the image ->
    dose pixel map ``A``, in float64, within [-0.5, dim - 0.5] of
    ``dims_xyz``. The products and sums are the reference's row of
    ``hom @ A.T``, ``((x*A0 + y*A1) + z*A2) + A3``, at the whole grid's
    indices; one count leaves the device."""
    A = np.asarray(A, np.float64)
    hi = np.asarray(dims_xyz, np.float64) - 0.5
    starts = (bbox[4], bbox[2], bbox[0])                    # x, y, z
    if not A[:3, :3][_OFF_DIAGONAL].any():
        COVERAGE["axis"] += 1
        # each coordinate depends on its own axis' index alone, and the
        # zero terms add nothing: fl(fl(i*a) + b) per index, on the host
        keep = []
        for k, (lo, n) in enumerate(zip(starts, crop.shape[::-1])):
            p = np.arange(lo, lo + n, dtype=np.float64) * A[k, k] + A[k, 3]
            keep.append(torch.as_tensor((p >= -0.5) & (p <= hi[k]),
                                        device=crop.device))
        bx, by, bz = keep
        return int((crop & bz[:, None, None] & by[None, :, None]
                    & bx[None, None, :]).sum())
    COVERAGE["general"] += 1
    zyx = (torch.nonzero(crop) + torch.tensor(
        starts[::-1], device=crop.device)).to(torch.float64)
    x, y, z = zyx[:, 2], zyx[:, 1], zyx[:, 0]
    ok = torch.ones(zyx.shape[0], dtype=torch.bool, device=crop.device)
    for row, top in zip(A[:3].tolist(), hi.tolist()):
        p = x * row[0] + y * row[1] + z * row[2] + row[3]
        ok &= (p >= -0.5) & (p <= top)
    return int(ok.sum())


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

    @trace("mia.dose.roi_dose")
    def _roi_dose(self, image_name, roi_name, device):
        """(the dose resampled onto the image grid and gathered inside the
        ROI, as a 1-d float32 tensor on ``device``; the image -> dose
        pixel matrix; the ROI's mask on ``device`` as (bbox, bool crop),
        (None, None) for an empty ROI). The mask comes from the image's
        mask cache on the device (``Image._roi_mask_device``), so no
        whole mask is rebuilt or uploaded; boolean indexing of the C-order
        crop yields the voxels in the order the whole volume's does."""
        image = Data.image[image_name]
        bbox, crop = image._roi_mask_device(roi_name, image.rois[roi_name],
                                            device)
        A = compose_pixel_matrix(self.matrix, self.spacing, self.origin,
                                 image.matrix, image.spacing, image.origin)
        resampled = affine_resample(np.asarray(self.array, np.float32), A,
                                    image.array.shape, background=0.0,
                                    device=device)
        if bbox is None:
            return resampled.new_empty(0), A, (bbox, crop)
        z0, z1, y0, y1, x0, x1 = bbox
        return resampled[z0:z1, y0:y1, x0:x1][crop], A, (bbox, crop)

    def compute_roi_dose_array(self, image_name, roi_name,
                               return_coverage=False):
        """Resample the dose grid onto the image grid and extract the
        masked voxels (reference structure/dose.py:738-772), as a numpy
        float32 array.

        With ``return_coverage=True`` also returns the fraction of ROI
        voxels whose center falls inside the dose grid (voxels outside it
        enter the array as background 0 Gy), in float64 as the reference
        tests each voxel; the voxels are counted on the device from the
        mask crop ``_roi_dose`` fetched, and only the count comes back
        (``COVERAGE`` counts the evaluations by path)."""
        values, A, (bbox, crop) = self._roi_dose(image_name, roi_name,
                                                 default_device())
        with trace("mia.dose.values_out"):
            values = values.cpu().numpy()
        if not return_coverage:
            return values
        with trace("mia.dose.coverage"):
            if values.size == 0:
                return values, 1.0
            covered = _covered_count(
                bbox, crop, A, np.asarray(self.dimensions)[::-1])
            return values, covered / values.size

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

    @trace("mia.dose.dvh")
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

    # -- plan QA -----------------------------------------------------------
    def evaluate_constraints(self, goals, image_name=None):
        """Evaluate clinical DVH goals ({roi: ['D95% >= 70Gy',
        'V20Gy <= 35%', ...]}) against this dose; see
        utils/dose.evaluate_constraints."""
        from ..utils.dose import evaluate_constraints
        return evaluate_constraints(self, goals, image_name=image_name)

    @trace("mia.gamma")
    def compute_gamma(self, dose_name, dose_pct=3.0, dta_mm=3.0,
                      local=False, norm_dose=None, threshold_pct=10.0,
                      subdiv=None, cap=2.0, chunk=None):
        """3-D gamma analysis of another registered dose (a name or a
        Dose) against this one (this grid is the reference). The
        evaluated dose is resampled in one trilinear interpolation from
        its own grid onto the TG-218 fine search grid aligned with this
        grid (the warp kernel's ``affine`` mode, background ``_OUTSIDE``),
        then ops/gamma.gamma_index scans the offsets on the same device.
        Returns the gamma map on this grid plus pass rate / mean / max
        over the >= threshold region."""
        from ..ops.gamma import (_OUTSIDE, fine_grid_layout,
                                 fine_grid_shape, fine_to_ref_pixel_matrix,
                                 gamma_index)

        other = Data.dose[dose_name] if isinstance(dose_name, str) \
            else dose_name
        layout = fine_grid_layout(self.spacing, dta_mm, subdiv, cap)
        s, r = layout[0], layout[1]
        A = compose_pixel_matrix(
            other.matrix, other.spacing, other.origin,
            self.matrix, self.spacing, self.origin
        ).astype(np.float64) @ fine_to_ref_pixel_matrix(s, r)
        # array.shape, not self.dimensions: non-axial doses keep
        # dimensions in (x, y, z)-permuted order while the array is zyx
        with trace("mia.gamma.resample"):
            fine = affine_resample(
                np.asarray(other.array, np.float32), A.astype(np.float32),
                fine_grid_shape(tuple(np.asarray(self.array).shape), s, r),
                background=float(_OUTSIDE), device=default_device())
        return gamma_index(np.asarray(self.array, np.float32), fine,
                           self.spacing, dose_pct=dose_pct, dta_mm=dta_mm,
                           local=local, norm_dose=norm_dose,
                           threshold_pct=threshold_pct, subdiv=subdiv,
                           cap=cap, chunk=chunk, layout=layout)

    def compute_isodose_contours(self, levels=None, percent_of=None):
        """Per-slice isodose contours on this grid. ``levels``: absolute Gy
        values (default deciles of max); ``percent_of``: when set, levels
        are percent of this dose (e.g. prescription). Returns
        {level_gy: (contour_pixel, contour_position)} from MaskToContour
        (holes traced, XOR-exact). Each level's mask is thresholded on the
        card (``default_device()``) and traced on the host."""
        from ..utils.convert.contour import MaskToContour

        arr = torch.as_tensor(np.asarray(self.array, np.float32),
                              device=default_device())
        if levels is None:
            # percent deciles when percent_of is given, absolute deciles
            # of max otherwise
            if percent_of is not None:
                levels = list(range(10, 100, 10))
            else:
                mx = float(arr.max())
                if mx <= 0.0:
                    return {}
                levels = (np.arange(1, 10) / 10.0 * mx).tolist()
        out = {}
        for lv in levels:
            gy = float(lv) * float(percent_of) / 100.0 \
                if percent_of is not None else float(lv)
            mask = (arr >= gy).to(torch.uint8).cpu().numpy()
            pix, pos = MaskToContour(
                mask, spacing=self.spacing, origin=self.origin,
                matrix=self.matrix, plane=self.plane).create_contours()
            out[gy] = (pix, pos)
        return out

    # -- radiobiology (host float64 numpy, as the JAX package) -------------
    def _register_converted(self, out, kind, n_fractions, alpha_beta,
                            name):
        from ..utils.dose import register_dose_grid
        return register_dose_grid(
            out, self, name=name,
            description=f"{kind}(ab={float(alpha_beta):g}) of "
                        f"{self.dose_name}",
            misc={"source_dose": self.dose_name,
                  "alpha_beta": float(alpha_beta),
                  "n_fractions": float(n_fractions)})

    def compute_eqd2(self, n_fractions, alpha_beta, name=None,
                     register=True):
        """Voxel-wise EQD2 grid (LQ model, utils/radiobiology.eqd2). With
        ``register`` (default) the converted grid becomes a first-class
        Dose, so every DVH analytic and gamma works on it."""
        from ..utils.radiobiology import eqd2

        out = eqd2(np.asarray(self.array, np.float32), n_fractions,
                   alpha_beta)
        if not register:
            return out
        return self._register_converted(out, "EQD2", n_fractions,
                                        alpha_beta, name)

    def compute_bed(self, n_fractions, alpha_beta, name=None,
                    register=True):
        """Voxel-wise BED grid (utils/radiobiology.bed)."""
        from ..utils.radiobiology import bed

        out = bed(np.asarray(self.array, np.float32), n_fractions,
                  alpha_beta)
        if not register:
            return out
        return self._register_converted(out, "BED", n_fractions,
                                        alpha_beta, name)

    def compute_geud(self, image_name, roi_name, a):
        """Generalized EUD of this dose over an ROI."""
        from ..utils.radiobiology import geud
        return geud(self.compute_roi_dose_array(image_name, roi_name), a)

    def compute_ntcp(self, image_name, roi_name, td50, m=None, n=None,
                     gamma50=None, a=None, model="lkb"):
        """NTCP of an organ ROI: ``model='lkb'`` (probit, needs m and n)
        or ``'logistic'`` (Niemierko, needs gamma50 and a)."""
        from ..utils.radiobiology import ntcp_lkb, ntcp_logistic

        dose_in_roi = self.compute_roi_dose_array(image_name, roi_name)
        if model == "lkb":
            if m is None or n is None:
                raise ValueError("LKB NTCP needs m and n")
            return ntcp_lkb(dose_in_roi, td50, m, n)
        if model == "logistic":
            if gamma50 is None or a is None:
                raise ValueError("logistic NTCP needs gamma50 and a")
            return ntcp_logistic(dose_in_roi, td50, gamma50, a)
        raise ValueError(f"unknown NTCP model {model!r}")

    def compute_tcp(self, image_name, roi_name, tcd50, gamma50,
                    a=-10.0):
        """Logistic TCP of a target ROI (utils/radiobiology)."""
        from ..utils.radiobiology import tcp_logistic
        return tcp_logistic(
            self.compute_roi_dose_array(image_name, roi_name), tcd50,
            gamma50, a)

    # -- DICOM export and persistence (JAX structure/dose.py:310-446) -----
    def create_rtdose(self, path=None, dose_summation_type="PLAN"):
        """An RTDOSE (RT Dose Storage) dataset of this grid: uint32 pixels
        with DoseGridScaling = max / 4e9 from the grid in float64 (the
        stored values round half to even, as numpy's), frame offsets
        signed by the slice direction. Negative doses raise. Returns the
        Dataset; writes a Part-10 file when ``path`` is given."""
        from ..dicom import Dataset, dcmwrite, uids
        from ..ops import geometry as geo

        arr = host_array(self.array, np.float64)
        if arr.size and float(arr.min()) < 0:
            raise ValueError(
                "create_rtdose: negative dose voxels (min "
                f"{float(arr.min()):.4g} Gy) are not representable in "
                "RT Dose Storage's unsigned pixels — dose differences "
                "cannot be exported; clamp or split the grid first")
        ds = Dataset()
        ds.SOPClassUID = uids.RTDoseStorage
        ds.SOPInstanceUID = generate_uid()
        ds.Modality = "RTDOSE"
        ds.PatientID = self.mrn if self.mrn != "missing" else ""
        if isinstance(self.patient_name, list):
            ds.PatientName = "^".join(self.patient_name)
        ds.SeriesInstanceUID = generate_uid()
        ds.StudyInstanceUID = self.get_study_uid()
        ds.FrameOfReferenceUID = self.frame_ref

        ds.ImagePositionPatient = [float(v) for v in self.origin]
        iop, pixel_spacing = geo.grid_plane_tags(self.matrix, self.spacing)
        ds.ImageOrientationPatient = iop
        ds.PixelSpacing = pixel_spacing
        ds.SliceThickness = float(self.spacing[2])
        # offsets run along the stored-frame direction: +|sz| when the
        # matrix z-row is the written orientation's normal, -|sz| when
        # flipped
        m = np.asarray(self.matrix, float)
        normal = np.cross(m[0], m[1])
        sign = 1.0 if float(np.dot(m[2], normal)) >= 0 else -1.0
        ds.GridFrameOffsetVector = [
            float(sign * i * self.spacing[2]) for i in range(arr.shape[0])]

        scaling = float(arr.max()) / 4.0e9 if arr.max() > 0 else 1.0
        ds.DoseGridScaling = scaling
        ds.DoseUnits = "GY"
        ds.DoseType = "PHYSICAL"
        ds.DoseSummationType = dose_summation_type
        ds.NumberOfFrames = int(arr.shape[0])
        ds.Rows, ds.Columns = int(arr.shape[1]), int(arr.shape[2])
        ds.BitsAllocated = ds.BitsStored = 32
        ds.HighBit = 31
        ds.PixelRepresentation = 0
        ds.SamplesPerPixel = 1
        ds.PhotometricInterpretation = "MONOCHROME2"
        ds.PixelData = np.round(arr / scaling).astype("<u4").tobytes()

        if path is not None:
            dcmwrite(path, ds)
        return ds

    def save_image(self, path):
        """``{path}/{dose_name}/meta.json`` + ``array.npy``; the SOP UIDs
        ride along, since they carry the plan <-> dose link."""
        base = os.path.join(str(path), self.dose_name)
        os.makedirs(base, exist_ok=True)
        meta = {
            "dose_name": self.dose_name, "modality": self.modality,
            "patient_name": self.patient_name, "mrn": self.mrn,
            "birthdate": str(self.birthdate),
            "date": str(self.date), "time": str(self.time),
            "series_uid": self.series_uid, "frame_ref": self.frame_ref,
            "sops": [str(s) for s in self.sops],
            "plane": self.plane,
            "spacing": np.asarray(self.spacing, dtype=float).tolist(),
            "dimensions": np.asarray(self.dimensions).astype(int).tolist(),
            "orientation": np.asarray(self.orientation,
                                      dtype=float).tolist(),
            "origin": np.asarray(self.origin, dtype=float).tolist(),
            "matrix": np.asarray(self.matrix, dtype=float).tolist(),
        }
        with open(os.path.join(base, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        if self.array is not None:
            np.save(os.path.join(base, "array.npy"), host_array(self.array))

    @classmethod
    def load_image(cls, dose_path, device=None):
        """A :meth:`save_image` folder back into ``Data.dose`` under its
        saved name, collision-suffixed. ``device`` (default: the card) is
        checked first: without a card and without ``device='cpu'`` this
        raises, as every entry point does."""
        import types

        from .common import collision_suffix, rebuild_dataset_from_meta

        device = default_device() if device is None else device
        base = str(dose_path)
        with open(os.path.join(base, "meta.json")) as f:
            meta = json.load(f)
        arr_path = os.path.join(base, "array.npy")
        array = np.load(arr_path) if os.path.exists(arr_path) else None

        ds = rebuild_dataset_from_meta(
            meta, os.path.join(base, "meta.json"), "RTDOSE")
        name = collision_suffix(meta.get("dose_name", "RTDOSE 01"),
                                Data.dose)

        carrier = types.SimpleNamespace(
            image_set=[ds],
            array=array,
            dose_name=name,
            modality=meta.get("modality", "RTDOSE"),
            filepaths=[ds.filename],
            sops=meta.get("sops", []),
            plane=meta.get("plane", "Axial"),
            spacing=np.asarray(meta["spacing"], np.float64),
            dimensions=np.asarray(meta["dimensions"]),
            orientation=np.asarray(meta["orientation"], np.float64),
            origin=np.asarray(meta["origin"], np.float64),
            image_matrix=np.asarray(meta["matrix"], np.float64),
        )
        dose_obj = cls(carrier)
        Data.dose[name] = dose_obj
        Data.dose_list += [name]
        return dose_obj
