"""RTDOSE reader: dose grid -> Dose object.

Port of medicalimageanalysis_tpu/read/rtdose.py (reference
read/dicom.py:1856-2110): pixel_array * DoseGridScaling,
SliceThickness-NaN fallback to the GridFrameOffsetVector pitch, the same
plane/orientation/FFS machinery as Read3D (host decision, rescale and
move on ``device``), sequential dose naming. The uint32 stored values
cross to the device as their bit pattern and round to float32 there as
XLA's ``astype(float32)`` does (ops/volume.stored_to_float).
"""

from __future__ import annotations

import numpy as np

from ..data import Data
from ..ops import geometry as geo
from ..ops.volume import assemble_volume
from ..structure.dose import Dose
from .dicom import create_dose_name

__all__ = ["ReadRTDose"]


class ReadRTDose(object):
    def __init__(self, image_set, only_tags, device=None):
        self.image_set = image_set if isinstance(image_set, list) \
            else [image_set]
        self.only_tags = only_tags
        self.device = device
        self.unverified = None
        self.base_position = None
        self.skipped_slice = None

        self.modality = "RTDOSE"
        self.filepaths = [img.filename for img in self.image_set]
        self.sops = [img.SOPInstanceUID for img in self.image_set]

        self.orientation = self._compute_orientation()
        self.plane = geo.plane_from_orientation(self.orientation)
        self.spacing = self._compute_spacing()
        self.dimensions = self._compute_dimensions()

        self.array = None
        self._assemble_and_verify()

        self.image_matrix = geo.orientation_to_matrix(self.orientation)
        self.dose_name = create_dose_name(self.modality)

        dose = Dose(self)
        Data.dose[self.dose_name] = dose
        Data.dose_list += [self.dose_name]

    def _compute_orientation(self):
        """(reference read/dicom.py:1919-1944)."""
        orientation = np.asarray([1, 0, 0, 0, 1, 0], dtype=np.float64)
        ds = self.image_set[0]
        if "ImageOrientationPatient" in ds:
            orientation = np.asarray(ds["ImageOrientationPatient"].value,
                                     dtype=np.float64)
        elif "SharedFunctionalGroupsSequence" in ds:
            try:
                seq = ds.SharedFunctionalGroupsSequence[0]
                orientation = np.asarray(
                    seq.PlaneOrientationSequence[0].ImageOrientationPatient,
                    dtype=np.float64)
            except Exception:
                self.unverified = "Orientation"
        else:
            self.unverified = "Orientation"
        return orientation

    def _compute_spacing(self):
        """SliceThickness with NaN fallback to GridFrameOffsetVector
        pitch (reference read/dicom.py:1946-1995)."""
        ds = self.image_set[0]
        inplane_spacing = [1, 1]
        slice_thickness = np.double(ds.SliceThickness) \
            if "SliceThickness" in ds and ds.SliceThickness is not None \
            else np.double("nan")
        if np.isnan(slice_thickness) and "GridFrameOffsetVector" in ds:
            grid_vector = ds.GridFrameOffsetVector
            if len(grid_vector) > 1:
                # abs: descending offsets (frames stacked against the
                # orientation normal) are normalized by a frame flip
                # in _assemble_and_verify, not a negative pitch
                slice_thickness = abs(grid_vector[1] - grid_vector[0])
        if np.isnan(slice_thickness):
            slice_thickness = 1.0

        if "PixelSpacing" in ds:
            inplane_spacing = ds.PixelSpacing
        elif "ContributingSourcesSequence" in ds:
            seq = ds.ContributingSourcesSequence[0]
            if "DetectorElementSpacing" in seq:
                inplane_spacing = seq.DetectorElementSpacing
        elif "PerFrameFunctionalGroupsSequence" in ds:
            seq = ds.PerFrameFunctionalGroupsSequence[0]
            if "PixelMeasuresSequence" in seq:
                inplane_spacing = seq.PixelMeasuresSequence[0].PixelSpacing

        if len(self.image_set) > 1:
            slice_direction = np.cross(self.orientation[:3],
                                       self.orientation[3:])
            first = np.dot(slice_direction,
                           self.image_set[0].ImagePositionPatient)
            last = np.dot(slice_direction,
                          self.image_set[-1].ImagePositionPatient)
            slice_thickness = np.asarray(
                (last - first) / (len(self.image_set) - 1))

        if self.plane_of(self.orientation) == "Axial":
            return np.asarray([inplane_spacing[1], inplane_spacing[0],
                               slice_thickness])
        if self.plane_of(self.orientation) == "Coronal":
            return np.asarray([inplane_spacing[1], slice_thickness,
                               inplane_spacing[0]])
        return np.asarray([slice_thickness, inplane_spacing[1],
                           inplane_spacing[0]])

    @staticmethod
    def plane_of(orientation):
        return geo.plane_from_orientation(orientation)

    def _shape_zyx(self):
        ds = self.image_set[0]
        if len(self.image_set) > 1:
            frames = len(self.image_set)
        else:
            frames = int(ds.get("NumberOfFrames", 1) or 1)
        rows = int(ds.Rows) if "Rows" in ds else 0
        cols = int(ds.Columns) if "Columns" in ds else 0
        return (frames, rows, cols)

    def _compute_dimensions(self):
        shape = self._shape_zyx()
        if self.plane == "Axial":
            return np.array([shape[0], shape[1], shape[2]])
        if self.plane == "Coronal":
            return np.array([shape[1], shape[0], shape[2]])
        return np.array([shape[1], shape[2], shape[0]])

    def _assemble_and_verify(self):
        """DoseGridScaling + FFS move on device
        (reference read/dicom.py:1902-1917, 2000-2110)."""
        ds = self.image_set[0]
        ipp = np.asarray(ds["ImagePositionPatient"].value,
                         dtype=np.float64) \
            if "ImagePositionPatient" in ds else np.zeros(3)
        shape_zyx = self._shape_zyx()

        # descending GridFrameOffsetVector: frame k sits at
        # IPP + offset_k * normal (PS3.3 C.8.8.3.2), i.e. frames stack
        # AGAINST cross(row, col). Normalize by flipping the frame
        # order and moving the base position to the last frame so the
        # shared ffs/orientation machinery sees an ascending stack.
        flip_frames = False
        if len(self.image_set) == 1 and "GridFrameOffsetVector" in ds:
            gfov = np.asarray(ds.GridFrameOffsetVector, np.float64)
            if gfov.size > 1 and gfov[1] < gfov[0]:
                normal = np.cross(self.orientation[:3],
                                  self.orientation[3:6])
                ipp = ipp + gfov[-1] * normal
                flip_frames = True

        decision = geo.ffs_decision(shape_zyx, self.plane, self.spacing,
                                    self.orientation, ipp, self.dimensions)
        self.origin = np.asarray(decision["origin"], dtype=np.float64)
        self.orientation = decision["orientation"]

        if self.only_tags:
            return

        slope = ds.DoseGridScaling if (0x3004, 0x000E) in ds else 1
        raw = ds.pixel_array
        if raw.ndim == 2:
            raw = raw.reshape((1,) + raw.shape)
        if len(self.image_set) > 1:
            raw = np.stack([img.pixel_array for img in self.image_set])
        if flip_frames:
            raw = raw[::-1]
        n = raw.shape[0]
        self.array = assemble_volume(
            raw, np.full(n, slope, np.float32), np.zeros(n, np.float32),
            ffs_op=decision["op"], out_dtype=np.float32,
            device=self.device).cpu().numpy()
        for img in self.image_set:
            if "PixelData" in img:
                del img.PixelData
