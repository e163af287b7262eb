"""Image domain object.

Carried over from medicalimageanalysis_tpu/structure/image.py (``Image``,
:150-195) with the ``MetadataMixin`` / ``GeometryQueriesMixin`` parts of
medicalimageanalysis_tpu/structure/common.py that the main path uses. The
array stays a numpy array, like the JAX package's. ROIs, POIs, the
Display view state and the exports wait for the structure slice.
"""

from __future__ import annotations

import numpy as np

from medicalimageanalysis_tpu.dicom import generate_uid

from ..ops import geometry as geo

__all__ = ["Image"]


class MetadataMixin:
    """Identity-metadata fallback chains."""

    def get_patient_name(self):
        if "PatientName" in self.tags[0]:
            return str(self.tags[0].PatientName).split("^")[:3]
        return "missing"

    def get_mrn(self):
        if "PatientID" in self.tags[0]:
            return str(self.tags[0].PatientID)
        return "missing"

    def get_birthdate(self):
        if "PatientBirthDate" in self.tags[0]:
            return str(self.tags[0].PatientBirthDate)
        return ""

    def get_date(self):
        for key in ("SeriesDate", "ContentDate", "AcquisitionDate",
                    "StudyDate"):
            if key in self.tags[0]:
                return self.tags[0].get(key)
        return "00000"

    def get_time(self):
        for key in ("SeriesTime", "ContentTime", "AcquisitionTime",
                    "StudyTime"):
            if key in self.tags[0]:
                return self.tags[0].get(key)
        return "00000"

    def get_study_uid(self):
        if "StudyInstanceUID" in self.tags[0]:
            return self.tags[0].StudyInstanceUID
        return "00000.00000"

    def get_series_uid(self):
        if "SeriesInstanceUID" in self.tags[0]:
            return self.tags[0].SeriesInstanceUID
        return "00000.00000"

    def get_acq_number(self):
        if "AcquisitionNumber" in self.tags[0]:
            return self.tags[0].AcquisitionNumber
        return "1"

    def get_frame_ref(self):
        if "FrameOfReferenceUID" in self.tags[0]:
            return self.tags[0].FrameOfReferenceUID
        return "00000.00000"

    def get_window(self):
        if (0x0028, 0x1050) in self.tags[0] \
                and (0x0028, 0x1051) in self.tags[0]:
            center = self.tags[0].WindowCenter
            width = self.tags[0].WindowWidth
            if not isinstance(center, float):
                center = center[0]
            if not isinstance(width, float):
                width = width[0]
            return [int(center) - int(np.round(width / 2)),
                    int(center) + int(np.round(width / 2))]
        if self.array is not None:
            return [np.min(self.array), np.max(self.array)]
        return [0, 1]


class GeometryQueriesMixin:
    """Center and position queries on the image's own grid."""

    def compute_matrix_pixel_to_position(self):
        return geo.pixel_to_position_matrix(self.matrix, self.spacing,
                                            self.origin)

    def compute_center(self, position=True, zyx=False):
        pixel_index = [int(self.dimensions[2] / 2),
                       int(self.dimensions[1] / 2),
                       int(self.dimensions[0] / 2)]
        if position:
            m = self.compute_matrix_pixel_to_position()
            center = geo.apply_homogeneous(pixel_index, m)
            return np.flip(center) if zyx else center
        if zyx:
            return [pixel_index[2], pixel_index[1], pixel_index[0]]
        return pixel_index

    def compute_position(self, xyz):
        m = self.compute_matrix_pixel_to_position()
        return geo.apply_homogeneous(xyz, m)


class Image(MetadataMixin, GeometryQueriesMixin):
    """Volume + identity metadata + geometry.

    ``image`` is a builder (read/volume3d.Read3D, or the namespace
    interop.image_from_arrays makes) carrying image_set, array,
    image_name, modality, filepaths, sops, plane, spacing, dimensions,
    orientation, origin, image_matrix, unverified, skipped_slice, rgb.
    """

    def __init__(self, image):
        self.rois = {}
        self.pois = {}

        self.tags = image.image_set
        self.array = image.array

        self.image_name = image.image_name
        self.modality = image.modality

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

        self.filepaths = image.filepaths
        self.sops = image.sops

        self.plane = image.plane
        self.spacing = image.spacing
        self.dimensions = image.dimensions
        self.orientation = image.orientation
        self.origin = image.origin
        self.matrix = image.image_matrix

        self.unverified = image.unverified
        self.skipped_slice = image.skipped_slice
        self.rgb = image.rgb

        self.visual = {"colormap": "gray", "bounds": None}
        self.misc = {}
