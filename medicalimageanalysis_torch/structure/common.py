"""Metadata and geometry mixins shared by Image and Dose.

Carried over from medicalimageanalysis_tpu/structure/common.py
(``MetadataMixin``, ``GeometryQueriesMixin``). The view operations
(``ViewOpsMixin``: rotation, the ``retrieve_*`` queries) wait for the
Display view slice (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

import numpy as np

from ..ops import geometry as geo

__all__ = ["GeometryQueriesMixin", "MetadataMixin", "waits"]


def waits(owner, name, item):
    """A method of the JAX package's ``owner`` class that a later slice
    ports: calling it raises NotImplementedError naming its ROADMAP.md
    item."""
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"{owner}.{name} is not ported yet (ROADMAP.md queue 1, {item})")

    method.__name__ = name
    return method


class MetadataMixin:
    """Identity-metadata fallback chains
    (reference structure/image.py:505-706)."""

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

    def get_specific_tag(self, tag):
        if tag in self.tags[0]:
            return self.tags[0][tag]
        return None

    def get_specific_tag_on_all_files(self, tag):
        if tag in self.tags[0]:
            return [t[tag] for t in self.tags]
        return None


class GeometryQueriesMixin:
    """Aspect/bounds/center/corner/pixel/position queries
    (reference structure/image.py:996-1181)."""

    def compute_aspect(self, slice_plane):
        if slice_plane == "Axial":
            return np.round(self.spacing[0] / self.spacing[1], 2)
        if slice_plane == "Coronal":
            return np.round(self.spacing[0] / self.spacing[2], 2)
        return np.round(self.spacing[1] / self.spacing[2], 2)

    def _vtk_style_bounds(self):
        """AABB with the reference's VTK configuration (dimensions
        [shape[1], shape[2], shape[0]], direction rows applied as a
        matrix)."""
        shape = self.array.shape
        dims = np.array([shape[1], shape[2], shape[0]])
        M = np.asarray(self.matrix, dtype=np.float64)
        spacing = np.asarray(self.spacing, dtype=np.float64)
        pts = []
        for k in (0, dims[2] - 1):
            for j in (0, dims[1] - 1):
                for i in (0, dims[0] - 1):
                    v = np.array([i * spacing[0], j * spacing[1],
                                  k * spacing[2]])
                    pts.append(M @ v + np.asarray(self.origin))
        pts = np.asarray(pts)
        return pts.min(axis=0), pts.max(axis=0)

    def compute_bounds(self):
        lo, hi = self._vtk_style_bounds()
        return [lo[0], hi[0], lo[1], hi[1], lo[2], hi[2]]

    def compute_center(self, position=True, zyx=False):
        pixel_index = [int(self.dimensions[2] / 2),
                       int(self.dimensions[1] / 2),
                       int(self.dimensions[0] / 2)]
        if position:
            m = self.display.compute_matrix_pixel_to_position()
            center = geo.apply_homogeneous(pixel_index, m)
            return np.flip(center) if zyx else center
        if zyx:
            return [pixel_index[2], pixel_index[1], pixel_index[0]]
        return pixel_index

    def compute_corner_positions(self):
        lo, hi = self._vtk_style_bounds()
        x_min, y_min, z_min = lo
        x_max, y_max, z_max = hi
        return [(x_min, y_min, z_min), (x_max, y_min, z_min),
                (x_max, y_max, z_min), (x_min, y_max, z_min),
                (x_min, y_min, z_max), (x_max, y_min, z_max),
                (x_max, y_max, z_max), (x_min, y_max, z_max)]

    def compute_pixel(self, position):
        m = self.display.compute_matrix_position_to_pixel()
        return np.round(geo.apply_homogeneous(position, m)).astype(np.int32)

    def compute_position(self, xyz):
        m = self.display.compute_matrix_pixel_to_position()
        return geo.apply_homogeneous(xyz, m)
