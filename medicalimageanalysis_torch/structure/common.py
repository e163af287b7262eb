"""Metadata, geometry and view mixins shared by Image and Dose.

Carried over from medicalimageanalysis_tpu/structure/common.py
(``MetadataMixin``, ``GeometryQueriesMixin``, ``ViewOpsMixin``). The view
operations reslice on the device: ``update_rotation`` and
``retrieve_vtk_volume`` through ops/resample.reslice_rotation (the warp
kernel's ``affine`` mode on the card). Also the helpers of the load and
REG-writer paths: ``rebuild_dataset_from_meta``, ``collision_suffix``,
``build_reg_dataset`` with ``series_item``, ``host_array``, the one
download a writer makes, and ``mesh_cut_pixels``, the Displays' mesh cuts
as in-plane pixel paths.
"""

from __future__ import annotations

import copy

import numpy as np
from scipy.spatial.transform import Rotation

from ..ops import geometry as geo

__all__ = ["GeometryQueriesMixin", "MetadataMixin", "ViewOpsMixin",
           "build_reg_dataset", "collision_suffix", "host_array",
           "mesh_cut_pixels", "rebuild_dataset_from_meta", "series_item"]


def host_array(a, dtype=None):
    """What a writer writes, on the host: a tensor (on the card or not)
    is downloaded once, in one copy; an array is taken as it is. With
    ``dtype`` the result is cast after the copy."""
    import torch

    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return a if dtype is None else a.astype(dtype, copy=False)


def mesh_cut_pixels(display, loops, slice_plane):
    """A Display's mesh-cut loops (mm) as the in-plane pixel paths of
    ``slice_plane`` on the display's grid ([] without loops), as the
    Rigid and Deformable Displays' ``compute_mesh_slice`` return them."""
    if not loops:
        return []
    cols = {"Axial": [0, 1], "Coronal": [0, 2]}.get(slice_plane, [1, 2])
    return [pixel[:, cols]
            for pixel in display.convert_position_to_pixel(position=loops)]


def rebuild_dataset_from_meta(meta, filename, default_modality):
    """The minimal carrier Dataset a ``load_*`` path hands its structure
    class, so the MetadataMixin chains re-derive what ``save_*`` wrote
    (JAX structure/common.py:24-53)."""
    from ..dicom import Dataset

    ds = Dataset()
    ds.Modality = meta.get("modality", default_modality)
    if meta.get("mrn") not in (None, "missing"):
        ds.PatientID = meta["mrn"]
    pn = meta.get("patient_name")
    if isinstance(pn, list):
        ds.PatientName = "^".join(str(v) for v in pn)
    if meta.get("series_uid") not in (None, "00000.00000"):
        ds.SeriesInstanceUID = meta["series_uid"]
    if meta.get("frame_ref") not in (None, "", "00000.00000"):
        ds.FrameOfReferenceUID = meta["frame_ref"]
    # json stringifies; the getters' sentinels mean "never known"
    if meta.get("date") not in (None, "00000", "None"):
        ds.SeriesDate = str(meta["date"])
    if meta.get("time") not in (None, "00000", "None"):
        ds.SeriesTime = str(meta["time"])
    if meta.get("birthdate") not in (None, "", "None"):
        ds.PatientBirthDate = str(meta["birthdate"])
    ds.filename = filename
    return ds


def collision_suffix(name, taken):
    """``name`` -> ``name_N`` with the first free N when ``name`` is
    already registered (the loaders' convention)."""
    if name in taken:
        n = 1
        while f"{name}_{n}" in taken:
            n += 1
        name = f"{name}_{n}"
    return name


def series_item(img):
    """A ReferencedSeriesSequence item naming ``img``'s series and every
    SOP instance of it. Raises when the image has no SOP UIDs: a REG
    reader matches registrations to images by sops[0]."""
    from ..dicom import Dataset, Sequence, uids

    if not img.sops:
        raise ValueError(
            "create_reg: image has no SOP instance UIDs to "
            "reference — the REG object could not be matched "
            "back to its images on re-ingest")
    item = Dataset()
    item.SeriesInstanceUID = img.series_uid
    refs = Sequence()
    sop_class = uids.MODALITY_SOP_CLASS.get(img.modality,
                                            uids.CTImageStorage)
    for sop in img.sops:
        r = Dataset()
        r.ReferencedSOPClassUID = sop_class
        r.ReferencedSOPInstanceUID = sop
        refs.append(r)
    item.ReferencedInstanceSequence = refs
    return item


def build_reg_dataset(sop_class_uid, ref, mov, description):
    """The REG writers' shared header (JAX structure/common.py:67-111):
    identity and the two ReferencedSeriesSequence items, reference first
    and moving second, the order ReadREG reads."""
    from ..dicom import Dataset, Sequence, generate_uid

    ds = Dataset()
    ds.SOPClassUID = sop_class_uid
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = "REG"
    ds.PatientID = ref.mrn if ref.mrn != "missing" else ""
    ds.SeriesInstanceUID = generate_uid()
    ds.StudyInstanceUID = ref.get_study_uid()
    ds.FrameOfReferenceUID = ref.frame_ref
    ds.ContentLabel = "REGISTRATION"
    ds.ContentDescription = description or ""
    ds.ReferencedSeriesSequence = Sequence(
        [series_item(ref), series_item(mov)])
    return ds


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

    def compute_corner_sides(self):
        """The grid's axis-aligned bounding box as a TriMesh."""
        from ..utils.mesh.trimesh import box_mesh
        lo, hi = self._vtk_style_bounds()
        return box_mesh(lo, hi)

    def compute_pixel(self, position):
        m = self.display.compute_matrix_position_to_pixel()
        return np.round(geo.apply_homogeneous(position, m)).astype(np.int32)

    def compute_position(self, xyz):
        m = self.display.compute_matrix_pixel_to_position()
        return geo.apply_homogeneous(xyz, m)


class ViewOpsMixin:
    """Display-state view operations
    (reference structure/image.py:1223-1412)."""

    def reset_array(self):
        self.display.secondary_array = None
        self.display.matrix = copy.deepcopy(self.matrix)
        self.display.origin = copy.deepcopy(self.origin)
        self.display.slice_location = self.compute_center(position=False,
                                                          zyx=True)

    def retrieve_angles(self, order="ZXY"):
        rotation = Rotation.from_matrix(self.display.matrix[:3, :3])
        return rotation.as_euler(order, degrees=True)

    def retrieve_array_plane(self, slice_plane):
        return self.display.compute_array(slice_plane=slice_plane)

    def retrieve_slice_location(self, slice_plane):
        if slice_plane == "Axial":
            return self.display.slice_location[0]
        if slice_plane == "Coronal":
            return self.display.slice_location[1]
        return self.display.slice_location[2]

    def retrieve_slice_position(self, slice_plane=None):
        m = self.display.compute_matrix_pixel_to_position()
        if slice_plane is None:
            location = [self.display.slice_location[2],
                        self.display.slice_location[1],
                        self.display.slice_location[0]]
        elif slice_plane == "Axial":
            location = [0, 0, self.display.slice_location[0]]
        elif slice_plane == "Coronal":
            location = [0, self.display.slice_location[1], 0]
        else:
            location = [self.display.slice_location[2], 0, 0]
        return geo.apply_homogeneous(location, m)

    def retrieve_scroll_max(self, slice_plane):
        if slice_plane == "Axial":
            return self.display.scroll_max[0]
        if slice_plane == "Coronal":
            return self.display.scroll_max[1]
        return self.display.scroll_max[2]

    def retrieve_slice(self, slice_plane):
        return self.display.compute_slice(slice_plane)

    retrieve_vtk_slice = retrieve_slice

    def retrieve_vtk_volume(self, slice_plane=None):
        """Volume bundle in the CURRENT display frame: the base grid
        bundle with an identity display rotation, otherwise the volume
        resliced through the full display matrix (as
        ``Display.compute_offaxis_array`` reslices) into an
        identity-direction grid."""
        disp = np.asarray(self.display.matrix, dtype=np.float64)
        base = np.asarray(self.matrix, dtype=np.float64)
        if np.allclose(disp, base):
            return self.create_volume()
        from ..ops.resample import reslice_rotation
        arr, new_origin = reslice_rotation(
            np.asarray(self.array), base, np.asarray(self.spacing),
            np.asarray(self.origin), disp)
        return {"array": arr,
                "origin": np.asarray(new_origin, dtype=float),
                "spacing": np.asarray(self.spacing, dtype=float),
                "direction": np.eye(3)}

    def update_rotation(self, r_x=0, r_y=0, r_z=0, base=True):
        if r_x != 0 or r_y != 0 or r_z != 0:
            r = Rotation.from_euler("xyz", [r_x, r_y, r_z], degrees=True)
            new_matrix = r.as_matrix()
            if base:
                self.display.matrix = new_matrix @ copy.deepcopy(self.matrix)
            else:
                self.display.matrix = new_matrix @ self.display.matrix
            self.display.compute_offaxis_array()
            self.display.compute_scroll_max()
        else:
            self.display.compute_scroll_max()
            self.reset_array()
