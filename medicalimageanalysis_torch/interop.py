"""State carried across packages: images, ROIs, doses and registrations.

The system has no learned weights; its state is the registry — image
arrays with their geometry, ROI contours, dose grids, registration
matrices and deformation fields. These helpers
build port objects from plain numpy values, so the JAX package and the
port can compute on identical state. Nothing here imports the JAX package.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from .data import Data

__all__ = ["deformable_from_numpy", "dose_from_numpy", "image_from_arrays",
           "import_image", "meshes_from_numpy", "pois_from_numpy",
           "rigid_from_matrix", "rois_from_numpy"]


def image_from_arrays(array, spacing, origin, matrix, modality, name,
                      tags=None):
    """Build and register a port ``Image`` from numpy values.

    array (Z, Y, X); spacing [sx, sy, sz] mm; origin (3,) mm; matrix 3x3
    with rows the +x/+y/+z pixel directions; ``tags`` an optional list of
    per-slice datasets (metadata falls back to the getters' sentinels)."""
    from .dicom import Dataset

    from .structure.image import Image

    array = np.asarray(array)
    matrix = np.asarray(matrix, dtype=np.float64)
    builder = SimpleNamespace(
        image_set=list(tags) if tags else [Dataset()],
        array=array, image_name=name, modality=modality,
        filepaths=None, sops=[], plane="Axial",
        spacing=np.asarray(spacing, dtype=np.float64),
        dimensions=np.asarray(array.shape),
        orientation=np.concatenate([matrix[0], matrix[1]]),
        origin=np.asarray(origin, dtype=np.float64), image_matrix=matrix,
        unverified=None, skipped_slice=[], rgb=False)
    image = Image(builder)
    if name not in Data.image:
        Data.image_list.append(name)
    Data.image[name] = image
    return image


def import_image(obj):
    """Register a port copy of any object with .array/.spacing/.origin/
    .matrix/.modality/.image_name (a JAX-package Image, for one), by
    duck typing."""
    image = image_from_arrays(np.asarray(obj.array), obj.spacing, obj.origin,
                              obj.matrix, obj.modality, obj.image_name,
                              tags=getattr(obj, "tags", None))
    for key in ("plane", "dimensions", "orientation"):
        if hasattr(obj, key):
            setattr(image, key, getattr(obj, key))
    return image


def rigid_from_matrix(ref_name, mov_name, matrix, device=None):
    """Register a port ``Rigid`` holding a known reference -> moving 4x4."""
    from .structure.rigid import Rigid

    return Rigid(ref_name, mov_name,
                 matrix=np.asarray(matrix, dtype=np.float64), device=device)


def deformable_from_numpy(dvf, origin, spacing, reference_name, moving_name,
                          rigid_matrix=None, name=None, device=None):
    """Register a port ``Deformable`` holding a known field: ``dvf``
    (Z, Y, X, 3) mm point displacements on the axis-aligned grid at
    ``origin`` with ``spacing`` [sx, sy, sz] (a JAX-package Deformable's
    ``dvf``, ``origin``, ``spacing``, ``rigid_matrix`` and names)."""
    from .structure.deformable import Deformable

    dvf = np.asarray(dvf, dtype=np.float32)
    return Deformable(
        dvf=dvf, origin=np.asarray(origin, dtype=np.float64),
        spacing=tuple(float(v) for v in spacing),
        dimensions=np.asarray(dvf.shape[:3]),
        rigid_matrix=(None if rigid_matrix is None
                      else np.asarray(rigid_matrix, dtype=np.float64)),
        registration_name=name, reference_name=reference_name,
        moving_name=moving_name, device=device)


def rois_from_numpy(image, contours, plane="Axial"):
    """Add ROIs to a port ``Image`` (or the name of one) from physical
    contours: ``contours`` maps a name to a list of (N, 3) mm arrays (a
    JAX-package Roi's ``contour_position``). Returns the image's ROIs."""
    from .structure.roi import Roi

    image = Data.image[image] if isinstance(image, str) else image
    for name, position in contours.items():
        image.rois[name] = Roi(
            image, position=[np.asarray(p, dtype=np.float64)
                             for p in position],
            name=name, plane=plane)
    Data.match_rois()
    return image.rois


def dose_from_numpy(array, spacing, origin, matrix, name="RTDOSE 01",
                    tags=None):
    """Build and register a port ``Dose`` from numpy values (a
    JAX-package Dose's ``array``, ``spacing``, ``origin``, ``matrix``,
    ``dose_name`` and ``tags``; the tags carry FrameOfReferenceUID).

    array (Z, Y, X) Gy; spacing [sx, sy, sz] mm; origin (3,) mm; matrix
    3x3 with rows the +x/+y/+z pixel directions."""
    from .dicom import Dataset
    from .structure.dose import Dose

    array = np.array(array, dtype=np.float32)        # a writable copy
    matrix = np.asarray(matrix, dtype=np.float64)
    builder = SimpleNamespace(
        image_set=list(tags) if tags else [Dataset()], array=array,
        dose_name=name, modality="RTDOSE", filepaths=None, sops=[],
        plane="Axial", spacing=np.asarray(spacing, dtype=np.float64),
        dimensions=np.asarray(array.shape),
        orientation=np.concatenate([matrix[0], matrix[1]]),
        origin=np.asarray(origin, dtype=np.float64), image_matrix=matrix)
    dose = Dose(builder)
    if name not in Data.dose:
        Data.dose_list.append(name)
    Data.dose[name] = dose
    return dose


def pois_from_numpy(image, points):
    """Add POIs to a port ``Image``: ``points`` maps name -> (3,) mm
    position (the landmarks of ``compute_landmarks`` and
    ``compute_tps``)."""
    for name, p in points.items():
        image.add_poi(poi_name=name,
                      point=[float(v) for v in np.asarray(p, np.float64)])
    return image


def meshes_from_numpy(image, meshes, visible=True):
    """Add mesh ROIs to a port ``Image``: ``meshes`` maps name -> (points
    (N, 3) mm, faces (M, 3) int); an existing ROI of that name keeps its
    contours and takes the mesh."""
    from .utils.mesh.trimesh import TriMesh

    for name, (points, faces) in meshes.items():
        if name not in image.rois:
            image.create_roi(name=name, visible=visible)
        image.rois[name].update_mesh(TriMesh(
            np.asarray(points, np.float64), np.asarray(faces, np.int32)))
    return image
