"""Canonical geometry core.

Carried over from medicalimageanalysis_tpu/ops/geometry.py (numpy host
code; importing the original pulls in jax through its ``ops`` package).
This module is the single canonical implementation of the 4x4
pixel<->position transforms; host decisions use numpy, device-side moves
live in ops/volume.py.

Conventions (identical to the reference):
- volume arrays are indexed ``(z, y, x)`` = (slice, row, col)
- pixel coordinate vectors are ``(x, y, z)`` = (col, row, slice)
- ``spacing`` is ``[sx, sy, sz]`` in mm
- ``matrix`` is 3x3 with rows = unit direction vectors of the +x, +y, +z
  pixel axes in patient space (reference read/dicom.py:640-653)
- ``origin`` is the patient-space position of pixel (0, 0, 0)
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "pixel_to_position_matrix",
    "position_to_pixel_matrix",
    "apply_homogeneous",
    "plane_from_orientation",
    "orientation_to_matrix",
    "compute_volume_corners",
    "ffs_decision",
    "apply_ffs_numpy",
]


def pixel_to_position_matrix(matrix, spacing, origin):
    """4x4 homogeneous transform pixel (x,y,z) -> patient position.

    Mirrors reference structure/image.py:62-78 exactly: column i of the
    rotation block is ``matrix[i, :] * spacing[i]``.
    """
    matrix = np.asarray(matrix, dtype=np.float64)
    spacing = np.asarray(spacing, dtype=np.float64)
    m = np.identity(4, dtype=np.float64)
    m[:3, 0] = matrix[0, :] * spacing[0]
    m[:3, 1] = matrix[1, :] * spacing[1]
    m[:3, 2] = matrix[2, :] * spacing[2]
    m[:3, 3] = np.asarray(origin, dtype=np.float64)
    # float64 (the reference uses float32, structure/image.py:66): pixel-
    # aligned physical contours must survive the mm->pixel->truncate trip
    return m


def position_to_pixel_matrix(matrix, spacing, origin):
    """Inverse of :func:`pixel_to_position_matrix`.

    Mirrors reference structure/image.py:88-108 (row-scaled orientation,
    translated origin).
    """
    matrix = np.asarray(matrix, dtype=np.float64)
    spacing = np.asarray(spacing, dtype=np.float64)
    hold = np.identity(3, dtype=np.float64)
    hold[0, :] = matrix[0, :] / spacing[0]
    hold[1, :] = matrix[1, :] / spacing[1]
    hold[2, :] = matrix[2, :] / spacing[2]
    m = np.identity(4, dtype=np.float64)
    m[:3, :3] = hold
    m[:3, 3] = np.asarray(origin, dtype=np.float64).dot(-hold.T)
    return m


def apply_homogeneous(points, matrix4):
    """Apply a 4x4 homogeneous transform to (N, 3) points (row-vector form,
    like the reference's ``location.dot(m.T)[:3]``)."""
    pts = np.asarray(points, dtype=np.float64)
    single = pts.ndim == 1
    pts = np.atleast_2d(pts)
    ones = np.ones((pts.shape[0], 1))
    out = np.hstack([pts, ones]).dot(np.asarray(matrix4, dtype=np.float64).T)[:, :3]
    return out[0] if single else out


def plane_from_orientation(orientation):
    """Anatomical plane from the 6-vector IOP (reference read/dicom.py:560-573).

    The component sums decide which patient axis varies least in-plane.
    """
    o = np.asarray(orientation, dtype=np.float64)
    x = np.abs(o[0]) + np.abs(o[3])
    y = np.abs(o[1]) + np.abs(o[4])
    z = np.abs(o[2]) + np.abs(o[5])
    if x < y and x < z:
        return "Sagittal"
    if y < x and y < z:
        return "Coronal"
    return "Axial"


def grid_plane_tags(matrix, spacing):
    """DICOM plane attributes for a canonical (z, y, x) grid — the
    single home of the writer-side convention (create_seg,
    create_rtdose, export_dicom): ImageOrientationPatient is the
    pixel-axis matrix rows 0/1 (the directions the stored array
    actually follows), PixelSpacing is [row = sy, col = sx]."""
    m = np.asarray(matrix, dtype=np.float64)
    iop = [float(v) for v in np.concatenate([m[0], m[1]])]
    return iop, [float(spacing[1]), float(spacing[0])]


def orientation_to_matrix(orientation):
    """3x3 image matrix rows [row, col, row x col] (reference read/dicom.py:640-653)."""
    o = np.asarray(orientation, dtype=np.float64)
    row = o[:3]
    col = o[3:]
    slc = np.cross(row, col)
    mat = np.eye(3, dtype=np.float64)
    mat[0] = row
    mat[1] = col
    mat[2] = slc
    return mat


def compute_volume_corners(shape_zyx, plane, spacing_xyz, orientation, origin):
    """The 8 physical corners of a slice-stacked volume.

    Mirrors reference read/dicom.py:662-690 including the per-plane spacing
    permutation applied before corner construction.
    """
    spacing_xyz = np.asarray(spacing_xyz, dtype=np.float64)
    if plane == "Axial":
        spacing = spacing_xyz
    elif plane == "Coronal":
        spacing = np.asarray([spacing_xyz[0], spacing_xyz[2], spacing_xyz[1]])
    else:
        spacing = np.asarray([spacing_xyz[1], spacing_xyz[2], spacing_xyz[0]])

    slices = shape_zyx[0] - 1
    y = shape_zyx[1] - 1
    x = shape_zyx[2] - 1

    origin = np.asarray(origin, dtype=np.float64)
    o = np.asarray(orientation, dtype=np.float64)
    row_dir = o[:3]
    col_dir = o[3:]
    slice_dir = np.cross(row_dir, col_dir)

    corners = np.zeros((8, 3))
    corners[0] = origin
    corners[1] = origin + x * spacing[0] * row_dir
    corners[2] = origin + y * spacing[1] * col_dir
    corners[3] = origin + x * spacing[0] * row_dir + y * spacing[1] * col_dir
    corners[4] = origin + slices * spacing[2] * slice_dir
    corners[5] = corners[4] + x * spacing[0] * row_dir
    corners[6] = corners[4] + y * spacing[1] * col_dir
    corners[7] = corners[4] + x * spacing[0] * row_dir + y * spacing[1] * col_dir
    return corners


def ffs_decision(shape_zyx, plane, spacing_xyz, orientation, origin, dimensions):
    """Feet-First-Supine normalization decision (reference read/dicom.py:655-740).

    Pure metadata computation: decides *which* array move canonicalizes the
    volume and rewrites orientation/origin accordingly. The actual array move
    is applied separately (on device) via :func:`apply_ffs_numpy`'s op code.

    Returns
    -------
    dict with keys:
        ``op``: str op-code in {"none", "ax_rot1", "ax_rot2", "ax_rot3",
                "cor_rot1", "sag_fix"}
        ``origin``: new origin (np.ndarray shape (3,))
        ``orientation``: possibly rewritten 6-vector
    """
    orientation = np.array(orientation, dtype=np.float64).copy()
    corners = compute_volume_corners(shape_zyx, plane, spacing_xyz, orientation, origin)
    corner_idx = int(np.argmin(np.sum(corners, axis=1)))

    if corner_idx == 0:
        return {"op": "none", "origin": np.asarray(origin, dtype=np.float64),
                "orientation": orientation, "corner_idx": 0}

    new_origin = corners[corner_idx]
    if plane == "Axial":
        if corner_idx == 1:
            op = "ax_rot1"
        elif corner_idx == 2:
            op = "ax_rot3"
        else:
            op = "ax_rot2"
        if corner_idx < 4:
            square = corners[:4, :]
        else:
            square = corners[4:, :]
    elif plane == "Coronal":
        op = "cor_rot1"
        s1 = np.argsort(corners[:4, 2])
        s2 = np.argsort(corners[4:, 2]) + 4
        square = [corners[s1[0]], corners[s1[1]], corners[s2[0]], corners[s2[1]]]
    else:
        op = "sag_fix"
        s1 = np.argsort(corners[:4, 2])
        s2 = np.argsort(corners[4:, 2]) + 4
        square = [corners[s1[0]], corners[s1[1]], corners[s2[0]], corners[s2[1]]]

    distances = np.asarray([np.linalg.norm(corners[corner_idx, :] - s) for s in square])
    sorted_args = np.argsort(distances)
    c1 = np.asarray(square[sorted_args[1]]) - corners[corner_idx]
    c2 = np.asarray(square[sorted_args[2]]) - corners[corner_idx]

    # REFERENCE BUG FIXED (read/dicom.py:732-737, listed in PARITY.md):
    # the reference divides the corner deltas by spacing*dimensions,
    # but a delta spans (dim-1)*spacing — and pairs the wrong axes —
    # leaving NON-UNIT direction cosines (e.g. 23/24-scaled) on every
    # FFS-rewritten series, which silently scales all downstream
    # pixel<->position geometry. Direction vectors are unit by
    # definition: normalize the deltas instead.
    if np.abs(c1[0]) > np.abs(c2[0]):
        orientation[:3] = c1 / max(np.linalg.norm(c1), 1e-12)
        orientation[3:] = c2 / max(np.linalg.norm(c2), 1e-12)
    else:
        orientation[:3] = c2 / max(np.linalg.norm(c2), 1e-12)
        orientation[3:] = c1 / max(np.linalg.norm(c1), 1e-12)

    return {"op": op, "origin": new_origin, "orientation": orientation,
            "corner_idx": corner_idx}


def apply_ffs_numpy(array, op):
    """Apply an FFS op-code to a (Z, Y, X) numpy array.

    The same op-codes are applied on device by
    :func:`medicalimageanalysis_torch.ops.volume.apply_ffs`.
    """
    if op == "none":
        return array
    if op == "ax_rot1":
        return np.rot90(array, 1, (1, 2))
    if op == "ax_rot3":
        return np.rot90(array, 3, (1, 2))
    if op == "ax_rot2":
        return np.rot90(array, 2, (1, 2))
    if op == "cor_rot1":
        return np.rot90(array, 1, (0, 1))
    if op == "sag_fix":
        return np.flip(np.rot90(array, 1, (0, 1)).transpose(0, 2, 1), axis=2)
    raise ValueError(f"unknown ffs op {op!r}")
