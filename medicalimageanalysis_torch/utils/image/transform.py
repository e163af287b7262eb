"""Euler 3D rigid transform (reference utils/image/transform.py:15-38).

Carried over from medicalimageanalysis_tpu/utils/image/transform.py
(host numpy, no device code). Own replacement for sitk.Euler3DTransform:
rotation (ITK order Rz@Rx@Ry, or Rz@Ry@Rx with zyx=True), rotation
center, translation.
Transform: p' = R (p - center) + center + translation.
"""

from __future__ import annotations

import numpy as np

__all__ = ["EulerTransform", "euler_transform"]


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


class EulerTransform:
    def __init__(self, matrix=None, center=None, translation=None):
        self.matrix = np.eye(3) if matrix is None else np.asarray(
            matrix, dtype=np.float64)
        self.center = np.zeros(3) if center is None else np.asarray(
            center, dtype=np.float64)
        self.translation = np.zeros(3) if translation is None \
            else np.asarray(translation, dtype=np.float64)

    def as_matrix4(self):
        """4x4 homogeneous: p' = R (p - c) + c + t."""
        m = np.eye(4)
        m[:3, :3] = self.matrix
        m[:3, 3] = (self.center + self.translation
                    - self.matrix @ self.center)
        return m

    def inverse(self):
        inv = EulerTransform(matrix=self.matrix.T)
        m = np.linalg.inv(self.as_matrix4())
        inv.matrix = m[:3, :3]
        inv.center = np.zeros(3)
        inv.translation = m[:3, 3]
        return inv

    def transform_points(self, points):
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        out = (pts - self.center) @ self.matrix.T + self.center \
            + self.translation
        return out[0] if np.asarray(points).ndim == 1 else out

    # sitk-style accessors kept for drop-in familiarity
    def GetMatrix(self):
        return tuple(self.matrix.flatten())

    def GetCenter(self):
        return tuple(self.center)

    def GetTranslation(self):
        return tuple(self.translation)


def euler_transform(matrix=None, angles=None, translation=None,
                    rotation_center=None, zyx=False):
    """Build an EulerTransform from degrees/matrix/translation/center.

    ITK Euler3DTransform composes Rz@Rx@Ry by default and Rz@Ry@Rx with
    ComputeZYX — both orders supported via `zyx`.
    """
    t = EulerTransform()
    if angles is not None:
        a = [np.deg2rad(v) for v in angles]
        if zyx:
            t.matrix = _rot_z(a[2]) @ _rot_y(a[1]) @ _rot_x(a[0])
        else:
            t.matrix = _rot_z(a[2]) @ _rot_x(a[0]) @ _rot_y(a[1])
    if matrix is not None:
        m = np.asarray(matrix, dtype=np.float64)
        t.matrix = m[:3, :3]
    if translation is not None:
        t.translation = np.asarray(translation, dtype=np.float64)
    if rotation_center is not None:
        t.center = np.asarray(rotation_center, dtype=np.float64)
    return t
