"""ICP utility class (reference utils/rigid/icp.py:28-176).

Port of medicalimageanalysis_tpu/utils/rigid/icp.py: the same two entry
points as the reference (VTK-style and Open3D-style), both on the device
ICP of ops/registration/icp.py (``device``, default the card). The
reference's ``compute_com`` bug (it reads nonexistent self.mov/self.ref,
icp.py:53-60) is fixed to use source/target, as in the JAX package.
Only a point cloud without faces takes the host KD-tree, for its PCA
normals (``_estimate_normals``, scipy), as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ...ops.registration.icp import (icp_point_to_plane, icp_rigid,
                                     nearest_neighbors)

__all__ = ["ICP"]


def _points_of(obj):
    if hasattr(obj, "points"):
        return np.asarray(obj.points, dtype=np.float64)
    return np.asarray(obj, dtype=np.float64).reshape(-1, 3)


def _estimate_normals(points, k=12):
    """PCA normals for a raw point cloud (no faces available)."""
    from scipy.spatial import cKDTree
    tree = cKDTree(points)
    _, idx = tree.query(points, k=min(k, len(points)))
    normals = np.zeros_like(points)
    for i, nb in enumerate(idx):
        p = points[nb] - points[nb].mean(axis=0)
        _, _, vt = np.linalg.svd(p, full_matrices=False)
        normals[i] = vt[-1]
    return normals


class ICP(object):
    """Rigid ICP between a source and target mesh / point cloud."""

    def __init__(self, source, target, matrix=None, device=None):
        self.source = source
        self.target = target
        self.matrix = matrix
        self.icp = None
        self.info = None
        self.device = device

    def compute_com(self):
        """Initial translation matching centers of mass (fixed vs
        reference icp.py:53-60)."""
        translation = np.asarray(_points_of(self.target).mean(axis=0)) \
            - np.asarray(_points_of(self.source).mean(axis=0))
        self.matrix = np.identity(4)
        self.matrix[:3, 3] = translation

    def compute_vtk(self, distance=1e-5, iterations=1000, landmarks=None,
                    com_matching=True, inverse=False):
        """VTK-variant semantics: landmark cap (default target/10), RMS
        mean-distance convergence, optional centroid start."""
        src = _points_of(self.source)
        tgt = _points_of(self.target)
        m, info = icp_rigid(src, tgt, distance=distance,
                            iterations=iterations, landmarks=landmarks,
                            com_matching=com_matching,
                            init_matrix=self.matrix, device=self.device)
        self.info = info
        self.matrix = np.linalg.inv(m) if inverse else m

    def compute_o3d(self, distance=10, iterations=1000, rmse=1e-7,
                    fitness=1e-7, method="point", com_matching=True,
                    inverse=False):
        """Open3D-variant semantics: point-to-point or point-to-plane
        estimation, relative-rmse convergence, fitness/inlier metrics."""
        src = _points_of(self.source)
        tgt = _points_of(self.target)
        if method == "plane":
            from ...utils.mesh.surface import vertex_normals
            normals = vertex_normals(self.target, device=self.device) \
                if hasattr(self.target, "faces") \
                and getattr(self.target, "faces", np.zeros(0)).size \
                else _estimate_normals(tgt)
            m, info = icp_point_to_plane(src, tgt, normals,
                                         distance=rmse,
                                         iterations=iterations,
                                         com_matching=com_matching,
                                         init_matrix=self.matrix,
                                         device=self.device)
        else:
            m, info = icp_rigid(src, tgt, distance=rmse,
                                iterations=iterations,
                                landmarks=src.shape[0],
                                com_matching=com_matching,
                                init_matrix=self.matrix, device=self.device)
        self.info = info
        # fitness / inlier_rmse like open3d's result
        pts = src @ m[:3, :3].T + m[:3, 3]
        _, d2 = nearest_neighbors(pts, tgt, device=self.device)
        d = np.sqrt(np.maximum(d2, 0))
        inliers = d <= distance
        self.info["fitness"] = float(inliers.mean())
        self.info["inlier_rmse"] = float(
            np.sqrt(np.mean(np.maximum(d2[inliers], 0.0)))
            if inliers.any() else 0.0)
        self.matrix = np.linalg.inv(m) if inverse else m

    def get_matrix(self):
        return self.matrix

    def get_correspondence_set(self):
        """Source->target NN correspondences under the final transform."""
        if self.matrix is None:
            return None
        src = _points_of(self.source)
        tgt = _points_of(self.target)
        pts = src @ np.asarray(self.matrix)[:3, :3].T \
            + np.asarray(self.matrix)[:3, 3]
        idx, _ = nearest_neighbors(pts, tgt, device=self.device)
        return np.stack([np.arange(len(idx)), idx], axis=1)
