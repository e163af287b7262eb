"""Surface-mesh smoothing and decimation.

Port of the smoothing part of medicalimageanalysis_tpu/utils/mesh/
surface.py (``_edge_keys``, ``_adjacency``, ``_laplacian_step``,
``taubin_smooth``, ``constrained_smooth``, ``vertex_normals``,
``Refinement``) and of ``acvd_cluster``, which ``TriMesh.decimate``
runs:

- the umbrella steps run on the device in float64: the unique edges are
  found once (``torch.unique`` over packed keys), then each step is one
  ``index_add_`` over both directions of the edge list. ``np.add.at``
  sums in edge order; CUDA's atomic adds do not fix an order, so the
  results agree with the JAX package's to rounding (about 1e-12 mm), not
  to the bit;
- ``acvd_cluster`` (centroidal-Voronoi clustering) stays on the host, a
  copy of the JAX package's numpy and scipy ``cKDTree`` code.

The mesh repair (``clean_mesh``, the self-intersection removal),
``expansion``, ``surface_boundary``, ``only_main_component`` and
``Refinement``'s face splitting wait for the mesh slice (ROADMAP.md
queue 1, item 9).
"""

from __future__ import annotations

import numpy as np
import torch

from ..._waiting import waiting
from ...device import default_device
from .trimesh import TriMesh, box_mesh

__all__ = ["Refinement", "acvd_cluster", "box_mesh", "constrained_smooth",
           "taubin_smooth", "vertex_normals"]


def _edge_keys(edges_sorted):
    """Pack sorted (E, 2) int edges into int64 keys (exact: vertex ids
    are < 2^31)."""
    return (edges_sorted[:, 0].to(torch.int64) << 32) \
        | edges_sorted[:, 1].to(torch.int64)


def _adjacency(faces):
    """Unique undirected edges (E, 2) int64, ascending by (a, b), from a
    (M, 3) face tensor."""
    edges = torch.cat([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    edges = torch.sort(edges, dim=1).values
    keys = torch.unique(_edge_keys(edges), sorted=True)
    return torch.stack([keys >> 32, keys & 0xFFFFFFFF], dim=1)


class _Umbrella:
    """The umbrella operator of one mesh on the device: both directions
    of its unique edges and each vertex's degree, built once."""

    def __init__(self, mesh, device):
        faces = torch.as_tensor(mesh.faces, dtype=torch.int64,
                                device=device)
        edges = _adjacency(faces)
        self.dst = torch.cat([edges[:, 0], edges[:, 1]])
        self.src = torch.cat([edges[:, 1], edges[:, 0]])
        n = mesh.number_of_points
        self.deg = torch.clamp(torch.bincount(self.dst, minlength=n)
                               .to(torch.float64), min=1.0)[:, None]

    def step(self, points, factor):
        """One umbrella-operator step: p += factor * (mean(neighbors) - p)."""
        acc = torch.zeros_like(points).index_add_(0, self.dst,
                                                  points[self.src])
        return points + factor * (acc / self.deg - points)


def _points(mesh, device):
    if device is None:
        device = default_device()
    return torch.as_tensor(mesh.points, dtype=torch.float64, device=device)


def taubin_smooth(mesh, iterations=20, passband=0.001, lam=0.5, device=None):
    """Taubin low-pass smoothing (vtkWindowedSinc equivalent) on
    ``device`` (default: ``default_device()``).

    mu is chosen so the transfer function passes `passband`:
    1/lam + 1/mu = k_pb  (Taubin 1995).
    """
    if mesh.number_of_points == 0 or mesh.faces.size == 0:
        return mesh.copy()
    mu = lam / (lam * passband - 1.0)  # negative for k_pb < 1/lam
    pts = _points(mesh, device)
    umbrella = _Umbrella(mesh, pts.device)
    for _ in range(iterations):
        pts = umbrella.step(pts, lam)
        pts = umbrella.step(pts, mu)
    return TriMesh(pts.cpu().numpy(), mesh.faces.copy())


def constrained_smooth(mesh, iterations=20, relaxation=0.5, max_distance=1,
                       device=None):
    """Laplacian smoothing with per-vertex displacement clamped to
    `max_distance` from the original position, on ``device``."""
    if mesh.number_of_points == 0 or mesh.faces.size == 0:
        return mesh.copy()
    orig = _points(mesh, device)
    umbrella = _Umbrella(mesh, orig.device)
    pts = orig
    for _ in range(iterations):
        pts = umbrella.step(pts, relaxation)
        delta = pts - orig
        norm = torch.linalg.norm(delta, dim=1, keepdim=True)
        scale = torch.clamp(max_distance / torch.clamp(norm, min=1e-12),
                            max=1.0)
        pts = orig + delta * scale
    return TriMesh(pts.cpu().numpy(), mesh.faces.copy())


def vertex_normals(mesh, device=None):
    """Area-weighted vertex normals (N, 3) float64, computed on
    ``device``."""
    p = _points(mesh, device)
    f = torch.as_tensor(mesh.faces, dtype=torch.int64, device=p.device)
    fn = torch.linalg.cross(p[f[:, 1]] - p[f[:, 0]], p[f[:, 2]] - p[f[:, 0]])
    vn = torch.zeros_like(p)
    for k in range(3):
        vn.index_add_(0, f[:, k], fn)
    norm = torch.linalg.norm(vn, dim=1, keepdim=True)
    return (vn / torch.clamp(norm, min=1e-12)).cpu().numpy()


_MESH_ITEM = "item 9, mesh"


class Refinement(object):
    """Mesh refinement toolkit (reference utils/mesh/surface.py:25-251):
    smoothing, clustering and decimation."""

    def __init__(self, mesh, device=None):
        self.mesh = mesh
        self.device = device

    def smooth(self, iterations=20, angle=60, passband=0.001):
        self.mesh = taubin_smooth(self.mesh, iterations=iterations,
                                  passband=passband, device=self.device)
        return self.mesh

    def cluster(self, points=None):
        if points is None:
            points = self.compute_points()
        self.mesh = self.mesh.cluster_decimate(int(points))
        return self.mesh

    def decimate(self, percent=None):
        if percent is None:
            percent = self.compute_point_percentage()
        self.mesh = self.mesh.decimate(percent)
        return self.mesh

    def compute_points(self):
        """Target point heuristic 10*sqrt(N)
        (reference utils/mesh/surface.py:117-127)."""
        return np.round(10 * np.sqrt(self.mesh.number_of_points))

    def compute_point_percentage(self):
        points = self.compute_points()
        return 1 - (points / self.mesh.number_of_points)

    tri_split = waiting("Refinement.tri_split", _MESH_ITEM)
    advanced_split = waiting("Refinement.advanced_split", _MESH_ITEM)
    find_face_correction = waiting("Refinement.find_face_correction",
                                   _MESH_ITEM)
    compute_midpoints = waiting("Refinement.compute_midpoints", _MESH_ITEM)


def acvd_cluster(mesh, n_points, iterations=24, seed=0):
    """Centroidal-Voronoi vertex clustering (pyacvd-quality remesh), on
    the host as in the JAX package.

    Area-weighted Lloyd relaxation: cluster centroids are re-estimated
    from their member vertices weighted by Voronoi vertex area, and
    vertices re-assign to the nearest centroid each sweep (scipy
    cKDTree). Empty clusters re-seed to the farthest vertices, so the
    output vertex count is exactly ``n_points`` unless the input has
    fewer. Output faces: original faces whose three vertices land in
    three distinct clusters, deduplicated; orientation follows the
    source.
    """
    from scipy.spatial import cKDTree

    n_points = int(n_points)
    if mesh.number_of_points <= n_points or mesh.faces.size == 0:
        return mesh.copy()
    # huge inputs: grid-cluster first to ~8x the target (one binning
    # pass), then relax that intermediate to the exact count
    if mesh.number_of_points > max(8 * n_points, 100_000):
        mesh = mesh.cluster_decimate(8 * n_points, method="grid")
        if mesh.number_of_points <= n_points:
            return mesh
    pts = np.asarray(mesh.points, np.float64)
    f = np.asarray(mesh.faces, np.int64)
    a = pts[f[:, 0]]
    b = pts[f[:, 1]]
    c = pts[f[:, 2]]
    fa = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    w = np.zeros(len(pts))
    np.add.at(w, f[:, 0], fa / 3)
    np.add.at(w, f[:, 1], fa / 3)
    np.add.at(w, f[:, 2], fa / 3)
    w = np.maximum(w, 1e-12)

    rng = np.random.default_rng(seed)
    centers = pts[rng.choice(len(pts), size=n_points, replace=False,
                             p=w / w.sum())]
    assign = None
    for _ in range(int(iterations)):
        tree = cKDTree(centers)
        dist, assign = tree.query(pts, workers=-1)
        sums = np.zeros((n_points, 3))
        wsum = np.zeros(n_points)
        np.add.at(sums, assign, pts * w[:, None])
        np.add.at(wsum, assign, w)
        empty = wsum <= 0
        if empty.any():
            # re-seed empties at the worst-served vertices
            order = np.argsort(-dist)
            centers[empty] = pts[order[:int(empty.sum())]]
            centers[~empty] = sums[~empty] / wsum[~empty, None]
            continue
        new_centers = sums / wsum[:, None]
        if np.max(np.linalg.norm(new_centers - centers, axis=1)) < 1e-9:
            centers = new_centers
            break
        centers = new_centers
    tree = cKDTree(centers)
    _, assign = tree.query(pts, workers=-1)

    # cluster -> output vertex (weighted centroid of members)
    sums = np.zeros((n_points, 3))
    wsum = np.zeros(n_points)
    np.add.at(sums, assign, pts * w[:, None])
    np.add.at(wsum, assign, w)
    used = wsum > 0
    remap = -np.ones(n_points, np.int64)
    remap[used] = np.arange(int(used.sum()))
    new_points = sums[used] / wsum[used, None]

    nf = remap[assign[f]]
    valid = ((nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2])
             & (nf[:, 0] != nf[:, 2]))
    nf = nf[valid]
    # dedupe triangles (adjacent source faces can collapse onto the
    # same cluster triple); keep the first orientation seen
    key = np.sort(nf, axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    return TriMesh(new_points, nf[np.sort(first)])
