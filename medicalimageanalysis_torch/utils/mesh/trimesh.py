"""TriMesh: the port's triangle-mesh container.

Port of medicalimageanalysis_tpu/utils/mesh/trimesh.py, a host container
on numpy as there: vertices float64 (N, 3), faces int32 (M, 3), with the
attribute surface the JAX package's callers use (``volume``, ``center``,
``bounds``, ``number_of_points``, ``GetBounds()``, ``transform``,
``clean``, ``split_bodies``, ``decimate``, ``slice_plane``). The meshes
themselves are built and smoothed on the device (ops/marching_cubes,
utils/mesh/surface). ``unique_inverse`` / ``unique_rows`` keep the
JAX package's contract on ``np.unique`` alone (the card's machine has no
pandas). ``save`` dispatches on the extension to the STL / 3MF / VTK /
PLY / OBJ writers of read/, else writes the ``.npz`` layout.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TriMesh", "box_mesh", "unique_inverse", "unique_rows"]


def unique_inverse(keys, return_index=False):
    """np.unique(keys, return_inverse=True) for 1-D integer keys:
    (ascending uniques[, first-occurrence index], inverse)."""
    out = np.unique(keys, return_index=return_index, return_inverse=True)
    return (*out[:-1], out[-1].reshape(-1))


def unique_rows(rows):
    """np.unique(rows, axis=0, return_index=True, return_inverse=True):
    (rows in lexicographic order, first-occurrence index, inverse)."""
    uniq, first, inverse = np.unique(np.ascontiguousarray(rows), axis=0,
                                     return_index=True, return_inverse=True)
    return uniq, first, inverse.reshape(-1)


class TriMesh:
    def __init__(self, points, faces):
        self.points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        self.faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
        self.point_data = {}

    def vertex_colors_uint8(self):
        """point_data['colors'] normalized to (N, 3) uint8 for mesh
        writers (PLY/OBJ/3MF share this contract), or None."""
        if "colors" not in self.point_data:
            return None
        colors = np.asarray(self.point_data["colors"])
        if colors.dtype != np.uint8:
            colors = np.clip(colors, 0, 255).astype(np.uint8)
        colors = colors.reshape(colors.shape[0], -1)[:, :3]
        if colors.shape[0] != self.points.shape[0]:
            raise ValueError(
                f"colors length {colors.shape[0]} != points "
                f"{self.points.shape[0]}")
        return colors

    # pyvista-style point-data access: mesh["colors"] = ...
    def __setitem__(self, key, value):
        self.point_data[key] = np.asarray(value)

    def __getitem__(self, key):
        return self.point_data[key]

    # -- basic properties ------------------------------------------------
    @property
    def number_of_points(self):
        return self.points.shape[0]

    @property
    def n_points(self):
        return self.points.shape[0]

    @property
    def number_of_faces(self):
        return self.faces.shape[0]

    @property
    def n_cells(self):
        return self.faces.shape[0]

    @property
    def bounds(self):
        if self.points.size == 0:
            return [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
        lo = self.points.min(axis=0)
        hi = self.points.max(axis=0)
        return [lo[0], hi[0], lo[1], hi[1], lo[2], hi[2]]

    def GetBounds(self):
        return tuple(self.bounds)

    @property
    def center(self):
        b = self.bounds
        return [(b[0] + b[1]) / 2, (b[2] + b[3]) / 2, (b[4] + b[5]) / 2]

    @property
    def center_of_mass(self):
        return self.points.mean(axis=0)

    @property
    def volume(self):
        """Enclosed volume via signed tetrahedra (watertight surfaces)."""
        if self.faces.size == 0:
            return 0.0
        p = self.points
        a = p[self.faces[:, 0]]
        b = p[self.faces[:, 1]]
        c = p[self.faces[:, 2]]
        return float(abs(np.einsum("ij,ij->i", a, np.cross(b, c)).sum()) / 6.0)

    @property
    def area(self):
        if self.faces.size == 0:
            return 0.0
        p = self.points
        a = p[self.faces[:, 0]]
        b = p[self.faces[:, 1]]
        c = p[self.faces[:, 2]]
        return float(np.linalg.norm(np.cross(b - a, c - a), axis=1).sum() / 2)

    def copy(self):
        return TriMesh(self.points.copy(), self.faces.copy())

    # -- transforms -------------------------------------------------------
    def transform(self, matrix4, inplace=True):
        """Apply a 4x4 homogeneous transform to the vertices."""
        m = np.asarray(matrix4, dtype=np.float64)
        pts = np.hstack([self.points, np.ones((self.points.shape[0], 1))])
        new_pts = pts @ m.T
        new_pts = new_pts[:, :3]
        if inplace:
            self.points = new_pts
            return self
        return TriMesh(new_pts, self.faces.copy())

    # -- cleaning / components --------------------------------------------
    def clean(self, tolerance=1e-9):
        """Merge duplicate vertices, drop degenerate faces."""
        if self.points.size == 0:
            return self
        scale = max(1.0, np.abs(self.points).max())
        quant = np.round(self.points / (tolerance * scale)).astype(np.int64)
        _, first_idx, inverse = unique_rows(quant)
        new_points = self.points[first_idx]
        new_faces = inverse[self.faces]
        valid = ((new_faces[:, 0] != new_faces[:, 1])
                 & (new_faces[:, 1] != new_faces[:, 2])
                 & (new_faces[:, 0] != new_faces[:, 2]))
        return TriMesh(new_points, new_faces[valid])

    def split_bodies(self):
        """Connected components (vertex-connectivity) -> list of TriMesh.

        scipy.sparse.csgraph label propagation — the Python union-find
        loop it replaces was O(faces) interpreted bytecode, seconds at
        organ scale."""
        n = self.number_of_points
        if n == 0:
            return []
        if self.faces.size:
            from scipy.sparse import coo_matrix
            from scipy.sparse.csgraph import connected_components
            src = np.concatenate([self.faces[:, 0], self.faces[:, 1]])
            dst = np.concatenate([self.faces[:, 1], self.faces[:, 2]])
            g = coo_matrix((np.ones(src.size, np.int8), (src, dst)),
                           shape=(n, n))
            _, roots = connected_components(g, directed=False)
        else:
            roots = np.arange(n)
        bodies = []
        for r in unique_inverse(roots[self.faces[:, 0]]
                                if self.faces.size else roots)[0]:
            vmask = roots == r
            fmask = vmask[self.faces[:, 0]]
            if not fmask.any():
                continue
            vidx = np.nonzero(vmask)[0]
            remap = -np.ones(n, dtype=np.int64)
            remap[vidx] = np.arange(len(vidx))
            bodies.append(TriMesh(self.points[vidx],
                                  remap[self.faces[fmask]]))
        return bodies

    # -- decimation --------------------------------------------------------
    def decimate(self, fraction):
        """Reduce triangle count by `fraction` (0..1) via vertex-grid
        clustering (replaces pyvista decimate, reference
        structure/roi.py:283-307)."""
        target_points = max(4, int(round(self.number_of_points
                                         * (1 - fraction))))
        return self.cluster_decimate(target_points)

    def decimate_pro(self, fraction):
        return self.decimate(fraction)

    def cluster_decimate(self, target_points, method="acvd"):
        """Cluster-based decimation to ``target_points``.

        method='acvd' (default): centroidal-Voronoi Lloyd relaxation
        (pyacvd-quality isotropy, EXACT output point count — reference
        utils/mesh/surface.py:74-94 uses pyacvd here); method='grid':
        the uniform-grid clustering (approximate count, faster on
        multi-million-point meshes)."""
        if method == "acvd":
            from .surface import acvd_cluster
            return acvd_cluster(self, target_points)
        if self.number_of_points <= target_points or self.faces.size == 0:
            return self.copy()
        b = self.bounds
        extent = np.array([b[1] - b[0], b[3] - b[2], b[5] - b[4]])
        extent = np.maximum(extent, 1e-9)
        # choose grid so that expected occupied cells ~ target_points
        cell = (extent.prod() / max(target_points * 4, 8)) ** (1 / 3)
        for _ in range(8):
            idx = np.floor((self.points - [b[0], b[2], b[4]])
                           / cell).astype(np.int64)
            key = (idx[:, 0] * 73856093) ^ (idx[:, 1] * 19349663) \
                ^ (idx[:, 2] * 83492791)
            uniq, inverse = unique_inverse(key)
            if uniq.size <= target_points * 1.3:
                break
            cell *= 1.3
        # cluster centroid (representative order = ascending cell key,
        # identical to the previous np.unique grouping)
        sums = np.zeros((uniq.size, 3))
        counts = np.zeros(uniq.size)
        np.add.at(sums, inverse, self.points)
        np.add.at(counts, inverse, 1)
        new_points = sums / counts[:, None]
        new_faces = inverse[self.faces]
        valid = ((new_faces[:, 0] != new_faces[:, 1])
                 & (new_faces[:, 1] != new_faces[:, 2])
                 & (new_faces[:, 0] != new_faces[:, 2]))
        return TriMesh(new_points, new_faces[valid])

    # -- plane cross-section ------------------------------------------------
    def slice_plane(self, normal, origin, candidate_faces=None):
        """Cross-section with the plane (normal, origin) -> list of
        (N, 3) polyline loops (replaces pyvista .slice + .strip,
        reference structure/roi.py:406-486).

        candidate_faces optionally restricts the face set to a
        precomputed index array that must contain every face crossing
        the plane (callers slicing MANY parallel planes bucket faces
        by span once instead of paying O(F) per plane — the
        ModelToMask voxelizer hot spot); output is identical."""
        if isinstance(normal, str):
            normal = {"x": [1, 0, 0], "y": [0, 1, 0],
                      "z": [0, 0, 1]}[normal.lower()]
        n = np.asarray(normal, dtype=np.float64)
        n = n / np.linalg.norm(n)
        o = np.asarray(origin, dtype=np.float64)

        if candidate_faces is None:
            d = (self.points - o) @ n  # signed distances
            f = self.faces
            df = d[f]
        else:
            # O(candidates) instead of O(points): the many-parallel-
            # planes callers pay the full point set only once
            f = self.faces[candidate_faces]
            df = ((self.points[f.reshape(-1)] - o) @ n).reshape(f.shape)
        side = df > 0
        crossing = (side.any(axis=1)) & (~side.all(axis=1))
        if not crossing.any():
            return []

        # vectorized generic case: a crossing triangle has exactly two
        # crossed edges (the per-face Python loop was the voxelization
        # hot spot at ~100 planes x thousands of faces)
        cf = f[crossing]                        # (C, 3)
        dc = df[crossing]                       # (C, 3)
        pairs = ((0, 1), (1, 2), (2, 0))
        cross_e = np.stack([(dc[:, a] > 0) != (dc[:, b] > 0)
                            for a, b in pairs], axis=1)      # (C, 3)
        n_cross = cross_e.sum(axis=1)
        generic = n_cross == 2

        if not generic.any():
            return []
        cfg = cf[generic]
        dg = dc[generic]
        pts_e = np.empty((cfg.shape[0], 3, 3))
        for e, (a, b) in enumerate(pairs):
            da, db = dg[:, a], dg[:, b]
            denom = np.where(da - db != 0, da - db, 1.0)
            t = (da / denom)[:, None]
            pa = self.points[cfg[:, a]]
            pb = self.points[cfg[:, b]]
            pts_e[:, e] = pa + t * (pb - pa)
        first2 = np.argsort(~cross_e[generic], axis=1,
                            kind="stable")[:, :2]        # (G, 2)
        rows = np.arange(cfg.shape[0])[:, None]
        seg_pts = pts_e[rows, first2]                    # (G, 2, 3)

        # NOTE: with the (d > 0) predicate, sign transitions around a
        # 3-cycle are always even, so every crossing face has EXACTLY
        # two crossed edges — 'generic' is always all-True and no
        # per-face fallback is needed (faces lying fully in the plane
        # have side all-False and are excluded by `crossing`).
        return _chain_segments(seg_pts)

    def slice(self, normal, origin):
        """pyvista-style alias returning a polyline container object."""
        loops = self.slice_plane(normal, origin)
        return _SliceResult(loops)

    # -- IO ------------------------------------------------------------------
    def save(self, path):
        """Write the mesh in the format its extension names (.stl, .3mf,
        .vtk, .ply, .obj; the 3MF, PLY and OBJ writers carry
        ``point_data['colors']``), else ``np.savez`` of points and
        faces."""
        import importlib

        path = str(path)
        writers = {".stl": ("stl", "write_stl"), ".3mf": ("mf3", "write_3mf"),
                   ".vtk": ("vtk", "write_vtk_polydata"),
                   ".ply": ("ply", "write_ply"), ".obj": ("obj", "write_obj")}
        ext = path[path.rfind("."):].lower() if "." in path else ""
        if ext in writers:
            module, name = writers[ext]
            write = getattr(importlib.import_module(
                f"...read.{module}", __package__), name)
            write(path, self)
        else:
            np.savez(path, points=self.points, faces=self.faces)


class _SliceResult:
    """Polyline container mimicking the bits of pyvista's slice output
    the reference touches (points, number_of_points, strip().cell)."""

    def __init__(self, loops):
        self.loops = loops
        self.points = np.concatenate(loops, axis=0) if loops \
            else np.zeros((0, 3))

    @property
    def number_of_points(self):
        return self.points.shape[0]

    def strip(self, max_length=None):
        return self

    @property
    def cell(self):
        return [_Polyline(loop) for loop in self.loops]


class _Polyline:
    def __init__(self, pts):
        self.points = np.asarray(pts)

    @property
    def point_ids(self):
        return np.arange(self.points.shape[0])


def _chain_closed_loops(pts, inverse, seg_ids):
    """Vectorized loop extraction for the all-degree-2 case, ordered
    exactly like the sequential walk (each loop starts at its lowest
    segment index, runs a->b, loops emitted by ascending start
    segment). Returns None when any node's degree != 2 or a segment is
    degenerate — the caller falls back to the walk."""
    n_seg = seg_ids.shape[0]
    if n_seg == 0:
        return []
    if np.any(seg_ids[:, 0] == seg_ids[:, 1]):
        return None
    n_nodes = int(inverse.max()) + 1
    deg = np.bincount(inverse, minlength=n_nodes)
    if deg.min() != 2 or deg.max() != 2:
        return None

    # directed half-edges: 2s leaves seg_ids[s, 0], 2s+1 leaves
    # seg_ids[s, 1]; the successor of e continues from the node e
    # enters via that node's OTHER leaving edge (never the reverse)
    leave = seg_ids.ravel()
    order = np.argsort(leave, kind="stable")
    out0 = order[0::2]                  # per node: lowest leaving edge
    out1 = order[1::2]
    eidx = np.arange(2 * n_seg)
    rev = eidx ^ 1
    enter = leave[rev]
    cand0 = out0[enter]
    succ = np.where(cand0 != rev, cand0, out1[enter])

    # node coords: LAST quantized occurrence wins (walk parity)
    coord = np.empty((n_nodes, pts.shape[1]), pts.dtype)
    coord[inverse] = pts

    succ_l = succ.tolist()
    leave_l = leave.tolist()
    used = [False] * n_seg
    loops = []
    for s in range(n_seg):
        if used[s]:
            continue
        e = 2 * s
        chain = []
        while True:
            chain.append(leave_l[e])
            used[e >> 1] = True
            e = succ_l[e]
            if e == 2 * s:
                break
        loops.append(coord[np.asarray(chain)])
    return loops


def _chain_segments(segments, tol=1e-6):
    """Chain unordered segments into polylines/loops.

    All-closed-loop inputs (every quantized node has degree exactly 2
    — the typical watertight-mesh cross-section) take a fully
    vectorized permutation-cycle path; anything else (open chains,
    pinch points, degenerate segments) falls back to the exact
    sequential walk with identical ordering semantics.

    segments: (N, 2, 3) endpoint array, or any sequence of (a, b)
    point pairs."""
    seg_arr = np.asarray(segments, dtype=np.float64)
    if seg_arr.size == 0:
        return []
    pts = seg_arr.reshape(-1, seg_arr.shape[-1])
    scale = max(1.0, np.abs(pts).max())
    quant = np.round(pts / (tol * scale)).astype(np.int64)
    _, inverse = np.unique(quant, axis=0, return_inverse=True)
    n_seg = seg_arr.shape[0]
    seg_ids = inverse.reshape(n_seg, 2)

    fast = _chain_closed_loops(pts, inverse, seg_ids)
    if fast is not None:
        return fast

    # exact walk over CSR adjacency (node-major, then segment index
    # with each segment's a-entry before its b-entry — the same
    # first-unused ordering the original dict-of-lists walk used)
    n_nodes = int(inverse.max()) + 1
    leave = seg_ids.ravel()
    other = seg_ids[:, ::-1].ravel()
    order = np.argsort(leave, kind="stable")
    starts = np.searchsorted(leave[order],
                             np.arange(n_nodes + 1)).tolist()
    adj_seg = (order >> 1).tolist()
    adj_other = other[order].tolist()
    seg_list = seg_ids.tolist()

    # node coords: LAST quantized occurrence wins
    coord = np.empty((n_nodes, pts.shape[1]), pts.dtype)
    coord[inverse] = pts

    used = [False] * n_seg
    loops = []
    for start_seg in range(n_seg):
        if used[start_seg]:
            continue
        a, b = seg_list[start_seg]
        used[start_seg] = True
        chain = [a, b]
        # extend forward (stop when the loop closes back to chain[0])
        current = b
        while True:
            si = -1
            for i in range(starts[current], starts[current + 1]):
                if not used[adj_seg[i]]:
                    si = adj_seg[i]
                    nxt = adj_other[i]
                    break
            if si < 0:
                break
            used[si] = True
            if nxt == chain[0]:
                break  # loop closed
            chain.append(nxt)
            current = nxt
        # extend backward (open chains only)
        back = []
        current = chain[0]
        while True:
            si = -1
            for i in range(starts[current], starts[current + 1]):
                if not used[adj_seg[i]]:
                    si = adj_seg[i]
                    nxt = adj_other[i]
                    break
            if si < 0:
                break
            used[si] = True
            back.append(nxt)
            current = nxt
        if back:
            chain = back[::-1] + chain
        loops.append(coord[np.asarray(chain)])
    return loops


def box_mesh(lo, hi):
    """Axis-aligned box surface (replaces pv.Box, reference
    structure/image.py:1106-1125)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    points = np.array([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]])
    faces = np.array([
        [0, 2, 1], [0, 3, 2],  # bottom
        [4, 5, 6], [4, 6, 7],  # top
        [0, 1, 5], [0, 5, 4],  # front
        [2, 3, 7], [2, 7, 6],  # back
        [1, 2, 6], [1, 6, 5],  # right
        [3, 0, 4], [3, 4, 7],  # left
    ])
    return TriMesh(points, faces)
