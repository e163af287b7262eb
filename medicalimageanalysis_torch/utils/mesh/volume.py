"""Surface -> tetrahedral volume mesh.

Port of medicalimageanalysis_tpu/utils/mesh/volume.py, on the host as
there (numpy, scipy ``cKDTree``); the lattice's inside test fills each
plane's mesh cut with the port's rasterizer (ops/rasterize.
fill_polygons_2d) on the CPU. It replaces the reference's pytetwild path
(reference utils/mesh/volume.py:21-60). Two methods:

- ``method='stuffing'`` (default): ISOSURFACE STUFFING
  (Labelle & Shewchuk 2007, simplified): tetrahedra come from the
  body-centered-cubic lattice (all congruent, dihedral angles
  60/90 deg), lattice vertices within ``alpha * cell`` of the surface
  are WARPED onto their exact closest surface point, and only tets
  whose vertices are inside-or-warped survive. The boundary conforms
  to the actual surface (warped vertices lie ON it) and element
  quality stays near the BCC optimum, asserted by dihedral and
  conformity tests.
- ``method='voxel'``: the structured 6-tet-per-voxel mesh
  (fastest, staircase boundary).
"""

from __future__ import annotations

import numpy as np

__all__ = ["TetMesh", "Volume"]

# the same 6-tet cube decomposition used by the marching-tets extractor
_CUBE_OFFSETS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.int64)
_TET_CORNERS = np.array([
    [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
    [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]], dtype=np.int64)


class TetMesh:
    def __init__(self, points, cells):
        self.points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        self.cells = np.asarray(cells, dtype=np.int64).reshape(-1, 4)

    @property
    def n_points(self):
        return self.points.shape[0]

    @property
    def n_cells(self):
        return self.cells.shape[0]

    @property
    def volume(self):
        p = self.points
        a = p[self.cells[:, 0]]
        b = p[self.cells[:, 1]]
        c = p[self.cells[:, 2]]
        d = p[self.cells[:, 3]]
        return float(np.abs(np.einsum(
            "ij,ij->i", a - d, np.cross(b - d, c - d))).sum() / 6.0)

    def dihedral_angles(self):
        """(n_cells, 6) dihedral angles in degrees (element quality:
        the BCC lattice tets are at 60/90; pytetwild-class meshes keep
        the minimum well above the sliver regime)."""
        p = self.points
        c = self.cells
        v = p[c]                            # (N, 4, 3)
        # faces opposite each vertex; dihedral at edge (i, j) is the
        # angle between the two faces NOT containing the opposite pair
        import itertools
        angles = np.zeros((c.shape[0], 6))
        for e, (i, j) in enumerate(itertools.combinations(range(4), 2)):
            k, l = [m for m in range(4) if m not in (i, j)]
            # project the opposite vertices onto the plane normal to
            # the shared edge: the angle between the projections IS
            # the dihedral (sign-free, orientation-free)
            u = v[:, j] - v[:, i]
            u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True),
                            1e-30)
            a = v[:, k] - v[:, i]
            b = v[:, l] - v[:, i]
            a = a - np.einsum("ij,ij->i", a, u)[:, None] * u
            b = b - np.einsum("ij,ij->i", b, u)[:, None] * u
            a /= np.maximum(np.linalg.norm(a, axis=1, keepdims=True),
                            1e-30)
            b /= np.maximum(np.linalg.norm(b, axis=1, keepdims=True),
                            1e-30)
            cosang = np.clip(np.einsum("ij,ij->i", a, b), -1.0, 1.0)
            angles[:, e] = np.degrees(np.arccos(cosang))
        return angles

    def save(self, path, binary=False):
        """ASCII legacy-VTK UNSTRUCTURED_GRID writer."""
        with open(str(path), "w") as f:
            f.write("# vtk DataFile Version 3.0\n")
            f.write("tetrahedral mesh\nASCII\n")
            f.write("DATASET UNSTRUCTURED_GRID\n")
            f.write(f"POINTS {self.n_points} float\n")
            for p in self.points:
                f.write(f"{p[0]:g} {p[1]:g} {p[2]:g}\n")
            f.write(f"CELLS {self.n_cells} {self.n_cells * 5}\n")
            for c in self.cells:
                f.write(f"4 {c[0]} {c[1]} {c[2]} {c[3]}\n")
            f.write(f"CELL_TYPES {self.n_cells}\n")
            f.write("\n".join(["10"] * self.n_cells) + "\n")


def _closest_point_on_tris(q, a, b, c):
    """Vectorized exact closest point on triangle (Ericson, RTCD
    5.1.5): q/a/b/c (N, 3) paired -> (N, 3) closest points."""
    ab = b - a
    ac = c - a
    ap = q - a
    d1 = np.einsum("ij,ij->i", ab, ap)
    d2 = np.einsum("ij,ij->i", ac, ap)
    bp = q - b
    d3 = np.einsum("ij,ij->i", ab, bp)
    d4 = np.einsum("ij,ij->i", ac, bp)
    cp = q - c
    d5 = np.einsum("ij,ij->i", ab, cp)
    d6 = np.einsum("ij,ij->i", ac, cp)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    denom = np.maximum(va + vb + vc, 1e-30)
    v = np.where(denom > 0, vb / denom, 0.0)
    w = np.where(denom > 0, vc / denom, 0.0)
    out = a + v[:, None] * ab + w[:, None] * ac   # interior case
    # edge/vertex regions
    t_ab = np.clip(np.where(d1 - d3 != 0, d1 / np.maximum(d1 - d3, 1e-30),
                            0.0), 0, 1)
    t_ac = np.clip(np.where(d2 - d6 != 0, d2 / np.maximum(d2 - d6, 1e-30),
                            0.0), 0, 1)
    t_bc = np.clip((d4 - d3) / np.maximum((d4 - d3) + (d5 - d6), 1e-30),
                   0, 1)
    out = np.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[:, None],
                   a + t_ab[:, None] * ab, out)
    out = np.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[:, None],
                   a + t_ac[:, None] * ac, out)
    out = np.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[:, None],
                   b + t_bc[:, None] * (c - b), out)
    out = np.where(((d1 <= 0) & (d2 <= 0))[:, None], a, out)
    out = np.where(((d3 >= 0) & (d4 <= d3))[:, None], b, out)
    out = np.where(((d6 >= 0) & (d5 <= d6))[:, None], c, out)
    return out


def _surface_closest(nodes, mesh, k=8, with_face=False):
    """(dist, closest point[, face index]) from each query node to the
    surface: cKDTree over face centroids prunes to k candidate faces,
    exact point-triangle distance decides."""
    from scipy.spatial import cKDTree

    pts = np.asarray(mesh.points, np.float64)
    f = np.asarray(mesh.faces, np.int64)
    cent = pts[f].mean(axis=1)
    k = min(k, f.shape[0])
    tree = cKDTree(cent)
    _, cand = tree.query(nodes, k=k, workers=-1)
    if k == 1:
        cand = cand[:, None]
    n = nodes.shape[0]
    best_d = np.full(n, np.inf)
    best_p = np.zeros((n, 3))
    best_f = np.zeros(n, np.int64)
    for col in range(cand.shape[1]):
        fi = cand[:, col]
        tri = f[fi]
        cp = _closest_point_on_tris(nodes, pts[tri[:, 0]],
                                    pts[tri[:, 1]], pts[tri[:, 2]])
        d = np.linalg.norm(nodes - cp, axis=1)
        take = d < best_d
        best_d[take] = d[take]
        best_p[take] = cp[take]
        best_f[take] = fi[take]
    if with_face:
        return best_d, best_p, best_f
    return best_d, best_p


class Volume(object):
    """Surface mesh -> tetrahedral mesh (reference utils/mesh/
    volume.py:21-60 API: __init__(surface), create(edge_length),
    write(path))."""

    def __init__(self, surface_mesh):
        self.surface_mesh = surface_mesh
        self.mesh = None

    def create(self, edge_length=.02, method="stuffing", alpha=0.25):
        """Tetrahedralize; `edge_length` is the fraction of the
        bounding-box diagonal used as the cell size (pytetwild's
        edge_length_fac semantics). method='stuffing' (default) is the
        isosurface-stuffing mesher (BCC lattice + boundary warping,
        pytetwild-class quality); 'voxel' the structured 6-tet grid."""
        if method == "stuffing":
            self.mesh = self._create_stuffing(edge_length, alpha)
            return self.mesh
        return self._create_voxel(edge_length)

    def _inside_lattice(self, b, cell, nz, ny, nx, half):
        """Inside flags for lattice nodes at
        (b + (idx + half) * cell) via per-plane polygon fills."""
        from ...ops.rasterize import fill_polygons_2d
        inside = np.zeros((nz, ny, nx), dtype=bool)
        for k in range(nz):
            z = b[4] + (k + half) * cell
            loops = self.surface_mesh.slice_plane([0, 0, 1],
                                                  [0, 0, z + 1e-6])
            if not loops:
                continue
            polys = [(np.asarray(lp)[:, :2]
                      - [b[0] + half * cell, b[2] + half * cell]) / cell
                     for lp in loops]
            inside[k] = fill_polygons_2d(polys, ny, nx,
                                        device="cpu").astype(bool)
        return inside

    def _create_stuffing(self, edge_length, alpha):
        """Isosurface stuffing (simplified Labelle-Shewchuk): BCC
        lattice tets; lattice vertices within alpha*cell of the
        surface warp onto their exact closest surface point; tets
        survive when every vertex is inside-or-warped and at least one
        is strictly interior; near-degenerate products of warping are
        dropped. BCC tets are congruent with 60/90-degree dihedrals,
        and warping by <= alpha*cell keeps elements far from the
        sliver regime (quality asserted in tests)."""
        surf = self.surface_mesh
        b = surf.bounds
        diag = np.linalg.norm([b[1] - b[0], b[3] - b[2], b[5] - b[4]])
        cell = max(diag * edge_length, 1e-6)
        # pad one cell so boundary cells have complete BCC neighborhoods
        b = [b[0] - cell, b[1] + cell, b[2] - cell,
             b[3] + cell, b[4] - cell, b[5] + cell]
        nx = int(np.ceil((b[1] - b[0]) / cell)) + 1
        ny = int(np.ceil((b[3] - b[2]) / cell)) + 1
        nz = int(np.ceil((b[5] - b[4]) / cell)) + 1

        # primal nodes (nz, ny, nx) and cell centers (nz-1, ny-1, nx-1)
        in_p = self._inside_lattice(b, cell, nz, ny, nx, 0.0)
        in_c = self._inside_lattice(b, cell, nz - 1, ny - 1, nx - 1, 0.5)

        kk, jj, ii = np.mgrid[0:nz, 0:ny, 0:nx]
        p_pts = np.stack([b[0] + ii * cell, b[2] + jj * cell,
                          b[4] + kk * cell], axis=-1).reshape(-1, 3)
        kk, jj, ii = np.mgrid[0:nz - 1, 0:ny - 1, 0:nx - 1]
        c_pts = np.stack([b[0] + (ii + 0.5) * cell,
                          b[2] + (jj + 0.5) * cell,
                          b[4] + (kk + 0.5) * cell],
                         axis=-1).reshape(-1, 3)
        pts = np.concatenate([p_pts, c_pts])
        inside = np.concatenate([in_p.ravel(), in_c.ravel()])
        n_p = p_pts.shape[0]

        # warp near-surface nodes onto their closest surface point;
        # restrict the (exact) distance query to nodes within one cell
        # of the surface by a cheap vertex-tree prefilter
        from scipy.spatial import cKDTree
        vtree = cKDTree(np.asarray(surf.points))
        rough = vtree.query(pts, workers=-1)[0]
        near = rough <= 2.0 * cell
        warped = np.zeros(pts.shape[0], dtype=bool)
        if near.any():
            d, cp, fi = _surface_closest(pts[near], surf,
                                         with_face=True)
            # SIGNED classification for near-boundary nodes: the
            # rasterized inside test rounds each slice polygon to
            # pixel centers (up to half a cell of systematic
            # inflation, measured +6% volume on a sphere); the sign of
            # (node - closest point) . outward-face-normal is exact
            sp_ = np.asarray(surf.points, np.float64)
            sf = np.asarray(surf.faces, np.int64)[fi]
            nrm = np.cross(sp_[sf[:, 1]] - sp_[sf[:, 0]],
                           sp_[sf[:, 2]] - sp_[sf[:, 0]])
            signed_out = np.einsum(
                "ij,ij->i", pts[near] - cp, nrm) > 0
            ni = np.nonzero(near)[0]
            inside[ni] = ~signed_out
            # asymmetric warp thresholds (Labelle-Shewchuk use long/
            # short-edge alphas the same way): inside vertices warp
            # outward only within alpha*cell (they are load-bearing
            # for element quality), while OUTSIDE vertices warp in
            # from up to 2*alpha*cell — a dropped outside vertex
            # removes its whole boundary tet, which costs far more
            # volume conformity than the extra warp costs dihedral
            # quality (measured: 92% -> ~98% sphere volume)
            snap = d <= np.where(signed_out, 2.0 * alpha, alpha) * cell
            idx = ni[snap]
            pts[idx] = cp[snap]
            warped[idx] = True
        keep_v = inside | warped

        # BCC tets: for each pair of face-adjacent cell centers, one
        # tet per edge of the shared primal face (4 tets x 3 axes)
        def pid(k, j, i):
            return (k * ny + j) * nx + i

        def cid(k, j, i):
            return n_p + (k * (ny - 1) + j) * (nx - 1) + i

        tets = []
        # centers adjacent along x: shared face at x = i+1
        kk, jj, ii = np.mgrid[0:nz - 1, 0:ny - 1, 0:nx - 2]
        c1 = cid(kk, jj, ii).ravel()
        c2 = cid(kk, jj, ii + 1).ravel()
        f00 = pid(kk, jj, ii + 1).ravel()
        f10 = pid(kk, jj + 1, ii + 1).ravel()
        f11 = pid(kk + 1, jj + 1, ii + 1).ravel()
        f01 = pid(kk + 1, jj, ii + 1).ravel()
        for ea, eb in ((f00, f10), (f10, f11), (f11, f01), (f01, f00)):
            tets.append(np.stack([c1, c2, ea, eb], axis=1))
        # adjacent along y: face at y = j+1
        kk, jj, ii = np.mgrid[0:nz - 1, 0:ny - 2, 0:nx - 1]
        c1 = cid(kk, jj, ii).ravel()
        c2 = cid(kk, jj + 1, ii).ravel()
        f00 = pid(kk, jj + 1, ii).ravel()
        f10 = pid(kk, jj + 1, ii + 1).ravel()
        f11 = pid(kk + 1, jj + 1, ii + 1).ravel()
        f01 = pid(kk + 1, jj + 1, ii).ravel()
        for ea, eb in ((f00, f10), (f10, f11), (f11, f01), (f01, f00)):
            tets.append(np.stack([c1, c2, ea, eb], axis=1))
        # adjacent along z: face at z = k+1
        kk, jj, ii = np.mgrid[0:nz - 2, 0:ny - 1, 0:nx - 1]
        c1 = cid(kk, jj, ii).ravel()
        c2 = cid(kk + 1, jj, ii).ravel()
        f00 = pid(kk + 1, jj, ii).ravel()
        f10 = pid(kk + 1, jj, ii + 1).ravel()
        f11 = pid(kk + 1, jj + 1, ii + 1).ravel()
        f01 = pid(kk + 1, jj + 1, ii).ravel()
        for ea, eb in ((f00, f10), (f10, f11), (f11, f01), (f01, f00)):
            tets.append(np.stack([c1, c2, ea, eb], axis=1))
        tets = np.concatenate(tets)

        # weld warped vertices that landed on (nearly) the same
        # surface point: distinct lattice vertices warping to one spot
        # would otherwise leave zero-thickness slivers between them
        wi = np.nonzero(warped)[0]
        if wi.size:
            qk = np.round(pts[wi] / (0.15 * cell)).astype(np.int64)
            key = (qk[:, 0] * 73856093) ^ (qk[:, 1] * 19349663) \
                ^ (qk[:, 2] * 83492791)
            _, first_idx, inv_w = np.unique(key, return_index=True,
                                            return_inverse=True)
            remap = np.arange(pts.shape[0])
            remap[wi] = wi[first_idx[inv_w]]
        else:
            remap = np.arange(pts.shape[0])

        ok = keep_v[tets].all(axis=1) & inside[tets].any(axis=1)
        tets = remap[tets[ok]]
        # degenerate after welding: repeated vertices in a tet
        distinct = ((tets[:, 0] != tets[:, 1])
                    & (tets[:, 0] != tets[:, 2])
                    & (tets[:, 0] != tets[:, 3])
                    & (tets[:, 1] != tets[:, 2])
                    & (tets[:, 1] != tets[:, 3])
                    & (tets[:, 2] != tets[:, 3]))
        tets = tets[distinct]
        # drop near-degenerate warped tets and orient consistently
        a = pts[tets[:, 0]]
        bb = pts[tets[:, 1]]
        cc = pts[tets[:, 2]]
        dd = pts[tets[:, 3]]
        vol6 = np.einsum("ij,ij->i", a - dd, np.cross(bb - dd, cc - dd))
        good = np.abs(vol6) > 2e-2 * cell ** 3
        tets = tets[good]
        flip = vol6[good] < 0
        tets[flip] = tets[flip][:, [0, 1, 3, 2]]

        # compact to used vertices
        used, inv = np.unique(tets.ravel(), return_inverse=True)
        tm = TetMesh(pts[used], inv.reshape(-1, 4))
        # sliver post-filter (pytetwild optimizes these away; dropping
        # them costs near-zero volume because slivers are thin)
        ang = tm.dihedral_angles()
        keep_t = ang.min(axis=1) >= 8.0
        if not keep_t.all():
            used2, inv2 = np.unique(tm.cells[keep_t].ravel(),
                                    return_inverse=True)
            tm = TetMesh(tm.points[used2], inv2.reshape(-1, 4))
        return tm

    def _create_voxel(self, edge_length):
        """Voxel-based tetrahedralization; `edge_length` is the fraction
        of the bounding-box diagonal used as the cell size (pytetwild's
        edge_length_fac semantics)."""
        b = self.surface_mesh.bounds
        diag = np.linalg.norm([b[1] - b[0], b[3] - b[2], b[5] - b[4]])
        cell = max(diag * edge_length, 1e-6)

        nx = max(2, int(np.ceil((b[1] - b[0]) / cell)) + 1)
        ny = max(2, int(np.ceil((b[3] - b[2]) / cell)) + 1)
        nz = max(2, int(np.ceil((b[5] - b[4]) / cell)) + 1)

        # inside test per grid node via per-slab polygon rasterization
        from ...ops.rasterize import fill_polygons_2d
        inside = np.zeros((nz, ny, nx), dtype=bool)
        for k in range(nz):
            z = b[4] + k * cell
            loops = self.surface_mesh.slice_plane([0, 0, 1],
                                                  [0, 0, z + 1e-6])
            if not loops:
                continue
            polys = [(np.asarray(lp)[:, :2]
                      - [b[0], b[2]]) / cell for lp in loops]
            inside[k] = fill_polygons_2d(polys, ny, nx,
                                        device="cpu").astype(bool)

        # build node ids for voxels whose 8 corners are inside
        node_id = -np.ones((nz + 1, ny + 1, nx + 1), dtype=np.int64)
        points = []
        cells = []

        def nid(i, j, k):
            if node_id[k, j, i] < 0:
                node_id[k, j, i] = len(points)
                points.append([b[0] + i * cell, b[2] + j * cell,
                               b[4] + k * cell])
            return node_id[k, j, i]

        occ = inside[:-1, :-1, :-1] & inside[1:, :-1, :-1] \
            & inside[:-1, 1:, :-1] & inside[:-1, :-1, 1:] \
            & inside[1:, 1:, :-1] & inside[1:, :-1, 1:] \
            & inside[:-1, 1:, 1:] & inside[1:, 1:, 1:]
        for k, j, i in np.argwhere(occ):
            corner_ids = [nid(i + dx, j + dy, k + dz)
                          for dx, dy, dz in _CUBE_OFFSETS]
            for tet in _TET_CORNERS:
                cells.append([corner_ids[t] for t in tet])

        self.mesh = TetMesh(np.asarray(points).reshape(-1, 3)
                            if points else np.zeros((0, 3)),
                            np.asarray(cells).reshape(-1, 4)
                            if cells else np.zeros((0, 4), np.int64))
        return self.mesh

    def write(self, path):
        self.mesh.save(path, binary=False)
