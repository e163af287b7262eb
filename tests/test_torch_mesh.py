"""The port's TriMesh (utils/mesh/trimesh.py) and smoothing
(utils/mesh/surface.py) against the JAX package's on the same meshes:

- volume, area, center, center of mass and bounds: 1e-9 relative;
- ``clean``, ``split_bodies``, ``slice_plane``, ``decimate`` (ACVD) and
  the grid ``cluster_decimate``, ``unique_inverse`` / ``unique_rows``,
  ``box_mesh``: equal;
- ``taubin_smooth``, ``constrained_smooth``, ``vertex_normals`` and
  ``Refinement.smooth`` (run on the device, here the CPU): 1e-9 mm, the
  umbrella sums' order aside.
"""

import numpy as np
import pytest
import torch

from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops.marching_cubes import marching_cubes_mask
from medicalimageanalysis_torch.utils.mesh import surface as tsurf
from medicalimageanalysis_torch.utils.mesh import trimesh as ttri
from medicalimageanalysis_tpu.utils.mesh import surface as jsurf
from medicalimageanalysis_tpu.utils.mesh import trimesh as jtri


@pytest.fixture(autouse=True)
def torch_env():
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    set_default_device(None)


def lattice_mesh(kind):
    """A marching-tetrahedra surface in mm (the meshes the ROI path
    makes): two blobs, or a torus."""
    zz, yy, xx = np.mgrid[0:16, 0:24, 0:26].astype(np.float64)
    if kind == "two_blobs":
        m = ((zz - 7) ** 2 + (yy - 8) ** 2 + (xx - 7) ** 2 < 30) \
            | ((zz - 8) ** 2 / 2 + (yy - 16) ** 2 + (xx - 18) ** 2 < 20)
    else:
        rho = np.sqrt((yy - 12) ** 2 + (xx - 13) ** 2)
        m = (rho - 7.0) ** 2 + ((zz - 8) * 1.2) ** 2 < 7.0
    mesh = marching_cubes_mask(m.astype(np.uint8))
    mesh.points = mesh.points * [0.8, 0.9, 2.0] + [-10.0, 5.0, -40.0]
    return mesh


def pair(kind):
    t = lattice_mesh(kind)
    return t, jtri.TriMesh(t.points.copy(), t.faces.copy())


def same(t, j, atol=0.0):
    assert t.points.shape == j.points.shape
    np.testing.assert_array_equal(t.faces, j.faces)
    np.testing.assert_allclose(t.points, j.points, rtol=0, atol=atol)


@pytest.mark.parametrize("kind", ["two_blobs", "torus"])
def test_properties_match_jax(kind):
    t, j = pair(kind)
    for key in ("volume", "area"):
        np.testing.assert_allclose(getattr(t, key), getattr(j, key),
                                   rtol=1e-9)
    for key in ("center", "center_of_mass", "bounds"):
        np.testing.assert_allclose(getattr(t, key), getattr(j, key),
                                   rtol=1e-9)
    assert t.GetBounds() == j.GetBounds()
    assert (t.number_of_points, t.n_points, t.number_of_faces, t.n_cells) \
        == (j.number_of_points, j.n_points, j.number_of_faces, j.n_cells)
    M = np.eye(4)
    M[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    M[:3, 3] = [3.0, -2.0, 7.5]
    same(t.transform(M, inplace=False), j.transform(M, inplace=False))


@pytest.mark.parametrize("kind", ["two_blobs", "torus"])
def test_clean_split_and_slice_match_jax(kind):
    t, j = pair(kind)
    # a soup with duplicated vertices and a degenerate face
    soup_pts = t.points[t.faces].reshape(-1, 3)
    soup_faces = np.arange(soup_pts.shape[0]).reshape(-1, 3)
    soup_faces = np.concatenate([soup_faces, [[0, 0, 1]]])
    for tol in (1e-9, 1e-7):
        same(ttri.TriMesh(soup_pts, soup_faces).clean(tol),
             jtri.TriMesh(soup_pts, soup_faces).clean(tol))
    tb, jb = t.split_bodies(), j.split_bodies()
    assert len(tb) == len(jb) == (2 if kind == "two_blobs" else 1)
    for a, b in zip(tb, jb):
        same(a, b)
    c = t.center
    for normal, origin in (("z", [c[0], c[1], c[2] + 0.3]),
                           ([0.2, 1.0, 0.1], c),
                           ([1.0, 0.0, 0.0], [c[0] - 2.55, 0, 0])):
        tl, jl = t.slice_plane(normal, origin), j.slice_plane(normal, origin)
        assert len(tl) == len(jl) > 0
        for a, b in zip(tl, jl):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.slice("z", c).points,
                                  j.slice("z", c).points)


@pytest.mark.parametrize("kind", ["two_blobs", "torus"])
def test_decimation_matches_jax(kind):
    t, j = pair(kind)
    same(t.decimate(0.7), j.decimate(0.7))
    same(t.cluster_decimate(200, method="grid"),
         j.cluster_decimate(200, method="grid"))
    tr, jr = tsurf.Refinement(t), jsurf.Refinement(j)
    assert tr.compute_points() == jr.compute_points()
    assert tr.compute_point_percentage() == jr.compute_point_percentage()
    same(tr.decimate(), jr.decimate())
    same(tsurf.Refinement(t).cluster(150), jsurf.Refinement(j).cluster(150))


def test_unique_helpers_and_box_match_jax():
    r = np.random.default_rng(2)
    keys = r.integers(-50, 50, 400)
    for a, b in zip(ttri.unique_inverse(keys, return_index=True),
                    jtri.unique_inverse(keys, return_index=True)):
        np.testing.assert_array_equal(a, b)
    rows = r.integers(0, 4, (300, 3))
    for a, b in zip(ttri.unique_rows(rows), jtri.unique_rows(rows)):
        np.testing.assert_array_equal(a, b)
    same(ttri.box_mesh([-1, -2, -3], [4, 5, 6]),
         jtri.box_mesh([-1, -2, -3], [4, 5, 6]))


@pytest.mark.parametrize("kind", ["two_blobs", "torus"])
def test_smoothing_matches_jax(kind):
    t, j = pair(kind)
    for it, pb in ((20, 0.001), (7, 0.1)):
        same(tsurf.taubin_smooth(t, iterations=it, passband=pb),
             jsurf.taubin_smooth(j, iterations=it, passband=pb), atol=1e-9)
    for it, rel, dist in ((20, 0.5, 1), (9, 0.3, 0.25)):
        same(tsurf.constrained_smooth(t, it, rel, dist),
             jsurf.constrained_smooth(j, it, rel, dist), atol=1e-9)
    np.testing.assert_allclose(tsurf.vertex_normals(t),
                               jsurf.vertex_normals(j), rtol=0, atol=1e-9)
    same(tsurf.Refinement(t).smooth(), jsurf.Refinement(j).smooth(),
         atol=1e-9)
    smoothed = tsurf.taubin_smooth(t)
    assert np.abs(smoothed.points - t.points).max() > 0.05
    empty = ttri.TriMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int32))
    assert tsurf.taubin_smooth(empty).number_of_points == 0
    assert tsurf.constrained_smooth(empty).number_of_points == 0
