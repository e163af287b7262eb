"""Mesh repair and refinement in both packages on the CPU, on
marching-tetrahedra balls, a kidney bean and boxes (the fixtures of
tests/test_mesh_utils.py): ``clean_mesh`` (a centroid fan for a small
hole, ear clipping for a large one), ``only_main_component``,
``expansion`` with and without the self-intersection repair,
``find_self_intersections`` / ``remove_self_intersections`` on two
interpenetrating balls, ``surface_boundary``, and ``Refinement``'s
``tri_split``, ``advanced_split``, ``find_face_correction`` and
``compute_midpoints``.

Tolerances, stated per check:
- host code (welding, hole fills, component split, the intersection
  search, the face splits, the midpoints): vertex and face arrays equal
  to the JAX package's;
- where the port runs an array program over points or edges on the
  device (``expansion``'s vertex normals, the repair's relaxation of its
  patches): faces equal, vertices within 1e-9 mm, the ``index_add_``
  order deciding the last bits.
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.utils.mesh import surface as ts
from medicalimageanalysis_torch.utils.mesh.trimesh import TriMesh as TMesh
from medicalimageanalysis_torch.utils.mesh.trimesh import box_mesh as t_box
from medicalimageanalysis_tpu.ops.marching_cubes import marching_cubes_mask
from medicalimageanalysis_tpu.utils.mesh import surface as js
from medicalimageanalysis_tpu.utils.mesh.trimesh import TriMesh as JMesh


@pytest.fixture(autouse=True)
def torch_env():
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    set_default_device(None)


def ball_mask(r=6, n=16, shift=(0.0, 0.0, 0.0)):
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n]
    c = n / 2 - 0.5
    return (((zz - c - shift[0]) ** 2 + (yy - c - shift[1]) ** 2
             + (xx - c - shift[2]) ** 2) <= r * r).astype(np.uint8)


def pair(mesh):
    """The same mesh as the port's and the JAX package's TriMesh."""
    return (TMesh(mesh.points.copy(), mesh.faces.copy()),
            JMesh(mesh.points.copy(), mesh.faces.copy()))


def ball(r=6, n=16):
    return pair(marching_cubes_mask(ball_mask(r, n)))


def bean():
    n = 22
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n]
    c = n / 2 - 0.5
    mask = ((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2
            <= 8 ** 2).astype(np.uint8)
    mask[(zz - c) ** 2 + (yy - (c + 7)) ** 2 + (xx - c) ** 2 <= 5 ** 2] = 0
    return pair(js.taubin_smooth(marching_cubes_mask(mask), iterations=30,
                                 passband=0.1))


def overlapping_balls():
    s = marching_cubes_mask(ball_mask(5, 14))
    p2 = s.points + np.array([4.37, 0.21, 0.13])   # off-lattice overlap
    return pair(JMesh(np.concatenate([s.points, p2]),
                      np.concatenate([s.faces, s.faces + s.n_points])))


def same(t, j, atol=0.0):
    assert type(t) is TMesh
    assert t.points.shape == j.points.shape
    np.testing.assert_array_equal(t.faces, j.faces)
    if atol:
        np.testing.assert_allclose(t.points, j.points, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(t.points, j.points)


@pytest.mark.parametrize("drop", ["one_face", "large_hole", "none"])
def test_clean_mesh_matches_jax(drop):
    """A box short one face (a 3-edge hole: the centroid fan) and a ball
    with a cap cut off (a loop of more than 8 edges: ear clipping)."""
    if drop == "one_face":
        t, j = pair(JMesh(t_box([0, 0, 0], [4, 4, 4]).points,
                          t_box([0, 0, 0], [4, 4, 4]).faces[:-1]))
    else:
        t, j = ball()
        if drop == "large_hole":
            keep = t.points[t.faces].mean(axis=1)[:, 2] < 11.5
            t, j = pair(JMesh(t.points, t.faces[keep]))
            assert len(js._boundary_loops(j)[0]) > 8
    out_t, out_j = ts.clean_mesh(t), js.clean_mesh(j)
    same(out_t, out_j)
    assert len(ts._boundary_loops(out_t)) == 0


def test_only_main_component_matches_jax():
    small = marching_cubes_mask(ball_mask(3, 16, shift=(0, 0, 0)))
    big = marching_cubes_mask(ball_mask(5, 16))
    far = big.points + [40.0, 0.0, 0.0]
    t, j = pair(JMesh(np.concatenate([small.points, far]),
                      np.concatenate([small.faces,
                                      big.faces + small.n_points])))
    out_t, out_j = ts.only_main_component(t), js.only_main_component(j)
    same(out_t, out_j)
    assert out_t.n_points == big.n_points
    single, _ = ball()
    assert ts.only_main_component(single) is single


@pytest.mark.parametrize("fix", [False, True])
def test_expansion_matches_jax(fix):
    t, j = bean()
    out_t = ts.expansion(t, 1.0, fix_intersections=fix)
    out_j = js.expansion(j, 1.0, fix_intersections=fix)
    same(out_t, out_j, atol=1e-9)
    assert out_t.volume > t.volume
    if fix:
        assert ts.find_self_intersections(out_t).size == 0


def test_self_intersections_found_and_removed_like_jax():
    t, j = overlapping_balls()
    bad_t, bad_j = ts.find_self_intersections(t), js.find_self_intersections(j)
    np.testing.assert_array_equal(bad_t, bad_j)
    assert bad_t.size > 0
    fixed_t = ts.remove_self_intersections(t)
    fixed_j = js.remove_self_intersections(j)
    same(fixed_t, fixed_j, atol=1e-9)
    assert ts.find_self_intersections(fixed_t).size == 0
    assert len(ts._boundary_loops(fixed_t)) == 0
    clean, _ = ball(5, 14)
    assert ts.find_self_intersections(clean).size == 0


def test_surface_boundary_matches_jax():
    (a_t, a_j), (b_t, b_j) = ball(), ball(r=5)
    matrix = np.eye(4)
    matrix[:3, 3] = [1.0, -2.0, 0.5]
    src_t, tgt_t = ts.surface_boundary([a_t], [b_t], [80], matrix)
    src_j, tgt_j = js.surface_boundary([a_j], [b_j], [80], matrix)
    same(src_t[0], src_j[0])
    same(tgt_t[0], tgt_j[0])
    assert src_t[0].n_points == tgt_t[0].n_points


def test_refinement_face_tables_match_jax():
    t, j = ball()
    rt, rj = ts.Refinement(t), js.Refinement(j)
    for key in ("points", "face", "face_centers", "face_lines_sort",
                "face_lines"):
        np.testing.assert_array_equal(getattr(rt, key), getattr(rj, key))
    rt.find_face_correction()
    rj.find_face_correction()
    np.testing.assert_array_equal(rt.correct_faces, rj.correct_faces)
    assert len(rt.correct_faces) == t.n_points // 4


@pytest.mark.parametrize("method,kw", [("tri_split", {}),
                                       ("advanced_split",
                                        {"area_factor": 1.2})])
def test_refinement_splits_match_jax(method, kw):
    t, j = ball()
    out_t = getattr(ts.Refinement(t), method)(**kw)
    out_j = getattr(js.Refinement(j), method)(**kw)
    same(out_t, out_j)
    assert out_t.n_cells > t.n_cells


def test_advanced_split_on_uneven_faces_matches_jax():
    """A box's twelve large faces beside a ball's small ones: several
    rounds of splitting the faces above twice the mean area."""
    b = t_box([20, 0, 0], [34, 14, 14])
    s = marching_cubes_mask(ball_mask())
    t, j = pair(JMesh(np.concatenate([s.points, b.points]),
                      np.concatenate([s.faces, b.faces + s.n_points])))
    for kw in ({}, {"area_factor": 1.5, "max_rounds": 3}):
        same(ts.Refinement(t).advanced_split(**kw),
             js.Refinement(j).advanced_split(**kw))


def test_compute_midpoints_matches_jax():
    t, j = ball()
    mids_t, edges_t = ts.Refinement(t).compute_midpoints()
    mids_j, edges_j = js.Refinement(j).compute_midpoints()
    np.testing.assert_array_equal(mids_t, mids_j)
    np.testing.assert_array_equal(edges_t, edges_j)
    assert edges_t.dtype == np.int64 and len(edges_t) > 0
    np.testing.assert_allclose(
        mids_t, (t.points[edges_t[:, 0]] + t.points[edges_t[:, 1]]) / 2,
        rtol=0, atol=1e-12)


def test_repair_names_are_the_utils_exports():
    for name in ("clean_mesh", "expansion", "surface_boundary",
                 "only_main_component"):
        assert getattr(tmia.utils, name) is getattr(ts, name)
        assert getattr(tmia, name) is getattr(ts, name)
