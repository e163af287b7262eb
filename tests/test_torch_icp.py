"""ICP through both packages, on the CPU: the nearest-neighbour scan,
Kabsch, the point-to-point and point-to-plane loops and their batches
(ops/registration/icp.py), the ``ICP`` class (utils/rigid/icp.py) and
``Rigid.compute_icp_vtk`` / ``compute_o3d``, on the fixtures of
tests/test_rigid.py and tests/test_parallel.py.

Tolerances:
- nearest-neighbour indices bit-equal, ties included (the first index
  wins, across and within the scan's chunks); squared distances within
  1e-4 relative (float32 matmuls in both);
- Kabsch within 1e-5;
- ICP results within 1e-4 mm of vertex motion (the source points moved
  by the port's matrix and by the JAX package's differ by at most that),
  except at two float32 floors that the JAX package's own result does
  not get past:
  - a loop that ends because its RMS distance turned NaN (every point on
    its target, |s|^2 - 2 s.t + |t|^2 slightly negative) ends one step
    earlier or later in one package: 5e-4 mm (FLOOR_TOL_MM; the JAX
    package's sphere fit stops 3e-4 mm from the true motion);
  - point-to-point on a marching-cubes lattice, where many target points
    lie at exactly equal distances and rounding picks among them: the
    JAX package's own fixed point moves by 1e-3 mm between its
    iterations 20, 60 and 200, so 2e-3 mm (LATTICE_TOL_MM);
  fitness and inlier RMSE within 5e-4.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops.registration import icp as ticp
from medicalimageanalysis_torch.utils.mesh.trimesh import TriMesh as TMesh
from medicalimageanalysis_torch.utils.rigid.icp import ICP as TICP
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.ops.registration import icp as jicp
from medicalimageanalysis_tpu.utils.mesh.trimesh import TriMesh as JMesh
from medicalimageanalysis_tpu.utils.rigid.icp import ICP as JICP

MOTION_TOL_MM = 1e-4
FLOOR_TOL_MM = 5e-4
LATTICE_TOL_MM = 2e-3


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    JData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    JData.clear()
    set_default_device(None)


def sphere_points(n=1500, radius=40.0, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * radius * np.array([1.0, 0.7, 1.3])


def moved(points, angles, t):
    R = Rotation.from_euler("xyz", angles, degrees=True).as_matrix()
    return points @ R.T + np.asarray(t)


def assert_same_motion(points, m, jm, tol=MOTION_TOL_MM):
    a = points @ np.asarray(m)[:3, :3].T + np.asarray(m)[:3, 3]
    b = points @ np.asarray(jm)[:3, :3].T + np.asarray(jm)[:3, 3]
    assert np.abs(a - b).max() <= tol, np.abs(a - b).max()


def notched_box_mesh():
    """tests/test_rigid.py's point-to-plane surface: a notched box's
    marching-cubes mesh (the JAX package's)."""
    from medicalimageanalysis_tpu.ops.marching_cubes import (
        marching_cubes_mask)
    mask = np.zeros((16, 20, 24), np.uint8)
    mask[4:12, 5:15, 6:18] = 1
    mask[6:10, 8:12, 10:14] = 0
    m = marching_cubes_mask(mask)
    return np.asarray(m.points, np.float64), np.asarray(m.faces, np.int32)


@pytest.mark.parametrize("n_src,n_tgt", [(300, 500), (700, 5000),
                                         (64, 4097)])
def test_nearest_neighbors_match_jax(n_src, n_tgt):
    rng = np.random.default_rng(n_tgt)
    tgt = rng.uniform(-50, 50, (n_tgt, 3)).astype(np.float32)
    # exact ties: copies of target points later in the same chunk and in
    # later chunks; sources on some of the tied points
    tgt[n_tgt - 1] = tgt[3]
    tgt[min(2100, n_tgt - 2)] = tgt[5]
    tgt[7] = tgt[6]
    src = np.concatenate([
        rng.uniform(-55, 55, (n_src - 4, 3)).astype(np.float32),
        tgt[[3, 5, 6, 7]]])
    idx, d2 = ticp.nearest_neighbors(src, tgt, device="cpu")
    jidx, jd2 = jicp.nearest_neighbors(src, tgt)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_allclose(d2, np.asarray(jd2), rtol=1e-4, atol=1e-3)
    assert list(idx[-4:]) == [3, 5, 6, 6]


def test_kabsch_matches_jax():
    rng = np.random.default_rng(3)
    src = rng.normal(size=(50, 3)).astype(np.float32)
    tgt = moved(src, [10, -5, 20], [4.0, -2.0, 7.0])
    m = ticp.kabsch(src, tgt, device="cpu").numpy()
    np.testing.assert_allclose(m, np.asarray(jicp.kabsch(src, tgt)),
                               atol=1e-5)
    w = (rng.uniform(size=50) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        ticp.kabsch(src, tgt, weights=w, device="cpu").numpy(),
        np.asarray(jicp.kabsch(src, tgt, weights=w)), atol=1e-5)


@pytest.mark.parametrize("kw,tol", [
    (dict(distance=1e-7, iterations=100, landmarks=400), FLOOR_TOL_MM),
    (dict(distance=1e-7, iterations=5, landmarks=400), MOTION_TOL_MM),
    (dict(distance=1e-5, iterations=30), MOTION_TOL_MM),
    (dict(distance=1e-7, iterations=100, com_matching=False), MOTION_TOL_MM),
    (dict(distance=1e-7, iterations=40, landmarks=1500,
          init_matrix=np.diag([1.0, 1.0, 1.0, 1.0])), MOTION_TOL_MM)],
    ids=["landmarks_400", "landmarks_400_five_steps", "default_landmarks",
         "no_com", "init_matrix"])
def test_icp_rigid_matches_jax(kw, tol):
    src = sphere_points()
    tgt = moved(src, [4, -3, 6], [5.0, -8.0, 3.0])
    m, info = ticp.icp_rigid(src, tgt, device="cpu", **kw)
    jm, jinfo = jicp.icp_rigid(src, tgt, **kw)
    assert m.dtype == np.float64 and m.shape == (4, 4)
    assert info["landmarks"] == jinfo["landmarks"]
    assert info["iterations"] >= 1
    if tol == MOTION_TOL_MM and kw["iterations"] < 10:
        assert info["iterations"] == jinfo["iterations"]
    assert_same_motion(src, m, jm, tol)


def test_icp_point_to_plane_matches_jax():
    pts, faces = notched_box_mesh()
    tgt = moved(pts, [2, -3, 4], [1.5, -2.0, 1.0])
    from medicalimageanalysis_torch.utils.mesh.surface import vertex_normals
    normals = vertex_normals(TMesh(tgt, faces), device="cpu")
    m, info = ticp.icp_point_to_plane(pts, tgt, normals, iterations=60,
                                      device="cpu")
    jm, jinfo = jicp.icp_point_to_plane(pts, tgt, normals, iterations=60)
    assert_same_motion(pts, m, jm)
    out = pts @ m[:3, :3].T + m[:3, 3]
    assert np.sqrt(np.mean(np.sum((out - tgt) ** 2, axis=1))) < 0.3


def test_icp_batches_match_jax():
    """tests/test_parallel.py's batch: three poses of one cloud, each pair
    against its single loop."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=(600, 3)) * [30, 20, 40]
    sources = np.stack([base] * 3)
    targets = np.stack([moved(base, rng.uniform(-5, 5, 3),
                              rng.uniform(-8, 8, 3)) for _ in range(3)])
    ms, rms = ticp.icp_rigid_batch(sources, targets, distance=1e-7,
                                   iterations=100, device="cpu")
    jms, jrms = jicp.icp_rigid_batch(sources, targets, distance=1e-7,
                                     iterations=100)
    assert ms.shape == (3, 4, 4) and rms.shape == (3,)
    for b in range(3):
        assert_same_motion(base, ms[b], jms[b], FLOOR_TOL_MM)
    ok = np.isfinite(np.asarray(jrms))
    np.testing.assert_allclose(rms[ok], np.asarray(jrms)[ok], atol=1e-4)
    # point-to-plane: three poses of the notched box with its normals
    from medicalimageanalysis_torch.utils.mesh.surface import vertex_normals
    pts, faces = notched_box_mesh()
    sources = np.stack([pts] * 3)
    targets = np.stack([moved(pts, rng.uniform(-4, 4, 3),
                              rng.uniform(-2, 2, 3)) for _ in range(3)])
    normals = np.stack([vertex_normals(TMesh(t, faces), device="cpu")
                        for t in targets])
    ms, _ = ticp.icp_point_to_plane_batch(sources, targets, normals,
                                          iterations=30, device="cpu")
    jms, _ = jicp.icp_point_to_plane_batch(sources, targets, normals,
                                           iterations=30)
    for b in range(3):
        assert_same_motion(pts, ms[b], jms[b], FLOOR_TOL_MM)


@pytest.mark.parametrize("call,tol", [
    (("compute_vtk", dict(distance=1e-7, iterations=50)), MOTION_TOL_MM),
    (("compute_vtk", dict(distance=1e-7, iterations=50, inverse=True)),
     MOTION_TOL_MM),
    (("compute_o3d", dict(iterations=40)), LATTICE_TOL_MM),
    (("compute_o3d", dict(iterations=40, method="plane")), FLOOR_TOL_MM),
    (("compute_o3d", dict(iterations=40, method="plane", faces=False)),
     FLOOR_TOL_MM)],
    ids=["vtk", "vtk_inverse", "o3d_point", "o3d_plane_mesh",
         "o3d_plane_cloud"])
def test_icp_class_matches_jax(call, tol):
    name, kw = call
    kw = dict(kw)
    faces_too = kw.pop("faces", True)
    pts, faces = notched_box_mesh()
    if not faces_too:
        faces = np.zeros((0, 3), np.int32)
    tgt = moved(pts, [2, -3, 4], [3.0, 1.0, -2.0])
    t = TICP(TMesh(pts, faces), TMesh(tgt, faces), device="cpu")
    j = JICP(JMesh(pts, faces), JMesh(tgt, faces))
    getattr(t, name)(**kw)
    getattr(j, name)(**kw)
    assert_same_motion(pts, t.get_matrix(), j.get_matrix(), tol)
    for key in ("fitness", "inlier_rmse"):
        if key in j.info:
            assert abs(t.info[key] - j.info[key]) < FLOOR_TOL_MM, key
    np.testing.assert_array_equal(t.get_correspondence_set(),
                                  np.asarray(j.get_correspondence_set()))
    t.compute_com()
    j.compute_com()
    np.testing.assert_allclose(t.get_matrix(), j.get_matrix(), atol=1e-12)


@pytest.fixture
def two_images(tmp_path):
    rng = np.random.default_rng(1234)
    base = np.zeros((12, 32, 32), np.float32)
    zz, yy, xx = np.mgrid[0:12, 0:32, 0:32]
    base += 800 * np.exp(-(((zz - 6) / 3.0) ** 2 + ((yy - 14) / 6.0) ** 2
                           + ((xx - 18) / 5.0) ** 2))
    base += rng.normal(0, 5, base.shape)
    write_ct_series(tmp_path / "a", base.astype(np.int16), spacing=(1, 1),
                    thickness=2.0)
    write_ct_series(tmp_path / "b", np.roll(base, 2, 2).astype(np.int16),
                    spacing=(1, 1), thickness=2.0, modality="MR")
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    ct = [n for n in JData.image_list if JData.image[n].modality == "CT"][0]
    mr = [n for n in JData.image_list if JData.image[n].modality == "MR"][0]
    return ct, mr


@pytest.mark.parametrize("method,kw,tol", [
    ("compute_icp_vtk", dict(distance=1e-7, iterations=60), MOTION_TOL_MM),
    ("compute_icp_vtk", dict(distance=1e-7, iterations=60,
                             center="image"), MOTION_TOL_MM),
    ("compute_icp_vtk", dict(distance=1e-7, iterations=60, inverse=True),
     MOTION_TOL_MM),
    ("compute_o3d", dict(iterations=60, method="point"), LATTICE_TOL_MM),
    ("compute_o3d", dict(iterations=60, method="plane", center="image"),
     FLOOR_TOL_MM)],
    ids=["vtk", "vtk_center_image", "vtk_inverse", "o3d_point",
         "o3d_plane_center_image"])
def test_rigid_mesh_icp_matches_jax(two_images, method, kw, tol):
    """Rigid's mesh ICP entry points: the target mesh moved through the
    current matrix, the ICP, the image-centre correction, update_rois."""
    ct, mr = two_images
    pts, faces = notched_box_mesh()
    pts = pts + [-95.0, -115.0, -48.0]
    tgt = moved(pts - pts.mean(0), [2, -3, 4], [1.5, -2.0, 1.0]) \
        + pts.mean(0)
    t, j = tmia.Rigid(ct, mr), jmia.Rigid(ct, mr)
    start = np.eye(4)
    start[:3, 3] = [0.5, -0.25, 0.0]
    t.matrix, j.matrix = start.copy(), start.copy()
    t_target, j_target = TMesh(tgt, faces), JMesh(tgt, faces)
    getattr(t, method)(TMesh(pts, faces), t_target, **kw)
    getattr(j, method)(JMesh(pts, faces), j_target, **kw)
    np.testing.assert_allclose(t_target.points, j_target.points,
                               atol=1e-12)
    assert_same_motion(pts, t.matrix, j.matrix, tol)
    assert t.inverse == j.inverse
