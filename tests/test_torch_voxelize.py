"""Mesh voxelization by ray parity in both packages on the CPU: the port's
device path (ops/voxelize, plain PyTorch, run on the CPU) and its host
float64 twin (utils/convert/voxelize) against the JAX package's host twin
and its XLA device path, on the fixtures of tests/test_mesh_utils.py
(a marching-cubes blob in all three planes, a box of faces wider than 32
pixels, a mixed face soup, flat caps at integer heights, an empty mesh,
a batch), then a mesh-only ROI's mask, its DVH goals and the mask cache.

Tolerance: every mask bit-equal. The only place the device path may part
from the float64 twin is a voxel center that lies on the surface (a
crossing height within float32 rounding of an integer, a ray within a
vertex's float32 cast of an edge); none of these fixtures has one, and
the tests hold that. One difference from the JAX package is pinned: a
ray exactly on an edge two faces share is claimed by one of them in both
of the port's paths, by neither in both of the JAX package's
(``test_a_ray_on_a_shared_edge_is_claimed_once``; ROADMAP.md queue 3).
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from medicalimageanalysis_torch import interop
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import voxelize as tvox
from medicalimageanalysis_torch.utils.convert.voxelize import (
    voxelize_mesh as t_voxelize_mesh)
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.ops import voxelize as jvox
from medicalimageanalysis_tpu.ops.marching_cubes import mask_to_mesh
from medicalimageanalysis_tpu.utils import dose as jdose
from medicalimageanalysis_tpu.utils.convert.voxelize import (
    voxelize_mesh as j_voxelize_mesh)
from medicalimageanalysis_tpu.utils.mesh.trimesh import TriMesh as JTriMesh
from test_torch_dose import write_case

DIMS = (20, 28, 24)
PLANES = ("Axial", "Coronal", "Sagittal")
BOX_FACES = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                      [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                      [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])


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


def blob_mesh(dims=DIMS, center=(10, 14, 12), radii=(7, 10, 8)):
    zz, yy, xx = np.mgrid[0:dims[0], 0:dims[1], 0:dims[2]].astype(
        np.float64)
    blob = (((zz - center[0]) / radii[0]) ** 2
            + ((yy - center[1]) / radii[1]) ** 2
            + ((xx - center[2]) / radii[2]) ** 2) <= 1.0
    mesh = mask_to_mesh(blob.astype(np.uint8), [1.0, 1.0, 1.0],
                        [0.0, 0.0, 0.0], np.eye(3))
    return np.asarray(mesh.points, np.float64), np.asarray(mesh.faces)


def box(lo, hi):
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    return np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0],
                     [x0, y1, z0], [x0, y0, z1], [x1, y0, z1],
                     [x1, y1, z1], [x0, y1, z1]], np.float64)


def all_equal(pts, faces, dims, plane="Axial"):
    """The port's device path (on the CPU) and host twin, the JAX host
    twin and the JAX device path: one mask. Returns it and the port's
    stats."""
    stats = {}
    gold = j_voxelize_mesh(pts, faces, dims, plane=plane, backend="host")
    dev = tvox.voxelize_mesh_device(pts, faces, dims, plane=plane,
                                    device="cpu", stats=stats)
    assert dev.dtype == np.uint8 and dev.shape == tuple(dims)
    np.testing.assert_array_equal(dev, gold, err_msg=plane)
    np.testing.assert_array_equal(
        t_voxelize_mesh(pts, faces, dims, plane=plane, backend="host"),
        gold)
    np.testing.assert_array_equal(
        t_voxelize_mesh(pts, faces, dims, plane=plane), gold)
    np.testing.assert_array_equal(
        jvox.voxelize_mesh_device(pts, faces, dims, plane=plane), gold)
    return gold, stats


@pytest.mark.parametrize("plane", PLANES)
def test_blob_matches_host_twin_and_jax(plane):
    pts, faces = blob_mesh()
    gold, stats = all_equal(pts, faces, DIMS, plane)
    assert gold.sum() > 100
    assert stats["big_faces"] == 0 and stats["pairs"] > 0


@pytest.mark.parametrize("plane", PLANES)
def test_big_faces_take_the_host_term(plane):
    """Twelve triangles wider than 32 pixels: the host parity term,
    XORed into the (empty) device canvas."""
    dims = (24, 48, 44)
    gold, stats = all_equal(box([2.2, 2.2, 2.3], [41.5, 45.4, 21.6]),
                            BOX_FACES, dims, plane)
    assert gold.sum() > 10000
    assert stats["big_faces"] > 0


@pytest.mark.parametrize("plane", PLANES)
def test_mixed_face_soup(plane):
    """A big box and a blob in one face soup: the size classes and the
    host term combine by XOR."""
    dims = (24, 48, 44)
    pts, faces = blob_mesh(dims, (12, 20, 18), (8, 12, 10))
    corners = box([2.2, 2.2, 2.3], [41.5, 45.4, 21.6])
    soup_pts = np.concatenate([corners + [0.1, 0.2, 0.0], pts])
    soup_faces = np.concatenate([BOX_FACES, faces + 8])
    gold, stats = all_equal(soup_pts, soup_faces, dims, plane)
    assert stats["big_faces"] > 0 and stats["pairs"] > 0
    assert gold.sum() > 1000


@pytest.mark.parametrize("plane", PLANES)
def test_integer_height_caps(plane):
    """Flat caps at integer heights: crossings exactly on voxel centers,
    where the device's tie rule must give the twin's floor(wc - 1e-9)."""
    corners = box([2.2, 2.2, 2.0], [21.5, 25.4, 7.0])
    gold, _ = all_equal(corners, BOX_FACES, DIMS, plane)
    assert gold.sum() > 1000


@pytest.mark.parametrize("plane", PLANES)
def test_a_ray_on_a_shared_edge_is_claimed_once(plane):
    """A box whose caps are split along their diagonals, placed so the
    diagonals pass exactly through 8 ray columns once the rays' eps
    shift is taken off (u = v on the diagonal, in float32 and float64):
    each ray crosses the cap on the edge the two cap triangles share. The
    port's device path and host twin claim each crossing once and fill
    the box (8 x 8 x 5 voxels in the Axial plane, where the rays meet
    the caps); the JAX package's twin and XLA path claim none of those 8
    crossings and leave 8 columns of 5 voxels out. In the other planes
    no ray meets a diagonal and the four paths agree."""
    lo = [2.5 + 1e-4, 2.5 + 2.3e-4, 2.5]
    hi = [10.5 + 1e-4, 10.5 + 2.3e-4, 7.5]
    dims = (12, 14, 14)
    box_pts = box(lo, hi)
    want = np.zeros(dims, np.uint8)
    want[3:8, 3:11, 3:11] = 1
    port = tvox.voxelize_mesh_device(box_pts, BOX_FACES, dims, plane=plane,
                                     device="cpu")
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(
        t_voxelize_mesh(box_pts, BOX_FACES, dims, plane=plane,
                        backend="host"), want)
    jax_host = j_voxelize_mesh(box_pts, BOX_FACES, dims, plane=plane,
                               backend="host")
    jax_device = jvox.voxelize_mesh_device(box_pts, BOX_FACES, dims,
                                           plane=plane)
    lost = 40 if plane == "Axial" else 0
    for got in (jax_host, jax_device):
        assert int((got != want).sum()) == lost
        assert not (got & (1 - want)).any()


def test_empty_mesh():
    for fn in (tvox.voxelize_mesh_device, jvox.voxelize_mesh_device):
        kw = {"device": "cpu"} if fn is tvox.voxelize_mesh_device else {}
        out = fn(np.zeros((0, 3)), np.zeros((0, 3), int), DIMS, **kw)
        assert out.shape == DIMS and out.sum() == 0
    assert tvox.voxelize_batch([], DIMS, device="cpu").shape == (0,) + DIMS


@pytest.mark.parametrize("plane", PLANES)
def test_batch_matches_per_mesh_and_jax(plane):
    """Three blobs and a box in one pooled pass, each equal to its own
    host twin; the tensor stays on the device with as_numpy=False."""
    dims = (14, 24, 26)
    meshes = [blob_mesh(dims, (7, 12, 11 + b), (4 + b, 7, 6))
              for b in range(3)]
    meshes.append((box([2.2, 2.2, 2.3], [21.5, 20.4, 11.6]), BOX_FACES))
    out = tvox.voxelize_batch(meshes, dims, plane=plane, device="cpu")
    assert out.shape == (4,) + dims
    for b, (p, f) in enumerate(meshes):
        np.testing.assert_array_equal(
            out[b], j_voxelize_mesh(p, f, dims, plane=plane,
                                    backend="host"))
    np.testing.assert_array_equal(
        out, jvox.voxelize_batch(meshes, dims, plane=plane))
    on_device = tvox.voxelize_batch(meshes, dims, plane=plane,
                                    as_numpy=False, device="cpu")
    assert isinstance(on_device, torch.Tensor)
    np.testing.assert_array_equal(on_device.numpy(), out)


def test_chunked_key_pass_is_the_same(monkeypatch):
    """The key pass split into chunks of a few faces adds the same keys."""
    pts, faces = blob_mesh()
    whole = tvox.voxelize_mesh_device(pts, faces, DIMS, device="cpu")
    monkeypatch.setattr(tvox, "_CHUNK_ELEMENTS", 64)
    np.testing.assert_array_equal(
        tvox.voxelize_mesh_device(pts, faces, DIMS, device="cpu"), whole)


@pytest.mark.parametrize("n,crop", [(12, (0, 100, 0, 100, 50)),
                                    (9, (0, 511, 0, 511, 127)),
                                    (20, (0, 1023, 0, 1023, 511))])
def test_sub_batches_guard_the_int32_key_space(n, crop):
    """The port splits a batch where the JAX package does: at most 8
    meshes, and B * Hc * Wc * Sc + 1 below 2^31."""
    S, H, W = 512, 1024, 1024
    preps = [{"crop": crop} for _ in range(n)]
    spans = tvox._greedy_chunks(preps, S, H, W)
    assert spans == jvox._greedy_chunks(preps, S, H, W)
    for i, j in spans:
        Hc, Wc, Sc = tvox._chunk_dims([crop], S, H, W)
        assert j - i <= tvox._MAX_CHUNK
        assert (j - i) * Hc * Wc * Sc + 1 < 2**31


def mesh_only_case(tmp_path):
    """test_torch_dose.py's CT + RTSTRUCT + RTDOSE read by both packages,
    with a mesh-only ROI "Shell" on each: the PTV's discrete mesh."""
    write_case(tmp_path)
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path))
    t, j = TData.image["CT 01"], JData.image["CT 01"]
    j.rois["PTV"].create_discrete_mesh()
    mesh = j.rois["PTV"].mesh
    interop.meshes_from_numpy(t, {"Shell": (mesh.points, mesh.faces)})
    j.create_roi(name="Shell", visible=True)
    j.rois["Shell"].update_mesh(JTriMesh(mesh.points.copy(),
                                         mesh.faces.copy()))
    assert t.rois["Shell"].contour_pixel is None
    return t, j


def test_mesh_only_roi_mask_matches_jax_and_is_cached(tmp_path):
    t, j = mesh_only_case(tmp_path)
    mask = t.rois["Shell"].compute_mask()
    np.testing.assert_array_equal(mask,
                                  np.asarray(j.rois["Shell"].compute_mask()))
    ptv = t.rois["PTV"].compute_mask()
    assert mask.sum() > 0.8 * ptv.sum()
    # the mask cache holds it; a new mesh invalidates it
    cached = t._roi_mask_cache_get("Shell", t.rois["Shell"],
                                   reconstruct=False)
    assert cached is not None
    np.testing.assert_array_equal(t.rois["Shell"].compute_mask(), mask)
    pts, faces = t.rois["Shell"].mesh.points, t.rois["Shell"].mesh.faces
    interop.meshes_from_numpy(t, {"Shell": (pts + [0.0, 0.0, 50.0], faces)})
    assert t._roi_mask_cache_get("Shell", t.rois["Shell"],
                                 reconstruct=False) is None
    # the pooled pass over the contoured ROIs leaves it to its own call
    masks = t.compute_roi_masks()
    assert set(masks) == set(t.rois)


GOALS = ["Dmax <= 62Gy", "Dmean >= 30Gy", "D95% >= 20Gy",
         "V40.3Gy >= 0.1cc"]


def test_evaluate_constraints_on_a_mesh_only_roi_matches_jax(tmp_path):
    """DVH goals on the mesh-only ROI: the port's values equal float64
    numpy over its own ROI doses, and the JAX package's to the 1e-4 Gy
    of the dose resample (tests/test_torch_plan_qa.py)."""
    mesh_only_case(tmp_path)
    td, jd = TData.dose["RTDOSE 01"], JData.dose["RTDOSE 01"]
    got = td.evaluate_constraints({"Shell": GOALS})
    want = jdose.evaluate_constraints(jd, {"Shell": GOALS})
    d = td.compute_roi_dose_array("CT 01", "Shell").astype(np.float64)
    voxel_cc = float(np.prod(TData.image["CT 01"].spacing)) / 1000.0
    assert len(got) == len(want) == len(GOALS) and d.size > 0
    for g, w in zip(got, want):
        kind, qual, _, _, unit = jdose._parse_goal(g["goal"])
        assert g["value"] == jdose._metric_value(kind, qual, unit, d,
                                                 voxel_cc)
        np.testing.assert_allclose(g["value"], w["value"], rtol=0,
                                   atol=1e-4)
