"""The image-resampling entry points in both packages, on the CPU:
``utils.euler_transform``, ``Image.resample_to``, ``create_rotated_volume``
and ``compute_projection`` (MIP, mean and DRR, with and without angles),
through ``read_dicoms`` of written CT series. The JAX package runs its
XLA gather; the port runs the plain twin of the warp kernel's ``affine``
mode.

Tolerances, stated per check:
- ``euler_transform``: equal (the same host numpy code);
- the resampled and rotated volumes: the affine rule of
  test_torch_view.py (``assert_affine_close``): f32 rounding plus a few
  ulp of sample coordinate times the largest step between neighbours
  (XLA on the CPU contracts the coefficient sums into FMAs, the port
  does not: ROADMAP.md queue 3), the background mask differing only at
  voxels whose sample lies within 1e-4 voxel of a face;
- projections without angles: MIP equal, mean and DRR 1e-6 relative to
  the largest value (float32 sums in another order);
- rotated projections: equal to the port's reduction of its own rotated
  volume; against the JAX package, the volume rule above (summed over
  the line for the DRR) on every line free of a flipped background
  voxel.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import resample as tresample
from medicalimageanalysis_torch.structure import image as timage
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.ops import resample as jresample
from medicalimageanalysis_tpu.utils.image import transform as jtransform
from test_torch_view import assert_affine_close, boundary_distance

BG = -3001.0
SHAPE = (10, 24, 28)


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


def phantom(seed=3, shape=SHAPE):
    rng = np.random.default_rng(seed)
    vol = ndimage.gaussian_filter(rng.normal(size=shape), 1.5)
    vol = 300.0 * vol / vol.std() - 400.0
    return np.round(vol).astype(np.int16)


def read_both(folder):
    tmia.read_dicoms(folder_path=str(folder), device="cpu")
    jmia.read_dicoms(folder_path=str(folder))
    return TData.image, JData.image


def ingest(tmp_path, arr=None, spacing=(0.9, 1.1), thickness=2.5):
    write_ct_series(tmp_path / "ct", phantom() if arr is None else arr,
                    spacing=spacing, thickness=thickness)
    t, j = read_both(tmp_path / "ct")
    return t["CT 01"], j["CT 01"]


@pytest.mark.parametrize("zyx", [False, True])
@pytest.mark.parametrize("kw", [
    dict(angles=(10, -20, 35)),
    dict(angles=(3, 0, 90), rotation_center=(1.5, -2.0, 7.0),
         translation=(0.5, 1.0, -2.0)),
    dict(matrix=np.diag([1.0, -1.0, -1.0]), translation=(1, 2, 3))],
    ids=["angles", "center_translation", "matrix"])
def test_euler_transform_equal(kw, zyx):
    t = tmia.utils.euler_transform(zyx=zyx, **kw)
    j = jtransform.euler_transform(zyx=zyx, **kw)
    np.testing.assert_array_equal(t.as_matrix4(), j.as_matrix4())
    np.testing.assert_array_equal(t.inverse().as_matrix4(),
                                  j.inverse().as_matrix4())
    pts = np.random.default_rng(0).normal(size=(5, 3)) * 50
    np.testing.assert_array_equal(t.transform_points(pts),
                                  j.transform_points(pts))
    assert t.GetMatrix() == j.GetMatrix()
    assert t.GetCenter() == j.GetCenter()
    assert t.GetTranslation() == j.GetTranslation()


def test_resample_to_matches_jax(tmp_path):
    """A CT onto a coarser, shifted grid of the same frame, and back; a
    voxel-aligned map (``values``) with background 0."""
    write_ct_series(tmp_path / "a", phantom(), spacing=(0.9, 1.1),
                    thickness=2.5)
    write_ct_series(tmp_path / "b", phantom(seed=4, shape=(7, 17, 19)),
                    origin=(-97.3, -118.6, -48.1), spacing=(1.3, 1.7),
                    thickness=3.5)
    t, j = read_both(tmp_path)
    names = sorted(t)
    assert names == sorted(j) and len(names) == 2
    for src, dst in (names, names[::-1]):
        ts, js = t[src], j[src]
        out = ts.resample_to(dst)
        ref = js.resample_to(dst)
        assert isinstance(out, np.ndarray) and out.dtype == np.float32
        A = np.asarray(jresample.compose_pixel_matrix(
            js.matrix, js.spacing, js.origin, j[dst].matrix,
            j[dst].spacing, j[dst].origin), np.float64)
        dist = boundary_distance(A, ref.shape, js.array.shape)
        assert_affine_close(out, ref, dist, ts.array)
        assert (out == BG).any() or src == names[1]
        values = (np.asarray(ts.array) > -400).astype(np.float32)
        out = ts.resample_to(t[dst], values=values, background=0.0)
        ref = js.resample_to(j[dst], values=values, background=0.0)
        assert_affine_close(out, ref, dist, values, bg=0.0)
    with pytest.raises(ValueError, match="values shape"):
        t[names[0]].resample_to(names[1], values=np.zeros((2, 2, 2)))


@pytest.mark.parametrize("angles", [(0, 0, 10), (4, -7, 12)])
def test_create_rotated_volume_matches_jax(tmp_path, angles):
    ti, ji = ingest(tmp_path)
    mask = np.zeros(SHAPE, np.uint8)
    mask[3:7, 8:16, 9:19] = 1
    for img in (ti, ji):
        img.create_roi(name="Liver", color=[255, 0, 0])
        img.rois["Liver"].convert_mask(mask)
    np.testing.assert_allclose(ti.rois["Liver"].mesh.center,
                               ji.rois["Liver"].mesh.center, atol=1e-9)
    out = ti.create_rotated_volume(angles=angles)
    ref = np.asarray(ji.create_rotated_volume(angles=angles))
    assert out.dtype == np.float32 and out.shape == SHAPE
    A = np.asarray(ti._rotation_pixel_matrix(
        angles, ji.rois["Liver"].mesh.center), np.float64)
    assert_affine_close(out, ref, boundary_distance(A, SHAPE, SHAPE),
                        ti.array, bg=0.0)
    assert (ref == 0.0).any()
    # the reference's alias, and an explicit center
    center = [-90.0, -100.0, -40.0]
    out = ti.create_rotated_sitk_image(angles=angles, center=center)
    ref = np.asarray(ji.create_rotated_sitk_image(angles=angles,
                                                  center=center))
    A = np.asarray(ti._rotation_pixel_matrix(angles, center), np.float64)
    assert_affine_close(out, ref, boundary_distance(A, SHAPE, SHAPE),
                        ti.array, bg=0.0)


@pytest.mark.parametrize("mode", ["mip", "mean", "drr"])
@pytest.mark.parametrize("axis", ["z", "y", "x"])
def test_projection_without_angles_matches_jax(tmp_path, mode, axis):
    ti, ji = ingest(tmp_path)
    out = ti.compute_projection(mode=mode, axis=axis)
    ref = np.asarray(ji.compute_projection(mode=mode, axis=axis))
    assert out.dtype == np.float32 and out.shape == ref.shape
    if mode == "mip":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["mip", "mean", "drr"])
@pytest.mark.parametrize("axis", ["z", "y"])
@pytest.mark.parametrize("angles", [(0, 0, 15), (6, -9, 21)])
def test_rotated_projection_matches_jax(tmp_path, mode, axis, angles):
    """The rotated volume under the affine rule; the projection equal to
    the port's reduction of its own rotated volume, and within the
    summed rule of the JAX package's on every line without a voxel whose
    background mask flipped (such a voxel lies within 1e-4 voxel of a
    face)."""
    ti, ji = ingest(tmp_path)
    center = np.asarray(ji.compute_center(), np.float64)
    A = ti._rotation_pixel_matrix(angles, center)
    vol = np.asarray(ti.array, np.float32)
    rot_t = tresample.affine_resample(vol, A, SHAPE, background=BG)
    rot_j = np.asarray(jresample.affine_resample(vol, A, SHAPE,
                                                 background=BG))
    dist = boundary_distance(np.asarray(A, np.float64), SHAPE, SHAPE)
    assert_affine_close(rot_t.numpy(), rot_j, dist, vol)
    ax = {"z": 0, "y": 1}[axis]
    out = ti.compute_projection(mode=mode, axis=axis, angles=angles)
    np.testing.assert_array_equal(out, timage.project(
        timage.clamp_to_air(rot_t), mode, ax, ti.spacing).numpy())
    ref = np.asarray(ji.compute_projection(mode=mode, axis=axis,
                                           angles=angles))
    assert out.shape == ref.shape
    lines = ~((rot_t.numpy() == BG) != (rot_j == BG)).any(axis=ax)
    assert lines.mean() > 0.8
    coord_err = 4 * np.spacing(np.float32(max(SHAPE)))
    max_step = max(np.abs(np.diff(vol, axis=k)).max() for k in range(3))
    tol = 3 * coord_err * max_step + 1e-6 * np.abs(vol).max()
    if mode == "drr":
        dl = float(ti.spacing[{0: 2, 1: 1}[ax]])
        tol = SHAPE[ax] * dl * 0.02 / 1000.0 * tol + 1e-6
    np.testing.assert_allclose(out[lines], ref[lines], rtol=0, atol=tol)


def test_projection_cases_of_the_jax_suite(tmp_path):
    """tests/test_projection.py through the port: MIP and mean, the
    analytic DRR of water and air, the 90° rotation moving a hot voxel,
    and the argument checks."""
    arr = np.full((4, 8, 10), -1000, np.int16)
    arr[2, 3, 7] = 500
    ti, _ = ingest(tmp_path / "a", arr, spacing=(1, 1), thickness=2.0)
    mip_y = ti.compute_projection(mode="mip", axis="y")
    assert mip_y.shape == (4, 10)
    assert mip_y[2, 7] == 500 and mip_y[0, 0] == -1000
    assert ti.compute_projection(mode="mip", axis="z")[3, 7] == 500
    mean_x = ti.compute_projection(mode="mean", axis="x")
    np.testing.assert_allclose(mean_x[2, 3], (-1000 * 9 + 500) / 10.0,
                               rtol=1e-6)

    ti, _ = ingest(tmp_path / "b", np.zeros((4, 8, 10), np.int16),
                   spacing=(1, 1), thickness=2.5)
    np.testing.assert_allclose(ti.compute_projection(mode="drr", axis="y"),
                               1.0 - np.exp(-0.02 * 8 * 1.0), rtol=1e-5)
    np.testing.assert_allclose(ti.compute_projection(mode="drr", axis="z"),
                               1.0 - np.exp(-0.02 * 4 * 2.5), rtol=1e-5)
    ti, _ = ingest(tmp_path / "c", np.full((4, 8, 10), -1000, np.int16),
                   spacing=(1, 1), thickness=2.0)
    assert float(ti.compute_projection(mode="drr", axis="y").max()) < 1e-6

    arr = np.full((4, 16, 16), -1000, np.int16)
    arr[2, 3, 12] = 900
    ti, ji = ingest(tmp_path / "d", arr, spacing=(1, 1), thickness=2.0)
    center = [float(ti.origin[0]) + 7.5, float(ti.origin[1]) + 7.5,
              float(ti.origin[2]) + 1.5 * 2.0]
    mip_z = ti.compute_projection(mode="mip", axis="z", angles=(0, 0, 90),
                                  center=center)
    ref = np.asarray(ji.compute_projection(mode="mip", axis="z",
                                           angles=(0, 0, 90),
                                           center=center))
    np.testing.assert_allclose(mip_z, ref, rtol=0, atol=1e-3)
    hot = np.unravel_index(np.argmax(mip_z), mip_z.shape)
    dy, dx = hot[0] - 7.5, hot[1] - 7.5
    sy, sx = 3 - 7.5, 12 - 7.5
    assert abs(np.hypot(dy, dx) - np.hypot(sy, sx)) <= 1.0
    assert abs(dy * sy + dx * sx) <= np.hypot(sy, sx) * 1.5
    assert float(mip_z.max()) > 500.0 and hot != (3, 12)

    with pytest.raises(ValueError, match="axis"):
        ti.compute_projection(axis="q")
    with pytest.raises(ValueError, match="mode"):
        ti.compute_projection(mode="sum")
