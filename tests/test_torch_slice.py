"""The whole slice in both packages: write a CT pair with a known rigid
offset, ``read_dicoms``, ``Rigid.compute_intensity``, ``create_image``.
The JAX package runs on the CPU (its XLA branches); the port runs its
plain twins there."""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from medicalimageanalysis_torch import interop
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops.resample import reslice_grid
from medicalimageanalysis_torch.utils.creation import CreateDicomImage
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.structure.rigid import Rigid as JRigid

SHAPE = (24, 48, 48)
SPACING = [1.6, 1.6, 3.0]          # [sx, sy, sz] mm
LEVELS = ((2, 10, 0.1), (1, 5, 0.03))
BG = -3001.0


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def phantom(rng, deg, shift_vox):
    """Smooth blobs in HU on SHAPE, sampled at the grid rotated by ``deg``
    about the volume's z axis and shifted by ``shift_vox`` (x, y, z)."""
    Z, Y, X = SHAPE
    zz, yy, xx = np.mgrid[0:Z, 0:Y, 0:X].astype(np.float64)
    c = (np.asarray(SHAPE, np.float64) - 1) / 2
    th = np.deg2rad(deg)
    x = np.cos(th) * (xx - c[2]) - np.sin(th) * (yy - c[1]) + shift_vox[0]
    y = np.sin(th) * (xx - c[2]) + np.cos(th) * (yy - c[1]) + shift_vox[1]
    z = zz - c[0] + shift_vox[2]
    vol = np.full(SHAPE, -1000.0)
    for (bz, by, bx, r, hu) in ((0, 2, -1, 14, 1040), (2, -6, -8, 5, -760),
                                (-3, -5, 9, 5, -800), (4, 9, 0, 3, 650),
                                (-5, 3, 5, 3, 90)):
        d2 = ((x - bx) ** 2 + (y - by) ** 2) / r ** 2 \
            + (z - bz) ** 2 / (0.6 * r) ** 2
        vol += hu * np.exp(-d2)
    noise = rng.normal(0, 5, SHAPE)
    return np.round(vol + noise).astype(np.int16)


def write_pair(folder):
    rng = np.random.default_rng(11)
    for name, deg, shift, origin in (
            ("ref", 0.0, (0, 0, 0), [-38.0, -40.0, -33.0]),
            ("mov", 2.5, (0.8, -0.5, 0.3), [-36.0, -40.0, -33.0])):
        CreateDicomImage(str(folder / name), phantom(rng, deg, shift),
                         origin=origin, spacing=SPACING[:2],
                         thickness=SPACING[2]).run()


def boundary_distance(A, out_shape, vol_shape):
    """Per output voxel, the float64 distance of its sample from the
    nearest face of [0, dim-1]."""
    zz, yy, xx = np.mgrid[0:out_shape[0], 0:out_shape[1], 0:out_shape[2]] \
        .astype(np.float64)
    A = np.asarray(A, np.float64)
    d = np.full(out_shape, np.inf)
    for row, n in ((0, vol_shape[2]), (1, vol_shape[1]), (2, vol_shape[0])):
        c = A[row, 0] * xx + A[row, 1] * yy + A[row, 2] * zz + A[row, 3]
        d = np.minimum(d, np.minimum(np.abs(c), np.abs(c - (n - 1))))
    return d


def test_slice_matches_jax(tmp_path):
    write_pair(tmp_path)
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    assert TData.image_list == JData.image_list == ["CT 01", "CT 02"]
    ref_name, mov_name = TData.image_list
    for name in TData.image_list:
        np.testing.assert_array_equal(TData.image[name].array,
                                      JData.image[name].array)

    # registration: same matrix to 1e-4 (rotation) and 1e-3 mm (shift)
    j_rigid = JRigid(ref_name, mov_name)
    j_rigid.compute_intensity(levels=LEVELS)
    t_rigid = tmia.Rigid(ref_name, mov_name, device="cpu")
    info = t_rigid.compute_intensity(levels=LEVELS)
    assert t_rigid.rigid_name == j_rigid.rigid_name == "CT 01_CT 02"
    assert [len(ls) for ls in info["losses"]] == [10, 5]
    assert info["losses"][-1][-1] < info["losses"][0][0]
    np.testing.assert_allclose(t_rigid.matrix[:3, :3],
                               j_rigid.matrix[:3, :3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_rigid.matrix[:3, 3], j_rigid.matrix[:3, 3],
                               rtol=0, atol=1e-3)

    # reslice: the port's own result has the JAX grid
    j_out = j_rigid.create_image()
    t_out = t_rigid.create_image()
    assert t_out["array"].shape == j_out["array"].shape
    np.testing.assert_allclose(t_out["origin"], j_out["origin"], atol=1e-2)
    np.testing.assert_array_equal(t_out["spacing"], j_out["spacing"])

    # ... and on identical state (the JAX matrix carried over) the same
    # values: f32 rounding of the lerp plus a few ulp of coordinate (the
    # JAX CPU path contracts the coefficient sums into FMAs)
    same = interop.rigid_from_matrix(ref_name, mov_name, j_rigid.matrix,
                                     device="cpu")
    out = same.create_image()
    ref = np.asarray(j_out["array"])
    arr = out["array"]
    assert arr.shape == ref.shape and np.isfinite(arr).all()
    np.testing.assert_allclose(out["origin"], j_out["origin"], atol=1e-9)
    vol = TData.image[mov_name].array.astype(np.float32)
    coord_err = 4 * np.spacing(np.float32(max(SHAPE)))
    max_step = max(np.abs(np.diff(vol, axis=k)).max() for k in range(3))
    both = (arr != BG) & (ref != BG)
    np.testing.assert_allclose(arr[both], ref[both], rtol=0,
                               atol=3 * coord_err * max_step
                               + 1e-6 * np.abs(vol).max())
    mov = TData.image[mov_name]
    A, shape, _, _ = reslice_grid(vol.shape, mov.matrix, mov.spacing,
                                  mov.origin, j_rigid.matrix,
                                  TData.image[ref_name].spacing)
    flip = (arr == BG) != (ref == BG)
    assert np.all(boundary_distance(A, shape, vol.shape)[flip] < 1e-4)
    assert 0.05 < (arr == BG).mean() < 0.5


def test_interop_carries_jax_state(tmp_path):
    """JAX-package images carried into the port by duck typing keep their
    arrays, geometry and identity; a plain numpy image registers too."""
    write_pair(tmp_path)
    jmia.read_dicoms(folder_path=str(tmp_path))
    for name in JData.image_list:
        j = JData.image[name]
        t = interop.import_image(j)
        assert TData.image[name] is t
        np.testing.assert_array_equal(t.array, j.array)
        for key in ("spacing", "origin", "matrix", "dimensions"):
            np.testing.assert_array_equal(getattr(t, key), getattr(j, key))
        np.testing.assert_array_equal(t.compute_center(), j.compute_center())
        assert (t.series_uid, t.plane) == (j.series_uid, j.plane)
    assert TData.image_list == JData.image_list

    arr = np.zeros((4, 6, 8), np.int16)
    img = interop.image_from_arrays(arr, [0.5, 1.0, 2.0], [10.0, 0.0, -4.0],
                                    np.eye(3), "CT", "CT 09")
    assert TData.image_list[-1] == "CT 09" and TData.image["CT 09"] is img
    np.testing.assert_allclose(img.compute_center(), [12.0, 3.0, 0.0])
    assert img.series_uid == "00000.00000"
    rigid = interop.rigid_from_matrix("CT 01", "CT 09", np.eye(4))
    assert TData.rigid[rigid.rigid_name] is rigid
    assert rigid.rigid_name == "CT 01_CT 09"
