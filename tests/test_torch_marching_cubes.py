"""Marching tetrahedra in the port (ops/marching_cubes.py) against the JAX
package's: the half-unit table equals JAX ``_binary_tables()``; the
device table path (run here on the CPU) and the port's host twin give
points and faces bit-equal to JAX ``marching_cubes_mask`` and
``mask_to_mesh`` on a sphere, a torus, masks touching the frame, an empty
mask and a single voxel, with ``pad`` True and False, for bool, uint8 and
int16 masks; the float path gives the same faces with points within
1e-5 voxel.
"""

import numpy as np
import pytest
import torch

from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import marching_cubes as tmc
from medicalimageanalysis_tpu.ops import marching_cubes as jmc

SPACING = [0.8, 1.1, 2.5]
ORIGIN = [-30.0, 12.5, -100.0]
MATRIX = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]])


@pytest.fixture(autouse=True)
def torch_env():
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    set_default_device(None)


def masks():
    zz, yy, xx = np.mgrid[0:14, 0:22, 0:20].astype(np.float64)
    out = {}
    out["sphere"] = (zz - 7) ** 2 + (yy - 10) ** 2 + (xx - 9.5) ** 2 < 36
    rho = np.sqrt((yy - 11) ** 2 + (xx - 10) ** 2)
    out["torus"] = (rho - 6.0) ** 2 + ((zz - 7) * 1.3) ** 2 < 6.5
    frame = np.zeros((6, 9, 11), bool)
    frame[0:3, :, 3:] = True                       # touches five faces
    frame[5, 8, 0] = True                          # a corner voxel
    out["frame"] = frame
    out["empty"] = np.zeros((5, 6, 7), bool)
    one = np.zeros((5, 5, 5), bool)
    one[2, 3, 1] = True
    out["single_voxel"] = one
    r = np.random.default_rng(4)
    out["random"] = r.random((7, 9, 8)) < 0.4
    return out


def same(t, j):
    assert t.points.dtype == j.points.dtype == np.float64
    assert t.faces.dtype == j.faces.dtype == np.int32
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.faces, j.faces)


def test_table_equals_jax():
    for t, j in zip(tmc._binary_tables(), jmc._binary_tables()):
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t, j)
    flat, starts, ntris = tmc._binary_tables()
    assert ntris[0] == ntris[255] == 0 and flat.shape[0] == ntris.sum()


@pytest.mark.parametrize("name", list(masks()))
@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.int16])
def test_table_path_bit_equal_to_jax(name, pad, dtype):
    mask = masks()[name].astype(dtype)
    ref = jmc.marching_cubes_mask(mask, pad=pad)
    same(tmc.marching_cubes_mask(mask, pad=pad), ref)
    same(tmc.marching_cubes_mask(torch.as_tensor(mask), pad=pad), ref)
    same(tmc.marching_cubes_host(mask, pad=pad), ref)
    if name not in ("empty",) and pad:
        assert ref.number_of_points > 0


@pytest.mark.parametrize("name", ["sphere", "torus", "frame"])
def test_mask_to_mesh_bit_equal_to_jax(name):
    mask = masks()[name].astype(np.uint8)
    same(tmc.mask_to_mesh(mask, SPACING, ORIGIN, MATRIX),
         jmc.mask_to_mesh(mask, SPACING, ORIGIN, MATRIX))


@pytest.mark.parametrize("iso", [0.3, 0.55, 0.8])
@pytest.mark.parametrize("pad", [True, False])
def test_float_path_same_faces(iso, pad):
    zz, yy, xx = np.mgrid[0:12, 0:16, 0:15].astype(np.float64)
    vol = np.exp(-((zz - 5.3) ** 2 / 18 + (yy - 7.6) ** 2 / 30
                   + (xx - 7.1) ** 2 / 24)).astype(np.float32)
    vol[0, :, :] += 0.9 * (iso > 0.5)               # a surface on the frame
    t = tmc.marching_cubes_mask(vol, iso=iso, pad=pad)
    j = jmc.marching_cubes_mask(vol, iso=iso, pad=pad)
    assert t.number_of_points == j.number_of_points > 0
    np.testing.assert_array_equal(t.faces, j.faces)
    np.testing.assert_allclose(t.points, j.points, rtol=0, atol=1e-5)


def test_integer_volumes_off_the_table_take_the_float_path():
    labels = np.zeros((6, 8, 8), np.int16)
    labels[1:5, 2:6, 2:6] = 3
    labels[2:4, 3:5, 3:5] = -2
    for iso in (0.5, 1.5):
        t = tmc.marching_cubes_mask(labels, iso=iso)
        j = jmc.marching_cubes_mask(labels, iso=iso)
        np.testing.assert_array_equal(t.faces, j.faces)
        np.testing.assert_allclose(t.points, j.points, rtol=0, atol=1e-5)
