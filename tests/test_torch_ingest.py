"""Ingest parity: the same DICOM folders read into the JAX package and the
port give bit-equal volumes, equal geometry and equal image names."""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import volume as tvol
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.ops import volume as jvol
from medicalimageanalysis_tpu.utils.creation import CreateDicomImage

FFS_CASES = {
    "none": [1, 0, 0, 0, 1, 0],
    "ax_rot2": [-1, 0, 0, 0, -1, 0],
    "cor_rot1": [1, 0, 0, 0, 0, -1],
    "sag_fix": [0, 1, 0, 0, 0, -1],
}


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def write(folder, arr, orientation=(1, 0, 0, 0, 1, 0), origin=(3, -4, 5),
          modality="CT", slope=1, intercept=0):
    c = CreateDicomImage(str(folder), arr, origin=list(origin),
                         spacing=[0.9, 1.1], thickness=2.5)
    c.orientation = list(orientation)
    c.run(modality=modality, rescale_slope=slope,
          rescale_intercept=intercept)


def assert_same_array(out, ref):
    """int16 volumes are bit-equal. A float32 rescale (slope not a power
    of two) may differ by 1 ulp: XLA on the CPU contracts
    ``raw * slope + intercept`` into one FMA, while the port rounds the
    product and the sum apart, as the JAX package's numpy twin does."""
    assert out.dtype == ref.dtype
    if out.dtype == np.float32:
        np.testing.assert_array_max_ulp(out, ref, maxulp=1)
    else:
        np.testing.assert_array_equal(out, ref)


def assert_same_registry():
    assert TData.image_list == JData.image_list
    for name in JData.image_list:
        j, t = JData.image[name], TData.image[name]
        assert_same_array(t.array, np.asarray(j.array))
        np.testing.assert_array_equal(t.spacing, j.spacing)
        np.testing.assert_array_equal(t.origin, j.origin)
        np.testing.assert_array_equal(t.matrix, j.matrix)
        np.testing.assert_array_equal(t.dimensions, j.dimensions)
        assert t.plane == j.plane
        assert t.series_uid == j.series_uid
        np.testing.assert_array_equal(t.compute_center(),
                                      j.compute_center())


@pytest.mark.parametrize("case", sorted(FFS_CASES))
def test_read_dicoms_matches_jax(tmp_path, case):
    rng = np.random.default_rng(5)
    arr = rng.integers(-1000, 1500, size=(6, 10, 12)).astype(np.int16)
    write(tmp_path / "s", arr, FFS_CASES[case])
    jmia.read_dicoms(folder_path=str(tmp_path))
    reader = tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    assert reader.report.images_created == ["CT 01"]
    assert_same_registry()


def test_two_series_float_rescale_and_zip(tmp_path):
    """A float32-rescaled PT series beside a CT series, read from a zip:
    names, order, dtype and values all match."""
    rng = np.random.default_rng(6)
    ct = rng.integers(-1000, 1500, size=(5, 8, 9)).astype(np.int16)
    pt = rng.integers(0, 3000, size=(4, 8, 9)).astype(np.int16)
    write(tmp_path / "d" / "ct", ct)
    write(tmp_path / "d" / "pt", pt, origin=(0, 0, 40), modality="PT",
          slope=0.37, intercept=1.5)
    archive = shutil.make_archive(str(tmp_path / "cohort"), "zip",
                                  str(tmp_path / "d"))
    jmia.read_dicoms(folder_path=archive)
    tmia.read_dicoms(folder_path=archive, device="cpu")
    # names count the whole registry: the second image is "PT 02"
    assert sorted(TData.image_list) == ["CT 01", "PT 02"]
    assert TData.image["PT 02"].array.dtype == np.float32
    assert_same_registry()


@pytest.mark.parametrize("op", ["none", "ax_rot1", "ax_rot2", "ax_rot3",
                                "cor_rot1", "sag_fix"])
def test_apply_ffs_opcodes_match_jax(op):
    a = np.arange(5 * 6 * 7, dtype=np.float32).reshape(5, 6, 7)
    out = tvol.apply_ffs(torch.from_numpy(a), op).numpy()
    np.testing.assert_array_equal(out, np.asarray(jvol.apply_ffs(
        jnp.asarray(a), op)))


@pytest.mark.parametrize("dtype,out_dtype,slope,intercept", [
    (np.int16, np.int16, 1.0, -1024.0),
    (np.uint16, np.int16, 1.0, -1024.0),
    (np.uint16, np.float32, 0.25, 3.5),
    (np.int16, np.float32, 0.37, 1.5),
])
def test_assemble_volume_matches_jax(dtype, out_dtype, slope, intercept):
    rng = np.random.default_rng(7)
    hi = 30000 if dtype == np.uint16 else 3000
    raw = rng.integers(0, hi, size=(4, 6, 5)).astype(dtype)
    slopes = np.full(4, slope, np.float32)
    intercepts = np.full(4, intercept, np.float32)
    for op in ("ax_rot2", "sag_fix"):
        out = tvol.assemble_volume(raw, slopes, intercepts, op,
                                   out_dtype=out_dtype).numpy()
        ref = jvol.assemble_volume(raw, slopes, intercepts, op,
                                   out_dtype=out_dtype)
        assert_same_array(out, ref)
        # bit-equal to the JAX package's own numpy golden path
        np.testing.assert_array_equal(out, jvol.assemble_volume_numpy(
            raw, slopes, intercepts, op, out_dtype=out_dtype))


def test_unported_modality_raises_with_roadmap_item(tmp_path):
    """A folder of US objects used to raise here, naming ROADMAP.md queue
    1 item 2; the planar readers are ported now, so it reads as the JAX
    package reads it (one image per file, tests/test_torch_planar.py
    holds every planar modality)."""
    rng = np.random.default_rng(8)
    write(tmp_path / "us", rng.integers(0, 200, size=(2, 6, 6))
          .astype(np.int16), modality="US")
    tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    jmia.read_dicoms(folder_path=str(tmp_path))
    assert TData.image_list == JData.image_list == ["US 01", "US 02"]
    for name in TData.image_list:
        t, j = TData.image[name], JData.image[name]
        assert t.array.dtype == np.uint8 and t.array.shape == (1, 6, 6)
        np.testing.assert_array_equal(t.array, np.asarray(j.array))
        np.testing.assert_array_equal(t.spacing, j.spacing)
