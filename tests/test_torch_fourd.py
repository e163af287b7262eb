"""The 4D phase tools in both packages, on the CPU: a gated series written
once (tests/test_fourd.py's three-phase sphere), read by both packages'
``read_dicoms`` (phase splitting), then ``find_phase_groups``,
``combine_phases`` (mean, MIP, MinIP), ``compute_itv`` on the same grid
and on a coarser ``CreateImageFromMask`` target, and the error branches.

Tolerances, stated per check:
- the split phases, the grouping and its temporal order: equal;
- ``combine_phases``: equal arrays, dtype and geometry (a float32 mean of
  small integers, rounded back to int16);
- the ITV on the phases' grid: an equal mask; on a coarser target (one
  ``affine`` resample of the union): the mask equal except where the
  resampled union lies within 1e-5 of the 0.5 cut (the affine
  coordinates' few-ulp difference, ROADMAP.md queue 3), and the JAX
  suite's centroid and volume checks.
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.utils import fourd as tfourd
from medicalimageanalysis_torch.utils.creation import (
    CreateImageFromMask as TCreateImageFromMask)
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.utils import fourd as jfourd
from medicalimageanalysis_tpu.utils.creation import (
    CreateImageFromMask as JCreateImageFromMask)
from test_fourd import K, NX, NY, NZ, _write_4d


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


def read_4d(tmp_path, tag_mode="tpi"):
    vols = _write_4d(tmp_path / "ct4d", tag_mode)
    tmia.read_dicoms(folder_path=str(tmp_path / "ct4d"), device="cpu")
    jmia.read_dicoms(folder_path=str(tmp_path / "ct4d"))
    return vols


@pytest.mark.parametrize("tag_mode", ["tpi", "trigger", "fallback"])
def test_phase_split_and_groups_equal(tmp_path, tag_mode):
    vols = read_4d(tmp_path, tag_mode)
    assert TData.image_list == JData.image_list and len(TData.image_list) == K
    for k, name in enumerate(TData.image_list):
        t, j = TData.image[name], JData.image[name]
        np.testing.assert_array_equal(t.array, vols[k])
        np.testing.assert_array_equal(t.array, np.asarray(j.array))
        assert tfourd.temporal_sort_key(t) == jfourd.temporal_sort_key(j)
    groups = tfourd.find_phase_groups()
    assert groups == jfourd.find_phase_groups() == [list(TData.image_list)]
    assert tfourd.find_phase_groups(TData.image_list[:1]) == []
    # the utils re-export serves the same functions
    assert tmia.utils.find_phase_groups is tfourd.find_phase_groups


@pytest.mark.parametrize("method", ["mean", "mip", "minip"])
def test_combine_phases_equal(tmp_path, method):
    read_4d(tmp_path)
    names = tfourd.find_phase_groups()[0]
    t = tfourd.combine_phases(names, method=method)
    j = jfourd.combine_phases(names, method=method)
    assert t.image_name == j.image_name and t.image_name in TData.image_list
    assert t.array.dtype == np.asarray(j.array).dtype == np.int16
    np.testing.assert_array_equal(t.array, np.asarray(j.array))
    for key in ("spacing", "origin", "dimensions", "matrix"):
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key))
    assert t.modality == j.modality and t.plane == j.plane
    # name collision suffixing
    t2 = tfourd.combine_phases(names, method=method)
    assert t2.image_name == jfourd.combine_phases(
        names, method=method).image_name != t.image_name


def add_gtvs(vols, names):
    union = np.zeros((NZ, NY, NX), bool)
    for k, n in enumerate(names):
        for img in (TData.image[n], JData.image[n]):
            img.create_roi(name="GTV", color=[255, 0, 0])
            img.rois["GTV"].convert_mask(np.asarray(vols[k]) == 200)
        union |= np.asarray(TData.image[n].rois["GTV"].compute_mask()) > 0
    return union


def test_itv_on_the_phase_grid_equal(tmp_path):
    vols = read_4d(tmp_path)
    names = tfourd.find_phase_groups()[0]
    union = add_gtvs(vols, names)
    tfourd.combine_phases(names, method="mean")
    aip = jfourd.combine_phases(names, method="mean").image_name
    itv = tfourd.compute_itv(names, "GTV", target=aip)
    jitv = jfourd.compute_itv(names, "GTV", target=aip)
    assert itv.name == jitv.name == "ITV_GTV"
    got = np.asarray(TData.image[aip].rois["ITV_GTV"].compute_mask())
    np.testing.assert_array_equal(
        got, np.asarray(JData.image[aip].rois["ITV_GTV"].compute_mask()))
    inter = np.logical_and(got > 0, union).sum()
    assert 2.0 * inter / ((got > 0).sum() + union.sum()) > 0.98
    # default target: the first phase
    tfourd.compute_itv(names, "GTV", itv_name="ITV_first")
    assert "ITV_first" in TData.image[names[0]].rois


def test_itv_resampled_to_a_coarser_grid(tmp_path):
    vols = read_4d(tmp_path)
    names = tfourd.find_phase_groups()[0]
    union = add_gtvs(vols, names)
    for cls in (TCreateImageFromMask, JCreateImageFromMask):
        cls(np.zeros((NZ, NY // 2, NX // 2), np.int16), [0.0, 0.0, 0.0],
            [2.0, 2.0, 2.0], "Planning", plane="Axial",
            modality="CT").add_image()
        cls(np.zeros((4, 8, 8), np.int16), [500.0, 500.0, 500.0],
            [1.0, 1.0, 1.0], "Far", plane="Axial", modality="CT") \
            .add_image()
    tfourd.compute_itv(names, "GTV", target="Planning")
    jfourd.compute_itv(names, "GTV", target="Planning")
    got = np.asarray(TData.image["Planning"].rois["ITV_GTV"]
                     .compute_mask()) > 0
    ref = np.asarray(JData.image["Planning"].rois["ITV_GTV"]
                     .compute_mask()) > 0
    # the resampled union away from the 0.5 cut decides every voxel
    from medicalimageanalysis_tpu.ops.resample import (affine_resample,
                                                       compose_pixel_matrix)
    first, plan = JData.image[names[0]], JData.image["Planning"]
    A = compose_pixel_matrix(first.matrix, first.spacing, first.origin,
                             plan.matrix, plan.spacing, plan.origin)
    frac = np.asarray(affine_resample(union.astype(np.float32), A,
                                      tuple(int(v) for v in plan.dimensions),
                                      background=0.0))
    clear = np.abs(frac - 0.5) > 1e-5
    np.testing.assert_array_equal(got[clear], ref[clear])
    assert got.any()
    c_fine = np.mean(np.argwhere(union)[:, ::-1]
                     * np.asarray(first.spacing), axis=0)
    c_coarse = np.mean(np.argwhere(got)[:, ::-1] * 2.0, axis=0)
    np.testing.assert_allclose(c_coarse, c_fine, atol=1.5)
    vol_fine = union.sum() * np.prod(np.asarray(first.spacing))
    assert abs(got.sum() * 8.0 - vol_fine) / vol_fine < 0.35
    with pytest.raises(ValueError, match="does not intersect"):
        tfourd.compute_itv(names, "GTV", target="Far")


def test_fourd_error_branches(tmp_path):
    read_4d(tmp_path)
    names = tfourd.find_phase_groups()[0]
    with pytest.raises(ValueError, match="method"):
        tfourd.combine_phases(names, method="median")
    with pytest.raises(ValueError, match="at least 2"):
        tfourd.combine_phases(names[:1])
    with pytest.raises(ValueError, match="at least 2"):
        tfourd.compute_itv(names[:1], "GTV")
    with pytest.raises(KeyError, match="no ROI"):
        tfourd.compute_itv(names, "Missing")
    TCreateImageFromMask(np.zeros((NZ, NY, NX + 1), np.int16),
                         [0.0, 0.0, 0.0], [1.0, 1.0, 2.0], "Odd").add_image()
    with pytest.raises(ValueError, match="share one grid"):
        tfourd.combine_phases([names[0], "Odd"])


def test_create_image_from_mask_registers_an_image():
    arr = np.arange(3 * 4 * 5, dtype=np.int16).reshape(3, 4, 5)
    t = TCreateImageFromMask(arr, [1.0, 2.0, 3.0], [0.5, 0.6, 2.0], "Made",
                             modality="MR")
    j = JCreateImageFromMask(arr, [1.0, 2.0, 3.0], [0.5, 0.6, 2.0], "Made",
                             modality="MR")
    t.add_image()
    j.add_image()
    ti, ji = TData.image["Made"], JData.image["Made"]
    assert TData.image_list == ["Made"]
    np.testing.assert_array_equal(ti.array, arr)
    for key in ("spacing", "origin", "dimensions", "matrix"):
        np.testing.assert_array_equal(getattr(ti, key), getattr(ji, key))
    assert len(ti.tags) == 3 and ti.modality == "MR"
    np.testing.assert_array_equal(
        [ds.ImagePositionPatient for ds in ti.tags],
        [ds.ImagePositionPatient for ds in ji.tags])
    assert ti.display.slice_location == ji.display.slice_location
