"""The port's segmentation metrics (utils/metrics.py), ``compare_rois``
(host and device backends), ``compare_masks_batch`` and the ROI margins
(utils/roi/margin.py) against the JAX package's, on the CPU.

Tolerances, stated per check:
- host metrics (numpy / scipy on both sides), ``expand_mask`` with the
  scipy backend and ``combine_masks``: equal;
- ``expand_mask`` with the device backend: equal (the squared EDT is
  bit-equal to the JAX package's, test_torch_edt.py);
- the device panels (``compare_rois(backend="device")``,
  ``compare_masks_batch``): 1e-5 relative, dice and volumes equal.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy import ndimage

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series, write_rtstruct
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.parallel import batch as tbatch
from medicalimageanalysis_torch.utils import metrics as TM
from medicalimageanalysis_torch.utils.roi import margin as TMargin
from medicalimageanalysis_torch.parallel.mesh import make_mesh
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.parallel import batch as jbatch
from medicalimageanalysis_tpu.utils import metrics as JM
from medicalimageanalysis_tpu.utils.roi import margin as JMargin


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


def blobs(rng, shape, p=0.99, iters=3):
    m = ndimage.binary_dilation(rng.random(shape) > p, iterations=iters)
    if not m.any():
        m[tuple(s // 2 for s in shape)] = True
    return m


HOST_METRICS = ["dice_coefficient", "jaccard_index", "volume_cc",
                "hausdorff_distance", "hausdorff95", "mean_surface_distance",
                "surface_dice", "surface_distances"]


@pytest.mark.parametrize("name", HOST_METRICS)
def test_host_metrics_equal_jax(name):
    rng = np.random.default_rng(4)
    a = blobs(rng, (12, 20, 18), p=0.99, iters=3)
    b = np.roll(a, (1, -2, 1), axis=(0, 1, 2)).astype(np.uint8)
    sp = (0.9, 1.1, 2.5)
    args = {"dice_coefficient": (a, b), "jaccard_index": (a, b),
            "volume_cc": (a, sp), "hausdorff_distance": (a, b, sp),
            "hausdorff95": (a, b, sp, 95.0),
            "mean_surface_distance": (a, b, sp),
            "surface_dice": (a, b, sp, 1.5),
            "surface_distances": (a, b, sp)}[name]
    fn = "hausdorff_distance" if name == "hausdorff95" else name
    got, want = getattr(TM, fn)(*args), getattr(JM, fn)(*args)
    if name == "surface_distances":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        assert got == want


def test_tre_and_empty_surface():
    pa = np.random.default_rng(2).normal(size=(5, 3))
    pb = pa + 0.5
    got, want = TM.target_registration_error(pa, pb), \
        JM.target_registration_error(pa, pb)
    np.testing.assert_array_equal(got["tre_mm"], want["tre_mm"])
    assert got["mean_mm"] == want["mean_mm"]
    with pytest.raises(ValueError, match="empty"):
        TM.surface_distances(np.zeros((3, 4, 5)), np.ones((3, 4, 5)),
                             (1, 1, 1))
    assert TM.voxel_volume_cc((0.8, 0.8, 2.0)) == \
        JM.voxel_volume_cc((0.8, 0.8, 2.0))


def circle(info, s, cx, cy, r, n=24):
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    z = info["origin"][2] + s * info["thickness"]
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a),
                     np.full(n, z)], axis=1)


def write_case(folder):
    ct = np.random.default_rng(3).integers(-200, 300, size=(10, 32, 36)) \
        .astype(np.int16)
    info = write_ct_series(folder / "ct", ct, origin=(-18.0, -16.0, -10.0),
                           spacing=(1.0, 1.0), thickness=2.0)
    rois = {"A": [(circle(info, s, 1.3, 2.1, 5.0 + s % 3), s)
                  for s in range(2, 8)],
            "B": [(circle(info, s, 2.4, 0.8, 5.5), s) for s in range(3, 9)],
            "Empty": []}
    write_rtstruct(folder / "ct" / "rs.dcm", info, rois)


@pytest.mark.parametrize("pair", [("A", "B"), ("B", "A"), ("A", "A")])
@pytest.mark.parametrize("backend", ["host", "device"])
def test_compare_rois_matches_jax(tmp_path, pair, backend):
    write_case(tmp_path)
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path))
    t_img = TData.image[TData.image_list[0]]
    j_img = JData.image[JData.image_list[0]]
    got = TM.compare_rois(t_img, *pair, tolerance_mm=1.5, backend=backend)
    want = JM.compare_rois(j_img, *pair, tolerance_mm=1.5, backend=backend)
    assert set(got) == set(want)
    for k in want:
        if backend == "host" or k in ("dice", "jaccard", "volume_a_cc",
                                      "volume_b_cc"):
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="backend"):
        TM.compare_rois(t_img, *pair, backend="cuda")


def test_compare_rois_default_backend_is_device(tmp_path, monkeypatch):
    from medicalimageanalysis_torch.ops import edt as tedt

    write_case(tmp_path)
    tmia.read_dicoms(folder_path=str(tmp_path))
    t_img = TData.image[TData.image_list[0]]
    calls = []
    panel = tedt.surface_metrics
    monkeypatch.setattr(tedt, "surface_metrics",
                        lambda *a, **k: calls.append(k) or panel(*a, **k))
    got = TM.compare_rois(t_img, "A", "B")
    assert len(calls) == 1 and calls[0]["device"] == torch.device("cpu")
    assert got == TM.compare_rois(t_img, "A", "B", backend="device")


@pytest.mark.parametrize("margin", ["iso_3.7", "contract_2.3"])
def test_expand_mask_default_backend_is_device(monkeypatch, margin):
    from medicalimageanalysis_torch.ops import edt as tedt

    m = blobs(np.random.default_rng(6), (14, 18, 16), p=0.985, iters=2)
    sp = (0.9, 0.9, 2.5)
    calls = []
    sq = tedt.squared_edt
    monkeypatch.setattr(tedt, "squared_edt",
                        lambda *a: calls.append(a[2]) or sq(*a))
    got = TMargin.expand_mask(m, sp, MARGINS[margin])
    assert calls == [None]                      # default_device(): the CPU
    np.testing.assert_array_equal(
        got, TMargin.expand_mask(m, sp, MARGINS[margin], backend="device"))
    # an explicit device reaches the EDT
    TMargin.expand_mask(m, sp, MARGINS[margin], device="cpu")
    assert calls[-1] == "cpu"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_backends_raise_without_card():
    m = blobs(np.random.default_rng(6), (6, 8, 8), p=0.9, iters=1)
    set_default_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMargin.expand_mask(m, (1.0, 1.0, 2.0), 2.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.compare_rois(SimpleNamespace(rois={
            n: SimpleNamespace(compute_mask=lambda: m) for n in "AB"},
            spacing=(1.0, 1.0, 2.0)), "A", "B")
    np.testing.assert_array_equal(
        TMargin.expand_mask(m, (1.0, 1.0, 2.0), 2.0, device="cpu"),
        TMargin.expand_mask(m, (1.0, 1.0, 2.0), 2.0, backend="scipy"))


def test_compare_masks_batch_matches_jax():
    rng = np.random.default_rng(9)
    B, shape, sp = 3, (12, 16, 14), (1.0, 1.2, 2.0)
    masks_a = np.stack([blobs(rng, shape, p=0.97) for _ in range(B)])
    masks_b = np.stack([np.roll(m, (1, -1, 2), axis=(0, 1, 2))
                        for m in masks_a])
    masks_b[2] = False                            # one empty mask
    got = tbatch.compare_masks_batch(masks_a, masks_b, sp, tolerance_mm=1.5)
    want = jbatch.compare_masks_batch(masks_a, masks_b, sp, tolerance_mm=1.5)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == (B,)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="matching"):
        tbatch.compare_masks_batch(masks_a[:, 0], masks_b[:, 0], sp)
    # a CPU mesh of 3 data rows x 2 runs the same panel, equal to mesh=None
    sharded = tbatch.compare_masks_batch(
        masks_a, masks_b, sp, tolerance_mm=1.5,
        mesh=make_mesh(6, space=2, devices=["cpu"] * 6))
    for k in got:
        np.testing.assert_array_equal(sharded[k], got[k], err_msg=k)


MARGINS = {"iso_3.7": 3.7, "axes_xy": [4.0, 4.0, 0.0], "contract_2.3": -2.3,
           "aniso": [2.0, 3.5, 5.0], "zero": 0.0}


@pytest.mark.parametrize("backend", ["scipy", "device"])
@pytest.mark.parametrize("margin", list(MARGINS))
def test_expand_mask_matches_jax(backend, margin):
    m = blobs(np.random.default_rng(6), (14, 18, 16), p=0.985,
              iters=2).astype(np.uint8)
    sp = (0.9, 0.9, 2.5)
    got = TMargin.expand_mask(m, sp, MARGINS[margin], backend=backend)
    want = JMargin.expand_mask(m, sp, MARGINS[margin], backend=backend)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the device and scipy backends agree here too
    np.testing.assert_array_equal(
        got, JMargin.expand_mask(m, sp, MARGINS[margin]))


@pytest.mark.parametrize("op", ["union", "intersect", "subtract", "xor"])
def test_combine_masks_equal_jax(op):
    rng = np.random.default_rng(8)
    a, b = (rng.random((4, 6, 5)) > 0.5 for _ in range(2))
    np.testing.assert_array_equal(TMargin.combine_masks(op, a, b),
                                  JMargin.combine_masks(op, a, b))


def test_margin_and_combine_reject_bad_input():
    m = np.ones((3, 4, 5), np.uint8)
    for bad in (dict(margin_mm=[1.0, -1.0, 0.0]),
                dict(margin_mm=[1.0, 2.0]),
                dict(margin_mm=1.0, backend="cuda")):
        with pytest.raises(ValueError):
            TMargin.expand_mask(m, (1, 1, 1), **bad)
    with pytest.raises(ValueError, match="unknown op"):
        TMargin.combine_masks("nand", m, m)
    with pytest.raises(ValueError, match="shapes differ"):
        TMargin.combine_masks("union", m, m[0])
