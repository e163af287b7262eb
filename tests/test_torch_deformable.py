"""The deformable slice in both packages: write a CT pair related by a known
smooth deformation, ``read_dicoms``, then ``Deformable.compute_demons`` ->
``create_image`` -> ``compute_jacobian`` and ``compute_bspline`` ->
``create_image``. The JAX package runs on the CPU (its XLA branches); the
port runs its plain twins there."""

import numpy as np
import pytest
import torch
from scipy import ndimage

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from medicalimageanalysis_torch import interop
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.utils.creation import CreateDicomImage
from medicalimageanalysis_torch.utils.deformable.torch_backend import (
    DeformableTorch)
from medicalimageanalysis_tpu.structure.deformable import (
    Deformable as JDeformable)
from medicalimageanalysis_tpu.utils.deformable.jax_backend import (
    DeformableJAX)

SHAPE = (16, 32, 32)
SPACING = [1.5, 1.5, 2.5]          # [sx, sy, sz] mm
ORIGIN = [-24.0, -20.0, -20.0]
BG = -3001.0
RIGID = np.array([[1.0, 0, 0, 1.2], [0, 1.0, 0, -0.6], [0, 0, 1.0, 0.0],
                  [0, 0, 0, 1.0]])


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def phantom():
    zz, yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1], 0:SHAPE[2]] \
        .astype(np.float64)
    vol = np.full(SHAPE, -1000.0)
    for (bz, by, bx, rz, ry, rx, hu) in ((8, 16, 16, 5, 10, 11, 1040),
                                         (7, 12, 11, 2.5, 4, 4, -700),
                                         (9, 20, 21, 2, 3, 3, 600)):
        vol += hu * np.exp(-((zz - bz) / rz) ** 2 - ((yy - by) / ry) ** 2
                           - ((xx - bx) / rx) ** 2)
    return vol


def write_pair(folder):
    """Reference phantom, and the same phantom sampled at x + u(x), u a
    Gaussian bump of 1.5 voxels peak in x and y (scipy, order 1)."""
    ref = phantom()
    zz, yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1], 0:SHAPE[2]] \
        .astype(np.float64)
    bump = np.exp(-((zz - 8) ** 2 / 40 + (yy - 16) ** 2 / 60
                    + (xx - 16) ** 2 / 60))
    mov = ndimage.map_coordinates(ref, [zz, yy + 1.2 * bump,
                                        xx + 1.5 * bump],
                                  order=1, mode="nearest")
    for name, arr, uid in (("ref", ref, "1.2.3.4.1"),
                           ("mov", mov, "1.2.3.4.2")):
        CreateDicomImage(str(folder / name), np.round(arr).astype(np.int16),
                         series=uid, origin=ORIGIN, spacing=SPACING[:2],
                         thickness=SPACING[2]).run()


def residual(warped, fixed):
    inside = (warped != BG)
    return np.abs(warped - fixed)[inside].mean()


def test_deformable_slice_matches_jax(tmp_path):
    write_pair(tmp_path)
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    ref_name, mov_name = TData.image_list
    fixed = TData.image[ref_name].array.astype(np.float32)
    moving = TData.image[mov_name].array.astype(np.float32)

    # demons -> create_image -> compute_jacobian
    j_def = JDeformable(reference_name=ref_name, moving_name=mov_name,
                        roi_names=[])
    j_def.compute_demons(method="fast", iterations=8, crop=0)
    t_def = tmia.Deformable(reference_name=ref_name, moving_name=mov_name,
                            roi_names=[], device="cpu")
    info = t_def.compute_demons(method="fast", iterations=8, crop=0)
    assert t_def.deformable_name == j_def.deformable_name \
        == f"DVF_{ref_name}_{mov_name}"
    assert TData.deformable[t_def.deformable_name] is t_def
    assert info["level_shapes"] == [SHAPE]
    np.testing.assert_array_equal(t_def.origin, j_def.origin)
    assert t_def.spacing == j_def.spacing
    assert t_def.dvf.shape == SHAPE + (3,) and t_def.dvf.dtype == np.float32
    # iterated solvers: 0.15 mm on the field (module docstring of
    # tests/test_torch_demons.py), 2 % on the warp residual
    assert np.abs(t_def.dvf - j_def.dvf).max() < 0.15
    t_img, j_img = t_def.create_image(), j_def.create_image()
    assert t_img["array"].shape == SHAPE
    np.testing.assert_array_equal(t_img["origin"], j_img["origin"])
    r_t = residual(t_img["array"], fixed)
    r_j = residual(np.asarray(j_img["array"]), fixed)
    assert r_t < 0.7 * residual(moving, fixed)
    assert abs(r_t - r_j) <= 0.02 * r_j
    t_jac, j_jac = t_def.compute_jacobian(), j_def.compute_jacobian()
    np.testing.assert_allclose(t_jac["det"], j_jac["det"], rtol=0,
                               atol=0.05)
    assert t_jac["folding_fraction"] == j_jac["folding_fraction"] == 0.0

    # B-spline through a rigid pre-transform -> create_image
    kw = dict(control_spacing=[15, 15, 15], iterations=20, crop=0)
    j_bs = JDeformable(reference_name=ref_name, moving_name=mov_name,
                       roi_names=[], rigid_matrix=RIGID)
    j_bs.compute_bspline(**kw)
    t_bs = tmia.Deformable(reference_name=ref_name, moving_name=mov_name,
                           roi_names=[], rigid_matrix=RIGID, device="cpu")
    t_bs.compute_bspline(**kw)
    assert t_bs.deformable_name == f"DVF_{ref_name}_{mov_name}_1"
    assert np.abs(t_bs.dvf - j_bs.dvf).max() < 0.05
    assert np.abs(t_bs.dvf).max() > 0.5
    t_img, j_img = t_bs.create_image(), j_bs.create_image()
    assert np.isfinite(t_img["array"]).all()
    r_t = residual(t_img["array"], fixed)
    r_j = residual(np.asarray(j_img["array"]), fixed)
    assert abs(r_t - r_j) <= 0.02 * r_j


def test_deformable_from_numpy_carries_a_jax_field(tmp_path):
    """A JAX field carried into the port gives the same deformed image:
    the inversion, the ``coords`` sample of the inverse field and the
    ``disp`` warp agree to f32 rounding (the JAX CPU path contracts some
    products into FMAs), times the image's largest step per voxel."""
    write_pair(tmp_path)
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    ref_name, mov_name = TData.image_list
    j_def = JDeformable(reference_name=ref_name, moving_name=mov_name,
                        roi_names=[], rigid_matrix=RIGID)
    j_def.compute_demons(method="demons", iterations=6, crop=0)
    t_def = interop.deformable_from_numpy(
        j_def.dvf, j_def.origin, j_def.spacing, ref_name, mov_name,
        rigid_matrix=j_def.rigid_matrix, name="carried", device="cpu")
    assert TData.deformable_list == ["carried"]
    np.testing.assert_array_equal(t_def.dvf, j_def.dvf)
    for ratio in (1, 0.5):
        out = t_def.create_image(ratio=ratio)["array"]
        ref = np.asarray(j_def.create_image(ratio=ratio)["array"])
        vol = TData.image[mov_name].array.astype(np.float32)
        max_step = max(np.abs(np.diff(vol, axis=k)).max() for k in range(3))
        both = (out != BG) & (ref != BG)
        assert both.mean() > 0.75
        np.testing.assert_allclose(out[both], ref[both], rtol=0,
                                   atol=1e-4 * max_step)
        assert ((out == BG) != (ref == BG)).mean() < 1e-3
    np.testing.assert_allclose(t_def.compute_jacobian()["det"],
                               j_def.compute_jacobian()["det"], rtol=0,
                               atol=1e-5)


def test_compute_biomechanical_matches_jax(tmp_path):
    write_pair(tmp_path)
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    ref_name, mov_name = TData.image_list
    kw = dict(iterations=6, crop=0, elastic_lambda=0.3)
    j_def = JDeformable(reference_name=ref_name, moving_name=mov_name,
                        roi_names=[])
    j_def.compute_biomechanical(**kw)
    t_def = tmia.Deformable(reference_name=ref_name, moving_name=mov_name,
                            roi_names=[], device="cpu")
    t_def.compute_biomechanical(**kw)
    assert np.abs(t_def.dvf).max() > 0.3
    assert np.abs(t_def.dvf - j_def.dvf).max() < 0.15


@pytest.mark.parametrize("method,args", [("compute_tps", ())])
def test_waiting_methods_name_their_roadmap_item(method, args):
    """``compute_tps`` is ported (tests/test_torch_tps.py holds it against
    the JAX package): given half a point pair it raises the JAX package's
    ValueError. The Display's mesh cut is ported too
    (tests/test_torch_mesh_slice.py): with no moving image it has no mesh
    to cut and returns [], as the JAX package's does."""
    d = tmia.Deformable(device="cpu")
    assert d.deformable_name == "DVF_Unknown"
    with pytest.raises(ValueError, match="together"):
        getattr(d, method)(*args, points_reference=np.zeros((3, 3)))
    assert d.display.compute_mesh_slice("PTV") == \
        JDeformable().display.compute_mesh_slice("PTV") == []


@pytest.mark.parametrize("method", ["load_deformable", "create_reg",
                                    "save_deformable", "export_image"])
def test_io_methods_now_work(tmp_path, method):
    """The IO slice's Deformable methods are real: a field saved, loaded,
    written as a REG and exported (tests/test_torch_reg.py,
    test_torch_save_load.py and test_torch_export.py hold each against
    the JAX package)."""
    for k, name in enumerate(("ref", "mov")):
        img = interop.image_from_arrays(
            np.zeros((4, 12, 12), np.int16), [1.0, 1.0, 2.0],
            [0.0, 0.0, 0.0], np.eye(3), "CT", name)
        img.sops = [f"1.2.3.{k}.{i}" for i in range(4)]
    dvf = np.full((4, 12, 12, 3), 0.25, np.float32)
    d = tmia.Deformable(dvf=dvf, origin=np.zeros(3),
                        spacing=(1.0, 1.0, 2.0), dimensions=(4, 12, 12),
                        reference_name="ref", moving_name="mov",
                        roi_names=[], registration_name="F", device="cpu")
    if method == "create_reg":
        ds = d.create_reg(path=str(tmp_path / "dreg.dcm"))
        assert len(ds.DeformableRegistrationSequence) == 1
        assert (tmp_path / "dreg.dcm").exists()
    elif method == "export_image":
        d.export_image(str(tmp_path / "out.mhd"))
        assert (tmp_path / "out.raw").exists()
    else:
        d.save_deformable(str(tmp_path / "saved"))
        if method == "load_deformable":
            back = tmia.Deformable.load_deformable(str(tmp_path / "saved"))
            assert back.deformable_name == "F_1"
            np.testing.assert_array_equal(back.dvf.numpy(), dvf)
        else:
            assert (tmp_path / "saved" / "dvf.npy").exists()


def test_backend_masks_crop_and_blur_match_jax():
    """The backend's mask handling (what ``roi_names`` feeds it,
    tests/test_torch_masked_registration.py) and its elastix against
    DeformableJAX."""
    img = phantom().astype(np.float32)
    mask = np.zeros(SHAPE, np.float32)
    mask[4:12, 8:24, 6:20] = 1.0
    mmask = np.roll(mask, 2, axis=2)
    backends = [DeformableJAX(), DeformableTorch(device="cpu")]
    for b in backends:
        b.create_volume(img, ORIGIN, SPACING, np.eye(3))
        b.create_volume(np.roll(img, 1, axis=2), ORIGIN, SPACING, np.eye(3),
                        reference=False)
        b.create_volume(mask, ORIGIN, SPACING, np.eye(3), mask=True)
        b.create_volume(mmask, ORIGIN, SPACING, np.eye(3), reference=False,
                        mask=True)
        b.mask_crop(margin=2)
        b.blur_mask(sigma=2)
        b.cross_modality_correction()
    j, t = backends
    for key in ("reference_image", "moving_image", "reference_mask",
                "moving_mask"):
        np.testing.assert_array_equal(getattr(t, key)["origin"],
                                      getattr(j, key)["origin"])
        a, b = getattr(t, key)["array"], np.asarray(getattr(j, key)["array"])
        assert a.shape == b.shape == (12, 20, 20)
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
    # elastix is ported: on the cropped, masked pair, mean squares, the
    # field within tests/test_torch_bspline.py's 0.05 mm
    out_t, out_j = (b.elastix(resolution=1, spacing=12, iterations=5,
                              crop=0) for b in (t, j))
    assert out_t["array"].shape == (12, 20, 20, 3)
    np.testing.assert_array_equal(out_t["origin"], out_j["origin"])
    assert np.abs(out_t["array"] - np.asarray(out_j["array"])).max() < 0.05
