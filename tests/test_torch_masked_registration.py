"""Registration masked by ``roi_names`` through both packages, on the CPU:
each name whose ROI both images hold (contoured, or mesh-only and
voxelized) adds its mask to the reference's and the moving image's union (JAX
structure/deformable.py:346-365); the unions go to the backend, blurred,
crop the pair to their joint box and mask the demons' volumes and the
B-spline's loss.

Tolerances:
- the mask unions bit-equal (the same rasterized contours, summed);
- the backend's blurred masks and cropped volumes within 1e-5 of the
  largest magnitude (tests/test_torch_deformable.py's backend bound),
  crop boxes and origins equal;
- residual ratios inside the union (ROADMAP.md's watch list) within 2 %
  of the JAX package's, the rule of tests/test_torch_deformable.py. The
  masked B-spline leaves the union worse than it found it in both
  packages (ratio 9.6): its loss weighs by the warped moving mask, which
  the fit can move off the voxels that disagree (ROADMAP.md queue 3).
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import square_contour_mm, write_ct_series, write_rtstruct
from medicalimageanalysis_torch import interop
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_tpu.data import Data as JData

SHAPE = (16, 32, 32)
RATIO_RTOL = 0.02


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


def write_pair_with_rois(folder):
    """The reference phantom and its bump-deformed copy (1.5 / 1.2
    voxels), each with an RTSTRUCT of "Body" (a box of most of the
    volume) and "Core" (an inner box) drawn at the same place."""
    ref = phantom()
    zz, yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1], 0:SHAPE[2]] \
        .astype(np.float64)
    bump = np.exp(-((zz - 8) ** 2 / 40 + (yy - 16) ** 2 / 60
                    + (xx - 16) ** 2 / 60))
    mov = ndimage.map_coordinates(ref, [zz, yy + 1.2 * bump,
                                        xx + 1.5 * bump],
                                  order=1, mode="nearest")
    for name, arr, off, modality in (("ref", ref, 0, "CT"),
                                     ("mov", mov, 0, "MR")):
        info = write_ct_series(folder / name, np.round(arr).astype(np.int16),
                               origin=(-24.0, -20.0, -20.0),
                               spacing=(1.5, 1.5), thickness=2.5,
                               modality=modality)
        rois = {"Body": [(square_contour_mm(info, z, 7 + off, 24 + off), z)
                         for z in range(4, 12)],
                "Core": [(square_contour_mm(info, z, 11 + off, 20 + off), z)
                         for z in range(6, 10)]}
        write_rtstruct(folder / name / "rs.dcm", info, rois)
    jmia.read_dicoms(folder_path=str(folder))
    tmia.read_dicoms(folder_path=str(folder), device="cpu")
    ct = [n for n in JData.image_list if JData.image[n].modality == "CT"][0]
    mr = [n for n in JData.image_list if JData.image[n].modality == "MR"][0]
    return ct, mr


def jax_union(ct, mr, names):
    """The JAX package's _backend recipe, on its own images."""
    ref_mask = mov_mask = None
    for n in names:
        r, m = JData.image[ct].rois.get(n), JData.image[mr].rois.get(n)
        if r is None or m is None:
            continue
        rm, mm = np.asarray(r.compute_mask()), np.asarray(m.compute_mask())
        ref_mask = rm if ref_mask is None else ref_mask + rm
        mov_mask = mm if mov_mask is None else mov_mask + mm
    return ref_mask, mov_mask


NAMES = {"body": ["Body"], "body_core": ["Body", "Core"],
         "core_and_missing": ["Core", "Missing"], "none_held": ["Missing"]}


@pytest.mark.parametrize("case", sorted(NAMES))
def test_mask_union_and_backend_match_jax(tmp_path, case):
    ct, mr = write_pair_with_rois(tmp_path)
    names = NAMES[case]
    t = tmia.Deformable(reference_name=ct, moving_name=mr, roi_names=names,
                        device="cpu")
    j = jmia.Deformable(reference_name=ct, moving_name=mr, roi_names=names)
    ref_mask, mov_mask = t.roi_mask_union()
    jref, jmov = jax_union(ct, mr, names)
    if jref is None:
        assert ref_mask is None and mov_mask is None
    else:
        assert ref_mask.dtype == jref.dtype
        np.testing.assert_array_equal(ref_mask, jref)
        np.testing.assert_array_equal(mov_mask, jmov)
        assert ref_mask.max() == (2 if case == "body_core" else 1)
    tb, jb = t._backend(True, 2), j._backend(True, 2)
    for b in (tb, jb):
        b.resample()
        b.mask_crop(margin=5)
    for key in ("reference_image", "moving_image", "reference_mask",
                "moving_mask"):
        tv, jv = getattr(tb, key), getattr(jb, key)
        if jv is None:
            assert tv is None
            continue
        np.testing.assert_array_equal(tv["origin"], jv["origin"])
        a, b = tv["array"], np.asarray(jv["array"])
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def ratio_in_mask(img, ref, mov, mask):
    keep = (mask > 0) & (img != -3001.0)
    return float(np.abs(img - ref)[keep].mean()
                 / np.abs(mov - ref)[keep].mean())


@pytest.mark.parametrize("method,kw", [
    ("compute_demons", dict(method="fast", iterations=8)),
    ("compute_demons", dict(method="diffeomorphic", iterations=8,
                            crop=0)),
    ("compute_bspline", dict(control_spacing=[15, 15, 15],
                             iterations=20))],
    ids=["fast_demons", "diffeomorphic_uncropped", "bspline"])
def test_masked_registration_matches_jax(tmp_path, method, kw):
    ct, mr = write_pair_with_rois(tmp_path)
    t = tmia.Deformable(reference_name=ct, moving_name=mr,
                        roi_names=["Body", "Core"], device="cpu")
    j = jmia.Deformable(reference_name=ct, moving_name=mr,
                        roi_names=["Body", "Core"])
    getattr(t, method)(**kw)
    getattr(j, method)(**kw)
    np.testing.assert_array_equal(t.origin, j.origin)
    assert tuple(t.dimensions) == tuple(j.dimensions)
    ref = TData.image[ct].array.astype(np.float32)
    mov = TData.image[mr].array.astype(np.float32)
    mask, _ = t.roi_mask_union()
    r_t = ratio_in_mask(t.create_image()["array"], ref, mov, mask)
    r_j = ratio_in_mask(np.asarray(j.create_image()["array"]), ref, mov,
                        mask)
    assert abs(r_t - r_j) <= RATIO_RTOL * r_j, (r_t, r_j)
    if method == "compute_demons":
        assert r_t < 0.5


def test_masked_registration_on_a_mesh_only_roi_waits(tmp_path):
    """A mesh-only ROI's mask is its mesh voxelized (Roi.compute_mask):
    the union equals the JAX package's bit for bit, and the masked demons
    on it leaves the residual inside the union within 2 % of the JAX
    package's (the name is the test's from before voxelisation was
    ported, when this raised)."""
    ct, mr = write_pair_with_rois(tmp_path)
    from medicalimageanalysis_torch.utils.mesh.trimesh import box_mesh
    from medicalimageanalysis_tpu.utils.mesh.trimesh import TriMesh
    box = box_mesh(np.array([-15.0, -10, -10]), np.array([10.0, 12, 10]))
    for name in (ct, mr):
        interop.meshes_from_numpy(TData.image[name],
                                  {"Shell": (box.points, box.faces)})
        assert TData.image[name].rois["Shell"].contour_pixel is None
        JData.image[name].create_roi(name="Shell", visible=True)
        JData.image[name].rois["Shell"].update_mesh(
            TriMesh(box.points.copy(), box.faces.copy()))
    t = tmia.Deformable(reference_name=ct, moving_name=mr,
                        roi_names=["Shell"], device="cpu")
    j = jmia.Deformable(reference_name=ct, moving_name=mr,
                        roi_names=["Shell"])
    mask, mov_mask = t.roi_mask_union()
    jref, jmov = jax_union(ct, mr, ["Shell"])
    np.testing.assert_array_equal(mask, jref)
    np.testing.assert_array_equal(mov_mask, jmov)
    assert mask.sum() > 1000
    for d in (t, j):
        d.compute_demons(method="fast", iterations=2)
    ref = TData.image[ct].array.astype(np.float32)
    mov = TData.image[mr].array.astype(np.float32)
    r_t = ratio_in_mask(t.create_image()["array"], ref, mov, mask)
    r_j = ratio_in_mask(np.asarray(j.create_image()["array"]), ref, mov,
                        mask)
    assert abs(r_t - r_j) <= RATIO_RTOL * r_j, (r_t, r_j)
