"""The ROI mesh path in both packages on the CPU, on one synthetic DICOM
study read by each: a CT of 8 x 40 x 44 with a body, an RTSTRUCT with a
spherical PTV, an annular ring (an XOR hole) and a ROI contoured on
every other slice, two POIs, and an RTDOSE.

Tolerances, stated per check:
- masks, pixel contours, discrete meshes (the table path): bit-equal;
- physical contour positions: 1e-9 mm;
- smoothed meshes (``create_mesh``, ``create_display_mesh``): 1e-9 mm,
  the umbrella sums' order aside;
- the mesh warps of ``Rigid``: 1e-9 mm (the same float64 matrices);
- ``Deformable.update_rois`` / ``update_pois``: 1e-5 mm. The field is
  sampled by the ``coords`` plain twin, within float32 rounding of the
  JAX package's XLA gather.
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series, write_rtstruct
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import warp as twarp
from medicalimageanalysis_torch.structure.deformable import (
    Deformable as TDeformable)
from medicalimageanalysis_torch.utils.image.threshold import (
    external as t_external)
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.structure.deformable import (
    Deformable as JDeformable)
from medicalimageanalysis_tpu.utils.image.threshold import (
    external as j_external)
from test_deformable_dose import write_rtdose_file

SHAPE = (8, 40, 44)               # CT (z, y, x)
ORIGIN = (-22.0, -20.0, -8.0)
SPACING = (1.0, 1.0)
THICK = 2.0
SCALING = 1e-6


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


def circle(info, s, cx, cy, r, n=24):
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    z = info["origin"][2] + s * info["thickness"]
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a),
                     np.full(n, z)], axis=1)


def write_case(folder):
    r = np.random.default_rng(11)
    zz, yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1], 0:SHAPE[2]]
    body = ((yy - 20) / 15.0) ** 2 + ((xx - 22) / 18.0) ** 2 < 1.0
    ct = np.where(body, r.integers(-100, 200, SHAPE),
                  r.integers(-1000, -900, SHAPE)).astype(np.int16)
    ct[:, 20, 3] = 50                 # a stray bright voxel off the body
    info = write_ct_series(folder / "ct", ct, origin=ORIGIN,
                           spacing=SPACING, thickness=THICK)
    rois = {
        "PTV": [(circle(info, s, 1.3, 2.1, 3.0 + 2 * min(s - 1, 6 - s)), s)
                for s in range(1, 7)],
        "Ring": [(circle(info, s, -4.0, 0.5, 10.0), s) for s in range(2, 6)]
        + [(circle(info, s, -4.0, 0.5, 4.5, n=16), s) for s in range(2, 6)],
        # contoured on every other slice, shrinking: interpolate_slices
        "Sparse": [(circle(info, s, 6.0, -4.0, 7.0 - s), s)
                   for s in (1, 3, 5)],
    }
    write_rtstruct(folder / "ct" / "rs.dcm", info, rois,
                   pois={"Iso": [1.0, 2.0, -2.0], "Apex": [-6.5, 4.25, 0.5]})
    zd, yd, xd = np.mgrid[0:6, 0:22, 0:24].astype(np.float64)
    dose = 5.0 + 55.0 * np.exp(-(((xd - 11) * 2) ** 2 + ((yd - 10) * 2) ** 2
                                 + ((zd - 3) * 3) ** 2) / (2 * 8.0 ** 2))
    dose_info = dict(info, origin=np.array([-23.0, -21.0, -9.0]),
                     spacing=np.array([2.0, 2.0]), thickness=3.0)
    write_rtdose_file(folder / "ct" / "rd.dcm",
                      np.round(dose / SCALING).astype(np.uint32),
                      dose_info, scaling=SCALING)


@pytest.fixture
def case(tmp_path):
    write_case(tmp_path)
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path))
    assert TData.image_list == JData.image_list == ["CT 01"]
    return TData.image["CT 01"], JData.image["CT 01"]


def same_contours(t_pix, t_pos, j_pix, j_pos):
    assert len(t_pix) == len(j_pix) and len(t_pos) == len(j_pos)
    for a, b in zip(t_pix, j_pix):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t_pos, j_pos):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def same_mesh(t, j, atol=0.0):
    assert t.points.shape == j.points.shape
    np.testing.assert_array_equal(t.faces, j.faces)
    if atol:
        np.testing.assert_allclose(t.points, j.points, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(t.points, j.points)


def same_roi(t, j, atol=0.0):
    same_contours(t.contour_pixel, t.contour_position, j.contour_pixel,
                  j.contour_position)
    same_mesh(t.mesh, j.mesh, atol)
    np.testing.assert_allclose(t.volume, j.volume, rtol=1e-12)
    np.testing.assert_array_equal(t.com, j.com)
    np.testing.assert_array_equal(t.bounds, j.bounds)


@pytest.mark.parametrize("name", ["PTV", "Ring", "Sparse"])
def test_convert_mask_matches_jax(case, name):
    t, j = case
    mask = np.asarray(j.rois[name].compute_mask())
    np.testing.assert_array_equal(t.rois[name].compute_mask(), mask)
    t.rois[name].convert_mask(mask)
    j.rois[name].convert_mask(mask)
    same_contours(t.rois[name].contour_pixel, t.rois[name].contour_position,
                  j.rois[name].contour_pixel, j.rois[name].contour_position)
    # the display mesh: the discrete surface, Taubin-smoothed
    same_mesh(t.rois[name].mesh, j.rois[name].mesh, atol=1e-9)
    assert t.rois[name].mesh.number_of_points > 0
    # the round trip reproduces the mask (holes included)
    np.testing.assert_array_equal(t.rois[name].compute_mask(),
                                  np.asarray(j.rois[name].compute_mask()))


@pytest.mark.parametrize("name", ["PTV", "Ring"])
def test_create_meshes_match_jax(case, name):
    t, j = case
    t.rois[name].create_discrete_mesh()
    j.rois[name].create_discrete_mesh()
    same_roi(t.rois[name], j.rois[name])
    t.rois[name].create_display_mesh()
    j.rois[name].create_display_mesh()
    same_mesh(t.rois[name].mesh, j.rois[name].mesh, atol=1e-9)
    t.rois[name].create_mesh()
    j.rois[name].create_mesh()
    same_roi(t.rois[name], j.rois[name], atol=1e-9)
    dec_t = t.rois[name].create_decimate_mesh(percent=0.5)
    dec_j = j.rois[name].create_decimate_mesh(percent=0.5)
    same_mesh(dec_t, dec_j, atol=1e-9)
    assert dec_t.number_of_points < t.rois[name].mesh.number_of_points


def test_update_pixel_and_mesh_slice_match_jax(case):
    t, j = case
    pix = [np.asarray(c) for c in j.rois["PTV"].contour_pixel]
    for img in (t, j):
        img.rois["PTV"].update_pixel(pix, plane="Axial")
    same_roi(t.rois["PTV"], j.rois["PTV"], atol=1e-9)
    for plane, loc in (("Axial", [1.3, 2.1, -1.0]),
                       ("Coronal", [1.3, 2.0, 0.0]),
                       ("Sagittal", [1.0, 2.1, 0.0])):
        for pixel in (False, True):
            tl, _ = t.rois["PTV"].compute_mesh_slice(
                location=loc, slice_plane=plane, offset=0.5,
                return_pixel=pixel)
            jl, _ = j.rois["PTV"].compute_mesh_slice(
                location=loc, slice_plane=plane, offset=0.5,
                return_pixel=pixel)
            assert len(tl) == len(jl) > 0
            for a, b in zip(tl, jl):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    for img in (t, j):
        img.rois["PTV"].update_pixel([])
        assert img.rois["PTV"].mesh is None


def test_interpolate_slices_matches_jax(case):
    t, j = case
    before = t.rois["Sparse"].compute_mask()
    t.rois["Sparse"].interpolate_slices()
    j.rois["Sparse"].interpolate_slices()
    same_contours(t.rois["Sparse"].contour_pixel,
                  t.rois["Sparse"].contour_position,
                  j.rois["Sparse"].contour_pixel,
                  j.rois["Sparse"].contour_position)
    same_mesh(t.rois["Sparse"].mesh, j.rois["Sparse"].mesh, atol=1e-9)
    after = t.rois["Sparse"].compute_mask()
    assert after.sum() > before.sum() and after[2].sum() > 0
    np.testing.assert_array_equal(after,
                                  np.asarray(j.rois["Sparse"].compute_mask()))


def test_create_external_matches_jax(case):
    t, j = case
    arr = np.asarray(j.array)
    for kw in ({}, {"threshold": 0}, {"less_than": True, "threshold": -500}):
        tm = t_external(arr, only_mask=False, **kw)
        jm = j_external(arr, only_mask=False, **kw)
        for a, b in zip(tm, jm):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
    roi_t = t.create_external()
    roi_j = j.create_external()
    same_roi(roi_t, roi_j)
    np.testing.assert_array_equal(roi_t.compute_mask(),
                                  np.asarray(roi_j.compute_mask()))
    assert roi_t.color == roi_j.color == [0, 255, 0]


def test_margin_and_boolean_rois_match_jax(case):
    t, j = case
    for img, backend in ((t, "scipy"), (j, "scipy")):
        img.create_roi_from_margin("PTV_5", "PTV", 3.3, backend=backend)
        img.create_roi_from_boolean("Ring_PTV", "subtract", "PTV_5", "PTV")
        img.create_roi_from_boolean("Union", "union", "Ring", "PTV")
    for name in ("PTV_5", "Ring_PTV", "Union"):
        same_roi(t.rois[name], j.rois[name], atol=1e-9)
        np.testing.assert_array_equal(t.rois[name].compute_mask(),
                                      np.asarray(j.rois[name].compute_mask()))
    assert sorted(TData.roi_list) == sorted(JData.roi_list)
    # the default backend is the device's exact EDT (float32 distances:
    # a margin off every voxel distance, so no tie can break differently)
    dev = t.create_roi_from_margin("PTV_5d", "PTV", 3.3)
    np.testing.assert_array_equal(dev.compute_mask(),
                                  t.rois["PTV_5"].compute_mask())


@pytest.mark.parametrize("percent_of", [None, 60.0])
def test_isodose_contours_match_jax(case, percent_of):
    td, jd = TData.dose["RTDOSE 01"], JData.dose["RTDOSE 01"]
    levels = None if percent_of is None else [20, 50, 95]
    t_out = td.compute_isodose_contours(levels=levels, percent_of=percent_of)
    j_out = jd.compute_isodose_contours(levels=levels, percent_of=percent_of)
    assert list(t_out) == list(j_out) and len(t_out) in (3, 9)
    for level, (pix, pos) in j_out.items():
        same_contours(*t_out[level], pix, pos)
    assert sum(len(p) for p, _ in t_out.values()) > 0


def visible(*imgs):
    for img in imgs:
        for roi in img.rois.values():
            roi.visible = True


@pytest.mark.parametrize("inverse", [False, True])
def test_rigid_update_rois_copy_roi_and_pois_match_jax(case, inverse):
    t, j = case
    for img in (t, j):
        for name in ("PTV", "Ring"):
            img.rois[name].create_discrete_mesh()
    visible(t, j)
    matrix = np.eye(4)
    c, s = np.cos(0.1), np.sin(0.1)
    matrix[:2, :2] = [[c, -s], [s, c]]
    matrix[:3, 3] = [1.5, -2.0, 0.75]
    rigids = []
    for mia in (tmia, jmia):
        rigid = mia.Rigid("CT 01", "CT 01", matrix=matrix.copy())
        rigid.inverse = inverse
        rigid.update_rois()
        rigids.append(rigid)
    rt, rj = rigids
    assert sorted(rt.rois) == sorted(rj.rois)
    for name, mesh in rj.rois.items():
        if mesh is None:
            assert rt.rois[name] is None
        else:
            same_mesh(rt.rois[name], mesh, atol=1e-9)
    assert rt.rois["PTV"] is not None
    pt, pj = rt.update_pois(), rj.update_pois()
    assert list(pt) == list(pj) == ["Iso", "Apex"]
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], rtol=0, atol=1e-12)
    np.testing.assert_allclose(rt.update_pois("Iso")["Iso"], pj["Iso"],
                               rtol=0, atol=1e-12)
    rt.copy_roi("Ring")
    rj.copy_roi("Ring")
    same_mesh(t.rois["Ring"].mesh, j.rois["Ring"].mesh, atol=1e-9)
    same_mesh(rt.rois["Ring"], rj.rois["Ring"], atol=1e-9)


def smooth_field():
    zz, yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1], 0:SHAPE[2]]
    bump = np.exp(-((xx - 20) ** 2 + (yy - 18) ** 2) / 120.0
                  - (zz - 3.5) ** 2 / 20.0)
    dvf = np.stack([1.7 * bump, -1.2 * bump, 0.6 * bump], -1)
    return dvf.astype(np.float32)


@pytest.mark.parametrize("percent", [100, 50])
def test_deformable_update_rois_and_pois_match_jax(case, percent):
    t, j = case
    for img in (t, j):
        img.rois["PTV"].create_discrete_mesh()
        img.rois["Ring"].create_discrete_mesh()
        img.create_external()
    visible(t, j)
    rigid = np.eye(4)
    rigid[:3, 3] = [0.5, -0.25, 0.0]
    kw = dict(dvf=smooth_field(), origin=np.asarray(t.origin),
              spacing=tuple(t.spacing), rigid_matrix=rigid,
              reference_name="CT 01", moving_name="CT 01")
    dt, dj = TDeformable(device="cpu", **kw), JDeformable(**kw)
    before = twarp.LAUNCHES["warp_coords"]
    dt.update_rois(percent=percent)
    dj.update_rois(percent=percent)
    # on the CPU the plain twin ran: no kernel launch
    assert twarp.LAUNCHES["warp_coords"] == before
    assert sorted(dt.rois) == sorted(dj.rois)
    for name, mesh in dj.rois.items():
        if mesh is None:
            assert dt.rois[name] is None
            continue
        same_mesh(dt.rigid_rois[name], dj.rigid_rois[name], atol=1e-9)
        same_mesh(dt.rois[name], mesh, atol=1e-5)
        moved = np.abs(dt.rois[name].points - dt.rigid_rois[name].points)
        assert moved.max() > 0.2 * percent / 100
    pt = dt.update_pois(percent=percent)
    pj = dj.update_pois(percent=percent)
    assert list(pt) == list(pj) == ["Iso", "Apex"]
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], rtol=0, atol=1e-5)


def test_corner_sides_match_jax(case):
    t, j = case
    same_mesh(t.compute_corner_sides(), j.compute_corner_sides())
    td, jd = TData.dose["RTDOSE 01"], JData.dose["RTDOSE 01"]
    same_mesh(td.compute_corner_sides(), jd.compute_corner_sides())


def test_mesh_path_raises_without_a_card_unless_asked(case, monkeypatch):
    t, _ = case
    set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t.rois["PTV"].create_discrete_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TData.dose["RTDOSE 01"].compute_isodose_contours()
