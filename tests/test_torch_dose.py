"""The dose-QA path in both packages, end to end on the CPU: a CT series,
an RTSTRUCT referencing it and an RTDOSE (uint32 pixels, values up to
4e9, with DoseGridScaling) are written with tests/helpers.py and read by
both; then ROI masks, the dose grid, the ROI dose arrays, the DVH
statistics and curves, and the deformable dose and mask warps.

Tolerances, stated per check:
- masks, the dose grid (uint32 -> float32 -> * scaling) and voxel counts:
  bit-equal;
- ``compute_roi_dose_array``: 1e-4 Gy. The resample's affine coordinates
  differ by a few ulp (XLA on the CPU contracts the coefficient sums into
  FMAs, the port does not: ROADMAP.md queue 3); the dose values follow
  times the dose gradient;
- DVH statistics: the same 1e-4 Gy on dose values, 1e-6 relative on
  top; the VS voxel counts equal;
- ``update_dose`` on the same (JAX) field: 1e-4 times the largest dose
  step per voxel; ``update_mask``: bit-equal (a bit could flip only
  where the warped indicator sits within f32 rounding of the threshold;
  none does here).
"""

import types

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series, write_rtstruct
from medicalimageanalysis_torch import interop
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import hist as thist
from medicalimageanalysis_torch.structure import dose as tdose
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.structure.deformable import (
    Deformable as JDeformable)
from test_deformable_dose import write_rtdose_file

SHAPE = (10, 32, 36)              # CT (z, y, x)
CT_ORIGIN = (-18.0, -16.0, -10.0)
CT_SPACING = (1.0, 1.0)
CT_THICK = 2.0
SCALING = 1.5e-8                  # 60 Gy -> 4.0e9 stored


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


def star(info, s, cx, cy, n=14):
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = np.where(np.arange(n) % 2, 3.0, 8.5)
    z = info["origin"][2] + s * info["thickness"]
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a),
                     np.full(n, z)], axis=1)


def dose_grid():
    """(Z, Y, X) Gy on a 1.5 x 1.5 x 2.5 mm grid offset from the CT:
    60 Gy at a centre, falling off smoothly."""
    zz, yy, xx = np.mgrid[0:9, 0:26, 0:28].astype(np.float64)
    r2 = ((xx - 13) * 1.5) ** 2 + ((yy - 12) * 1.5) ** 2 \
        + ((zz - 4) * 2.5) ** 2
    return 5.0 + 55.0 * np.exp(-r2 / (2 * 9.0 ** 2))


def write_case(folder):
    r = np.random.default_rng(3)
    ct = r.integers(-200, 300, size=SHAPE).astype(np.int16)
    info = write_ct_series(folder / "ct", ct, origin=CT_ORIGIN,
                           spacing=CT_SPACING, thickness=CT_THICK)
    rois = {
        "PTV": [(circle(info, s, 1.3, 2.1, 4.0 + s % 3), s)
                for s in range(3, 8)],
        # outer + inner on the same slices: an XOR hole
        "Ring": [(circle(info, s, -2.0, 0.5, 11.0), s) for s in range(2, 7)]
        + [(circle(info, s, -2.0, 0.5, 5.5, n=16), s) for s in range(2, 7)],
        "Star": [(star(info, s, 4.0, -3.0), s) for s in range(1, 5)],
    }
    write_rtstruct(folder / "ct" / "rs.dcm", info, rois,
                   pois={"Iso": [1.0, 2.0, -2.0]})
    stored = np.round(dose_grid() / SCALING).astype(np.uint64)
    stored[0, 0, :4] = [2 ** 24 + 1, 2 ** 24 + 3, 4_000_000_001, 2 ** 32 - 1]
    dose_info = dict(info, origin=np.array([-20.5, -19.0, -11.0]),
                     spacing=np.array([1.5, 1.5]), thickness=2.5)
    write_rtdose_file(folder / "ct" / "rd.dcm", stored.astype(np.uint32),
                      dose_info, scaling=SCALING)
    return info


def read_both(folder):
    jmia.read_dicoms(folder_path=str(folder))
    reader = tmia.read_dicoms(folder_path=str(folder))
    return reader


def test_read_builds_rois_pois_and_dose(tmp_path):
    write_case(tmp_path)
    reader = read_both(tmp_path)
    assert TData.image_list == JData.image_list == ["CT 01"]
    assert TData.dose_list == JData.dose_list == ["RTDOSE 01"]
    assert reader.report.doses_created == ["RTDOSE 01"]
    t, j = TData.image["CT 01"], JData.image["CT 01"]
    assert sorted(t.rois) == sorted(j.rois) == ["PTV", "Ring", "Star"]
    assert sorted(TData.roi_list) == sorted(JData.roi_list)
    assert list(t.pois) == list(j.pois) == ["Iso"]
    np.testing.assert_array_equal(t.pois["Iso"].point_pixel,
                                  j.pois["Iso"].point_pixel)
    for name in t.rois:
        for a, b in zip(t.rois[name].contour_pixel,
                        j.rois[name].contour_pixel):
            np.testing.assert_array_equal(a, b)
    td, jd = TData.dose["RTDOSE 01"], JData.dose["RTDOSE 01"]
    # uint32 above 2^24 rounds to float32 as XLA's astype does
    assert td.array.dtype == np.float32
    np.testing.assert_array_equal(td.array, np.asarray(jd.array))
    for key in ("spacing", "origin", "matrix", "dimensions"):
        np.testing.assert_array_equal(getattr(td, key), getattr(jd, key))
    assert td.frame_ref == jd.frame_ref
    assert td.compute_dose_statistics() == jd.compute_dose_statistics()


def test_masks_match_jax(tmp_path):
    write_case(tmp_path)
    read_both(tmp_path)
    t, j = TData.image["CT 01"], JData.image["CT 01"]
    # the first compute_mask runs the pooled pass over every ROI
    first = t.rois["Ring"].compute_mask()
    assert first.dtype == np.uint8 and first.shape == SHAPE
    pooled = t.compute_roi_masks()
    for name in ("PTV", "Ring", "Star"):
        ref = np.asarray(j.rois[name].compute_mask())
        np.testing.assert_array_equal(pooled[name], ref, err_msg=name)
        np.testing.assert_array_equal(t.rois[name].compute_mask(), ref)
        np.testing.assert_array_equal(t.rois[name]._compute_mask_impl(),
                                      ref)
        assert ref.sum() > 0
    # the hole of the ring is empty
    assert pooled["Ring"][4].sum() < pooled["Ring"][4].size
    stats_t = t.compute_roi_statistics("PTV")
    assert stats_t == j.compute_roi_statistics("PTV")
    # a registration on an image with ROIs syncs their names
    rigid = tmia.Rigid("CT 01", "CT 01")
    assert sorted(rigid.rois) == sorted(TData.roi_list)
    # a contour rebind invalidates the cached mask
    roi = t.rois["Star"]
    roi.contour_pixel = roi.contour_pixel[:1]
    assert t.rois["Star"].compute_mask().sum() < pooled["Star"].sum()


def test_roi_dose_array_and_dvh_match_jax(tmp_path):
    write_case(tmp_path)
    read_both(tmp_path)
    td, jd = TData.dose["RTDOSE 01"], JData.dose["RTDOSE 01"]
    before = thist.LAUNCHES["dose_hist"]
    for name in ("PTV", "Ring", "Star"):
        tv, tcov = td.compute_roi_dose_array("CT 01", name,
                                             return_coverage=True)
        jv, jcov = jd.compute_roi_dose_array("CT 01", name,
                                             return_coverage=True)
        assert tv.dtype == np.float32 and tv.shape == jv.shape
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)
        assert tcov == jcov

        ts = td.compute_roi_dose_statistics("CT 01", name)
        js = jd.compute_roi_dose_statistics("CT 01", name)
        assert ts.keys() == js.keys()
        for key, value in js.items():
            if key == "ROI" or key.startswith("VS") or key == "Volume (cc)":
                assert ts[key] == value, key
            else:
                np.testing.assert_allclose(ts[key], value, rtol=1e-6,
                                           atol=1e-4, err_msg=key)

        tb, tp = td.compute_dvh_curve("CT 01", name)
        jb, jp = jd.compute_dvh_curve("CT 01", name)
        np.testing.assert_allclose(tb, jb, rtol=1e-6)
        assert tp.dtype == np.float32 and tp.shape == (300,)
        np.testing.assert_array_equal(tp, jp)
    # on the CPU the plain twin ran: no kernel launch
    assert thist.LAUNCHES["dose_hist"] == before
    # isodose contours (the port's tracer) equal the JAX package's (cv2)
    t_iso, j_iso = td.compute_isodose_contours(), jd.compute_isodose_contours()
    assert list(t_iso) == list(j_iso) and len(t_iso) == 9
    for level, (pix, pos) in j_iso.items():
        assert len(t_iso[level][0]) == len(pix) > 0
        for a, b in zip(t_iso[level][0], pix):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t_iso[level][1], pos):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def _rot_z(deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])


# (dose grid (Z, Y, X) or None for the RTDOSE on file, its spacing, origin
# and orientation matrix; the ROI; the COVERAGE entry it takes). The CT:
# 1 x 1 x 2 mm, origin (-18, -16, -10), identity orientation.
COVERAGE_CASES = {
    # the file's 1.5 x 1.5 x 2.5 mm grid, offset, over the whole CT
    "aligned": (None, None, None, None, "PTV", "axis"),
    # slices z >= 3 of the CT only
    "cropped": ((10, 32, 36), (1.0, 1.0, 2.0), (-18.0, -16.0, -4.0),
                np.eye(3), "Ring", "axis"),
    # 2 x 2 x 4 mm: the grid's faces fall on CT voxel centres, so the
    # ROI's edge voxels map to exactly -0.5 and dim - 0.5 on each axis
    "tie": ((2, 5, 5), (2.0, 2.0, 4.0), (-8.0, -5.0, -4.0), np.eye(3),
            "Ring", "axis"),
    # y runs the other way: a negative coefficient
    "flipped": ((10, 20, 36), (1.0, 1.0, 2.0), (-18.0, 6.0, -10.0),
                np.diag([1.0, -1.0, 1.0]), "Ring", "axis"),
    # a zero z row: every CT slice maps to dose slice 0
    "zero_axis": ((1, 32, 36), (1.0, 1.0, 2.0), (-18.0, -16.0, -10.0),
                  np.diag([1.0, 1.0, 0.0]), "Ring", "axis"),
    # 30 degrees about z, part of the ring outside: the general path
    "rotated": ((10, 24, 24), (1.0, 1.0, 2.0), (-14.0, -10.0, -10.0),
                _rot_z(30.0), "Ring", "general"),
    # a quarter turn about z on the tie's faces: ties on the general path
    "rotated_tie": ((2, 5, 5), (2.0, 2.0, 4.0), (1.0, -5.0, -4.0),
                    np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0],
                              [0.0, 0.0, 1.0]]), "Ring", "general"),
    # no voxel: 1.0, no evaluation
    "empty": (None, None, None, None, "Star", None),
}


def _register_coverage_dose(case):
    """The case's dose in both packages, under one name."""
    from medicalimageanalysis_torch.utils.dose import (
        register_dose_grid as t_register)
    from medicalimageanalysis_tpu.utils.dose import (
        register_dose_grid as j_register)

    shape, spacing, origin, matrix, _, _ = COVERAGE_CASES[case]
    if shape is None:
        return TData.dose["RTDOSE 01"], JData.dose["RTDOSE 01"]
    zz, yy, xx = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    array = (10.0 + zz + 0.5 * yy + 0.25 * xx).astype(np.float32)
    like = types.SimpleNamespace(
        plane="Axial", spacing=np.asarray(spacing), frame_ref="",
        orientation=np.asarray(matrix, float)[:2].ravel(),
        origin=np.asarray(origin), matrix=np.asarray(matrix, float))
    return (t_register(array, like, name=case),
            j_register(array, like, name=case))


def _reference_dose_px(dose, roi):
    """The float64 (N, 3) dose pixel coordinates of the ROI's voxels, as
    the JAX package computes them."""
    from medicalimageanalysis_torch.ops.resample import compose_pixel_matrix

    img = TData.image["CT 01"]
    A = compose_pixel_matrix(dose.matrix, dose.spacing, dose.origin,
                             img.matrix, img.spacing, img.origin)
    idx = np.argwhere(img.rois[roi].compute_mask() > 0)
    hom = np.concatenate([idx[:, ::-1].astype(np.float64),
                          np.ones((len(idx), 1))], axis=1)
    return (hom @ np.asarray(A, np.float64).T)[:, :3]


@pytest.mark.parametrize("case", list(COVERAGE_CASES))
def test_roi_dose_coverage_matches_jax(tmp_path, case):
    """The coverage counted on the device equals the JAX package's float64
    test of every voxel exactly, on the path the map's off-diagonals
    choose; the values stay the resample's."""
    write_case(tmp_path)
    read_both(tmp_path)
    roi, path = COVERAGE_CASES[case][4:]
    if case == "empty":
        for img in (TData.image["CT 01"], JData.image["CT 01"]):
            img.rois[roi].contour_pixel = []
    td, jd = _register_coverage_dose(case)
    if case in ("tie", "rotated_tie"):
        px = _reference_dose_px(td, roi)
        hi = np.asarray(td.dimensions, np.float64)[::-1] - 0.5
        assert ((px == -0.5).any(axis=0) & (px == hi).any(axis=0)).all()
    before = dict(tdose.COVERAGE)
    tv, tcov = td.compute_roi_dose_array("CT 01", roi, return_coverage=True)
    jv, jcov = jd.compute_roi_dose_array("CT 01", roi, return_coverage=True)
    assert tv.dtype == np.float32 and tv.shape == jv.shape
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)
    assert type(tcov) is float and tcov == jcov
    if case in ("aligned", "zero_axis", "empty"):
        assert tcov == 1.0
    else:
        assert 0.0 < tcov < 1.0
    expected = dict(before)
    if path:
        expected[path] += 1
    assert tdose.COVERAGE == expected
    # without return_coverage: the same values, no coverage work
    np.testing.assert_array_equal(
        td.compute_roi_dose_array("CT 01", roi), tv)
    assert tdose.COVERAGE == expected


@pytest.mark.parametrize("case", ["cropped", "rotated"])
def test_roi_dose_coverage_leaves_the_host_mask_alone(tmp_path, monkeypatch,
                                                      case):
    """With the mask on the default device the coverage needs no host pass
    over it: the same number with ``np.argwhere`` refusing."""
    write_case(tmp_path)
    read_both(tmp_path)
    td, jd = _register_coverage_dose(case)
    roi = COVERAGE_CASES[case][4]
    _, jcov = jd.compute_roi_dose_array("CT 01", roi, return_coverage=True)
    TData.image["CT 01"].rois[roi].compute_mask()

    def refuse(*args, **kwargs):
        raise AssertionError("np.argwhere on the host")

    monkeypatch.setattr(np, "argwhere", refuse)
    _, tcov = td.compute_roi_dose_array("CT 01", roi, return_coverage=True)
    assert tcov == jcov


def test_dvh_batch_agrees_with_per_roi_statistics(tmp_path):
    from medicalimageanalysis_torch.ops.resample import (
        affine_resample, compose_pixel_matrix)
    from medicalimageanalysis_torch.parallel.batch import dvh_batch
    from medicalimageanalysis_torch.utils.metrics import voxel_volume_cc

    write_case(tmp_path)
    tmia.read_dicoms(folder_path=str(tmp_path))
    img, dose = TData.image["CT 01"], TData.dose["RTDOSE 01"]
    names = ["PTV", "Ring", "Star"]
    masks = img.compute_roi_masks()
    A = compose_pixel_matrix(dose.matrix, dose.spacing, dose.origin,
                             img.matrix, img.spacing, img.origin)
    grid = affine_resample(dose.array, A, SHAPE, background=0.0).numpy()
    out = dvh_batch(np.stack([grid] * 3), np.stack([masks[n] for n in names]),
                    voxel_volume_cc(img.spacing))
    for b, name in enumerate(names):
        single = dose.compute_roi_dose_statistics("CT 01", name)
        for key in ("Volume (cc)", "Dmin", "Dmax", "D95", "VS20Gy_cc"):
            np.testing.assert_allclose(out[key][b], single[key], rtol=1e-6,
                                       err_msg=f"{name} {key}")
        np.testing.assert_allclose(out["Dmean"][b], single["Dmean"],
                                   rtol=1e-5)


def write_pair_with_dose(folder):
    """A reference CT, a moving CT (the reference shifted 1.5 voxels in
    x), each with its own frame of reference, and a dose tied to the
    moving frame."""
    zz, yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1], 0:SHAPE[2]]
    body = 900.0 * np.exp(-((zz - 5) / 4.0) ** 2 - ((yy - 16) / 9.0) ** 2
                          - ((xx - 18) / 10.0) ** 2) - 800.0
    mov = np.roll(body, 2, axis=2)
    write_ct_series(folder / "ref", np.round(body).astype(np.int16),
                    origin=CT_ORIGIN, spacing=CT_SPACING,
                    thickness=CT_THICK)
    info = write_ct_series(folder / "mov", np.round(mov).astype(np.int16),
                           origin=CT_ORIGIN, spacing=CT_SPACING,
                           thickness=CT_THICK)
    stored = np.round(dose_grid() / SCALING).astype(np.uint32)
    dose_info = dict(info, origin=np.array([-20.5, -19.0, -11.0]),
                     spacing=np.array([1.5, 1.5]), thickness=2.5)
    write_rtdose_file(folder / "mov" / "rd.dcm", stored, dose_info,
                      scaling=SCALING)


def test_update_dose_and_mask_match_jax(tmp_path):
    write_pair_with_dose(tmp_path)
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path))
    names = TData.image_list
    ref_name = [n for n in names
                if TData.image[n].filepaths[0].startswith(
                    str(tmp_path / "ref"))][0]
    mov_name = [n for n in names if n != ref_name][0]
    rigid = np.eye(4)
    rigid[0, 3] = 0.4
    j_def = JDeformable(reference_name=ref_name, moving_name=mov_name,
                        roi_names=[], rigid_matrix=rigid)
    j_def.compute_demons(method="fast", iterations=5, crop=0)
    t_def = interop.deformable_from_numpy(
        j_def.dvf, j_def.origin, j_def.spacing, ref_name, mov_name,
        rigid_matrix=j_def.rigid_matrix, name="carried")
    assert np.abs(j_def.dvf).max() > 0.2

    # the dose shares the moving frame: found without a name
    t_out = t_def.update_dose()
    j_out = j_def.update_dose()
    assert t_out["dose_name"] == j_out["dose_name"] == "RTDOSE 01"
    np.testing.assert_array_equal(t_out["origin"], j_out["origin"])
    dose = TData.dose["RTDOSE 01"].array
    max_step = max(np.abs(np.diff(dose, axis=k)).max() for k in range(3))
    j_arr = np.asarray(j_out["array"])
    assert t_out["array"].shape == SHAPE and j_arr.max() > 30.0
    np.testing.assert_allclose(t_out["array"], j_arr, rtol=0,
                               atol=1e-4 * max_step)

    mask = (TData.image[mov_name].array > -300).astype(np.uint8)
    t_mask = t_def.update_mask(mask)
    j_mask = np.asarray(j_def.update_mask(mask))
    assert t_mask.dtype == np.uint8 and t_mask.sum() > 0
    np.testing.assert_array_equal(t_mask, j_mask)

    # the port's own short demons run drives the same warps
    own = tmia.Deformable(reference_name=ref_name, moving_name=mov_name,
                          rigid_matrix=rigid)
    own.compute_demons(method="fast", iterations=5, crop=0)
    warped = own.update_dose("RTDOSE 01")["array"]
    assert warped.shape == SHAPE and np.isfinite(warped).all()
    # iterated solvers: the fields agree to 0.15 mm (tests/
    # test_torch_demons.py), the doses to that times the steepest dose
    # gradient per mm
    np.testing.assert_allclose(warped, j_arr, rtol=0,
                               atol=0.15 * max_step / 1.5)
    with pytest.raises(ValueError, match="no DVF"):
        tmia.Deformable(reference_name=ref_name,
                        moving_name=mov_name).update_mask(mask)


def test_rois_and_dose_from_numpy_carry_jax_state(tmp_path):
    write_case(tmp_path)
    jmia.read_dicoms(folder_path=str(tmp_path))
    j = JData.image["CT 01"]
    interop.import_image(j)
    interop.rois_from_numpy("CT 01", {n: r.contour_position
                                      for n, r in j.rois.items()})
    jd = JData.dose["RTDOSE 01"]
    td = interop.dose_from_numpy(jd.array, jd.spacing, jd.origin, jd.matrix,
                                 name="carried dose", tags=jd.tags)
    assert TData.dose_list == ["carried dose"]
    assert td.frame_ref == jd.frame_ref
    t = TData.image["CT 01"]
    for name in j.rois:
        np.testing.assert_array_equal(t.rois[name].compute_mask(),
                                      np.asarray(j.rois[name].compute_mask()))
    ts = td.compute_roi_dose_statistics("CT 01", "PTV")
    js = jd.compute_roi_dose_statistics("CT 01", "PTV")
    assert ts["Volume (cc)"] == js["Volume (cc)"]
    np.testing.assert_allclose(ts["Dmean"], js["Dmean"], atol=1e-4)


def test_entry_point_without_card_raises_unless_cpu_asked(tmp_path):
    """No card and no request for the CPU: read_dicoms raises, naming how
    to ask for the CPU; asked explicitly, it runs there."""
    write_case(tmp_path)
    set_default_device(None)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="set_default_device"):
        tmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    assert TData.dose_list == ["RTDOSE 01"]
