"""The plan-QA path in both packages on the CPU, through ``read_dicoms`` of
a written CT + RTSTRUCT + RTDOSE (test_torch_dose.py's case): DVH goals
(``evaluate_constraints``), dose accumulation (rigid and deformable
entries), ``register_dose_grid`` and the radiobiology.

Tolerances, stated per check:
- goal values: each equals float64 numpy on the port's own
  ``compute_roi_dose_array`` exactly; against the JAX package 1e-4 Gy
  (D goals) and equal (V goals, thresholds away from every voxel's
  dose), since the ROI doses differ by up to 1e-4 Gy (the resample's
  affine coordinates, ROADMAP.md queue 3);
- accumulation: weights (0.5, 0.5) of one dose equal its resample to
  the bit; against the JAX package 1e-4 Gy (rigid) and 1e-4 times the
  largest dose step (deformable, test_torch_dose.py's update_dose bound);
- radiobiology functions: equal (the same numpy code); the Dose methods
  through the ROI doses: 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from medicalimageanalysis_torch import interop
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.utils import dose as tdose
from medicalimageanalysis_torch.utils import radiobiology as trb
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.structure.deformable import (
    Deformable as JDeformable)
from medicalimageanalysis_tpu.utils import dose as jdose
from medicalimageanalysis_tpu.utils import radiobiology as jrb
from test_torch_dose import SHAPE, write_case, write_pair_with_dose


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


def read_both(folder):
    jmia.read_dicoms(folder_path=str(folder))
    tmia.read_dicoms(folder_path=str(folder))
    return TData.dose["RTDOSE 01"], JData.dose["RTDOSE 01"]


GOALS = ["Dmax <= 62Gy", "Dmin >= 10Gy", "Dmean >= 30Gy",
         "Dmedian <= 70Gy", "D95% >= 20Gy", "D50% >= 40Gy",
         "D0.05cc <= 61Gy", "D2cc <= 80Gy", "V20.5Gy <= 35%",
         "V40.3Gy >= 0.1cc"]


@pytest.mark.parametrize("roi", ["PTV", "Ring", "Star"])
def test_evaluate_constraints_matches_jax(tmp_path, roi):
    write_case(tmp_path)
    td, jd = read_both(tmp_path)
    got = td.evaluate_constraints({roi: GOALS})
    want = jdose.evaluate_constraints(jd, {roi: GOALS})
    values, coverage = td.compute_roi_dose_array("CT 01", roi,
                                                 return_coverage=True)
    d = values.astype(np.float64)
    voxel_cc = float(np.prod(TData.image["CT 01"].spacing)) / 1000.0
    assert len(got) == len(want) == len(GOALS)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "value"} == \
            {k: v for k, v in w.items() if k != "value"}
        assert g["dose_grid_coverage"] == coverage
        kind, qual, _, _, unit = jdose._parse_goal(g["goal"])
        assert g["value"] == jdose._metric_value(kind, qual, unit, d,
                                                 voxel_cc)
        if kind == "D":
            np.testing.assert_allclose(g["value"], w["value"], atol=1e-4)
        else:
            assert g["value"] == w["value"], g["goal"]
    assert got[4]["value"] == float(np.percentile(d, 5.0))


def test_partial_dose_grid_coverage_warns_as_jax(tmp_path):
    """A dose grid cropped in x covers part of the ROI: the goals carry
    the coverage and a UserWarning names the ROI, in both packages."""
    from types import SimpleNamespace

    write_case(tmp_path)
    out = {}
    for key, pkg, data in (("t", tdose, TData), ("j", jdose, JData)):
        if key == "t":
            tmia.read_dicoms(folder_path=str(tmp_path))
        else:
            jmia.read_dicoms(folder_path=str(tmp_path))
        full = data.dose["RTDOSE 01"]
        like = SimpleNamespace(plane=full.plane, spacing=full.spacing,
                               origin=full.origin, matrix=full.matrix,
                               orientation=full.orientation,
                               frame_ref=full.frame_ref)
        crop = pkg.register_dose_grid(np.asarray(full.array)[:, :, :14],
                                      like, name="Cropped")
        with pytest.warns(UserWarning, match="'Ring'"):
            out[key] = pkg.evaluate_constraints(crop, {"Ring": GOALS[:3]})
    for g, w in zip(out["t"], out["j"]):
        assert g["dose_grid_coverage"] == w["dose_grid_coverage"] < 1.0
        np.testing.assert_allclose(g["value"], w["value"], atol=1e-4)


def test_goal_grammar_errors_and_empty_roi_match_jax(tmp_path):
    write_case(tmp_path)
    td, jd = read_both(tmp_path)
    for goal in ("D95 >= 20Gy", "Dfoo >= 2Gy", "V20Gy <= 30Gy",
                 "D95% <= 20%", "V20% <= 30%", "D120% >= 1Gy"):
        with pytest.raises(ValueError) as t_err:
            td.evaluate_constraints({"PTV": [goal]})
        with pytest.raises(ValueError) as j_err:
            jd.evaluate_constraints({"PTV": [goal]})
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(KeyError, match="no ROI"):
        td.evaluate_constraints({"Nope": ["Dmax <= 1Gy"]})
    TData.image["CT 01"].add_roi(roi_name="Empty")
    (res,) = tdose.evaluate_constraints("RTDOSE 01",
                                        {"Empty": ["Dmax <= 1Gy"]})
    assert np.isnan(res["value"]) and not res["passed"]
    assert res["dose_grid_coverage"] == 1.0


def test_accumulate_rigid_matches_jax_and_the_resample(tmp_path):
    from medicalimageanalysis_torch.ops.resample import (
        affine_resample, compose_pixel_matrix)

    write_case(tmp_path)
    td, _ = read_both(tmp_path)
    img = TData.image["CT 01"]
    got = tdose.accumulate_dose("CT 01", ["RTDOSE 01", "RTDOSE 01"],
                                weights=[0.5, 0.5], name="Sum")
    want = jdose.accumulate_dose("CT 01", ["RTDOSE 01", "RTDOSE 01"],
                                 weights=[0.5, 0.5], name="Sum")
    A = compose_pixel_matrix(td.matrix, td.spacing, td.origin, img.matrix,
                             img.spacing, img.origin)
    alone = affine_resample(td.array, A, SHAPE, background=0.0).numpy()
    assert got.array.dtype == np.float32 and got.array.shape == SHAPE
    np.testing.assert_array_equal(got.array, alone)
    np.testing.assert_allclose(got.array, np.asarray(want.array), rtol=0,
                               atol=1e-4)
    assert TData.dose_list == ["RTDOSE 01", "Sum"]
    assert got.misc["source_doses"] == want.misc["source_doses"]
    for key in ("spacing", "origin", "matrix", "dimensions", "plane"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert got.frame_ref == want.frame_ref == img.frame_ref
    # the accumulated grid is a first-class Dose: its DVH runs unchanged
    stats = got.compute_roi_dose_statistics("CT 01", "PTV")
    assert stats["Dmax"] > 30.0
    # re-running under the same name replaces, register=False returns
    # the volume, and bad input raises as in the JAX package
    tdose.accumulate_dose("CT 01", ["RTDOSE 01"], name="Sum")
    assert TData.dose_list == ["RTDOSE 01", "Sum"]
    vol = tdose.accumulate_dose("CT 01", ["RTDOSE 01"], weights=[2.0],
                                register=False)
    np.testing.assert_array_equal(vol["array"], np.float32(2.0) * alone)
    with pytest.raises(ValueError, match="empty"):
        tdose.accumulate_dose("CT 01", [])
    with pytest.raises(KeyError, match="unknown image"):
        tdose.accumulate_dose("CT 99", ["RTDOSE 01"])
    with pytest.raises(ValueError, match="len"):
        tdose.accumulate_dose("CT 01", ["RTDOSE 01"], weights=[1.0, 2.0])


def test_accumulate_deformable_entry_matches_jax(tmp_path):
    write_pair_with_dose(tmp_path)
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path))
    ref_name = [n for n in TData.image_list
                if TData.image[n].filepaths[0].startswith(
                    str(tmp_path / "ref"))][0]
    mov_name = [n for n in TData.image_list if n != ref_name][0]
    j_def = JDeformable(reference_name=ref_name, moving_name=mov_name,
                        roi_names=[])
    j_def.compute_demons(method="fast", iterations=5, crop=0)
    t_def = interop.deformable_from_numpy(
        j_def.dvf, j_def.origin, j_def.spacing, ref_name, mov_name,
        name=j_def.deformable_name)
    entries = [("RTDOSE 01", j_def.deformable_name), "RTDOSE 01"]
    got = tdose.accumulate_dose(ref_name, entries, weights=[0.7, 0.3])
    want = jdose.accumulate_dose(ref_name, entries, weights=[0.7, 0.3])
    dose = TData.dose["RTDOSE 01"].array
    max_step = max(np.abs(np.diff(dose, axis=k)).max() for k in range(3))
    assert got.array.max() > 20.0
    np.testing.assert_allclose(got.array, np.asarray(want.array), rtol=0,
                               atol=1e-4 * max_step)
    assert got.misc["source_doses"] == ["RTDOSE 01", "RTDOSE 01"]
    with pytest.raises(ValueError, match="reference is"):
        tdose.accumulate_dose(mov_name, entries)


RB_CASES = {
    "bed": lambda m, d: m.bed(d, 30, 3.0),
    "eqd2": lambda m, d: m.eqd2(d, 5, 10.0),
    "geud_a4": lambda m, d: m.geud(d, 4.0),
    "geud_a0": lambda m, d: m.geud(d, 0.0),
    "geud_neg": lambda m, d: m.geud(d, -10.0),
    "ntcp_lkb": lambda m, d: m.ntcp_lkb(d, 24.5, 0.18, 0.87),
    "ntcp_logistic": lambda m, d: m.ntcp_logistic(d, 24.5, 2.0, 1.0),
    "tcp_logistic": lambda m, d: m.tcp_logistic(d, 50.0, 2.0),
}


@pytest.mark.parametrize("name", list(RB_CASES))
def test_radiobiology_functions_equal_jax(name):
    d = np.random.default_rng(5).uniform(0.0, 70.0, 500).astype(np.float32)
    got, want = RB_CASES[name](trb, d), RB_CASES[name](jrb, d)
    if isinstance(want, dict):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)


def test_dose_radiobiology_methods_match_jax(tmp_path):
    write_case(tmp_path)
    td, jd = read_both(tmp_path)
    eqd2 = td.compute_eqd2(30, 3.0)
    bed = td.compute_bed(30, 3.0, name="BED plan")
    j_eqd2 = jd.compute_eqd2(30, 3.0)
    j_bed = jd.compute_bed(30, 3.0, name="BED plan")
    assert TData.dose_list == JData.dose_list
    assert bed.misc == j_bed.misc and bed.tags[0].SeriesDescription == \
        j_bed.tags[0].SeriesDescription
    np.testing.assert_array_equal(eqd2.array, np.asarray(j_eqd2.array))
    np.testing.assert_array_equal(bed.array, jd.compute_bed(30, 3.0,
                                                            register=False))
    assert eqd2.misc == j_eqd2.misc
    # the float64 formula at every voxel, within float32 rounding
    D = td.array.astype(np.float64)
    np.testing.assert_allclose(eqd2.array, D * (D / 30 + 3.0) / 5.0,
                               rtol=2 ** -23)
    np.testing.assert_allclose(bed.array, D * (1 + D / 30 / 3.0),
                               rtol=2 ** -23)
    for roi in ("PTV", "Star"):
        np.testing.assert_allclose(td.compute_geud("CT 01", roi, 4.0),
                                   jd.compute_geud("CT 01", roi, 4.0),
                                   rtol=1e-5)
        for model, kw in (("lkb", dict(m=0.18, n=0.87)),
                          ("logistic", dict(gamma50=2.0, a=1.0))):
            got = td.compute_ntcp("CT 01", roi, 40.0, model=model, **kw)
            want = jd.compute_ntcp("CT 01", roi, 40.0, model=model, **kw)
            for key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           atol=1e-7)
        got = td.compute_tcp("CT 01", roi, 50.0, 2.0)
        want = jd.compute_tcp("CT 01", roi, 50.0, 2.0)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    with pytest.raises(ValueError, match="LKB"):
        td.compute_ntcp("CT 01", "PTV", 40.0)
    with pytest.raises(ValueError, match="unknown NTCP"):
        td.compute_ntcp("CT 01", "PTV", 40.0, model="probit")
