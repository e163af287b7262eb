"""PET SUV and MTV / TLG in both packages, on the CPU: each case of
tests/test_suv.py that does not export (the exports wait for the IO
slice), written once with the JAX package's series writer and read by
both packages' ``read_dicoms``.

Tolerances, stated per check:
- SUV maps: 1e-6 relative against the JAX package's (the same host tag
  arithmetic and one float32 product), and the hand-pinned values of
  tests/test_suv.py at their 1e-5;
- ``compute_mtv_tlg``: equal to the JAX package's, every key, on the
  same mask (absolute and relative cuts, an empty ROI); the typed errors
  match the same messages.
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.dicom import Dataset, Sequence
from medicalimageanalysis_tpu.utils.creation import CreateDicomImage

HALF_LIFE = 6586.2
DOSE = 3.5e8


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


def radiopharm(start=None, start_dt=None):
    info = Dataset()
    info.RadionuclideTotalDose = DOSE
    info.RadionuclideHalfLife = HALF_LIFE
    if start is not None:
        info.RadiopharmaceuticalStartTime = start
    if start_dt is not None:
        info.RadiopharmaceuticalStartDateTime = start_dt
    return Sequence([info])


def write_pt(folder, raw, slope=1.37, drop=(), **tag_overrides):
    extra = {
        "Units": "BQML",
        "DecayCorrection": "START",
        "SeriesTime": "090000",
        "PatientWeight": 70.0,
        "RadiopharmaceuticalInformationSequence": radiopharm("080000"),
    }
    extra.update(tag_overrides)
    for keyword in drop:
        del extra[keyword]
    CreateDicomImage(str(folder), raw, spacing=[2.0, 2.0],
                     thickness=3.0).run(modality="PT",
                                        rescale_slope=slope,
                                        extra_tags=extra)


def read_both(folder):
    TData.clear()
    JData.clear()
    tmia.read_dicoms(folder_path=str(folder), device="cpu")
    jmia.read_dicoms(folder_path=str(folder))
    name = TData.image_list[0]
    return TData.image[name], JData.image[name]


def suv_both(folder):
    ti, ji = read_both(folder)
    suv = ti.compute_suv()
    ref = np.asarray(ji.compute_suv())
    assert suv.dtype == np.float32 and suv.shape == ref.shape
    np.testing.assert_allclose(suv, ref, rtol=1e-6, atol=0)
    return suv


def test_pt_ingest_float32_no_saturation(tmp_path):
    raw = np.full((4, 16, 16), 30000, np.int16)
    write_pt(tmp_path / "pt", raw)
    ti, ji = read_both(tmp_path / "pt")
    assert ti.array.dtype == np.float32
    np.testing.assert_array_equal(ti.array, np.asarray(ji.array))
    np.testing.assert_allclose(ti.array, 30000 * 1.37, rtol=1e-6)


def test_suv_start_decay_correction(tmp_path):
    write_pt(tmp_path / "pt", np.full((4, 16, 16), 10000, np.int16),
             slope=1.0)
    suv = suv_both(tmp_path / "pt")
    decayed = DOSE * 2.0 ** (-3600.0 / HALF_LIFE)
    np.testing.assert_allclose(suv, 10000.0 * 70000.0 / decayed, rtol=1e-5)


@pytest.mark.parametrize("case", ["admin", "midnight", "datetime",
                                  "dt_offset_fraction", "truncated_tm"])
def test_suv_time_forms(tmp_path, case):
    """ADMIN (no decay), a midnight crossing, the DT start form (which
    takes precedence), a DT with fractional seconds and a UTC offset, and
    TM values truncated to HHMM and HH."""
    raw = np.full((2, 8, 8), 5000, np.int16)
    decayed = DOSE * 2.0 ** (-3600.0 / HALF_LIFE)
    tags = {
        "admin": dict(DecayCorrection="ADMIN"),
        "midnight": dict(
            SeriesTime="003000",
            RadiopharmaceuticalInformationSequence=radiopharm("233000")),
        "datetime": dict(
            RadiopharmaceuticalInformationSequence=radiopharm(
                "070000", start_dt="20260818080000")),
        "dt_offset_fraction": dict(
            RadiopharmaceuticalInformationSequence=radiopharm(
                start_dt="20260818080000.000000-0500")),
        "truncated_tm": dict(
            SeriesTime="09",
            RadiopharmaceuticalInformationSequence=radiopharm("0800")),
    }[case]
    write_pt(tmp_path / "pt", raw, slope=1.0, **tags)
    suv = suv_both(tmp_path / "pt")
    expect = 5000.0 * 70000.0 / (DOSE if case == "admin" else decayed)
    np.testing.assert_allclose(suv, expect, rtol=1e-5)


def test_suv_from_acquisition_times(tmp_path):
    """Without SeriesTime the earliest AcquisitionTime is the scan
    start."""
    raw = np.full((3, 8, 8), 5000, np.int16)
    write_pt(tmp_path / "pt", raw, slope=1.0, drop=("SeriesTime",),
             AcquisitionTime="090000")
    suv = suv_both(tmp_path / "pt")
    decayed = DOSE * 2.0 ** (-3600.0 / HALF_LIFE)
    np.testing.assert_allclose(suv, 5000.0 * 70000.0 / decayed, rtol=1e-5)


@pytest.mark.parametrize("case,match", [
    ("units", "Units"), ("weight", "PatientWeight"),
    ("decay", "DecayCorrection"), ("ct", "PT")])
def test_suv_typed_errors(tmp_path, case, match):
    raw = np.full((2, 8, 8), 100, np.int16)
    if case == "ct":
        CreateDicomImage(str(tmp_path / "ct"), raw).run()
    else:
        tags = {"units": dict(Units="CNTS"),
                "weight": dict(PatientWeight=None),
                "decay": dict(DecayCorrection="NONE")}[case]
        write_pt(tmp_path / "ct", raw, **tags)
    ti, ji = read_both(tmp_path / "ct")
    with pytest.raises(ValueError, match=match):
        ji.compute_suv()
    with pytest.raises(ValueError, match=match):
        ti.compute_suv()


def lesion_case(tmp_path):
    raw = np.full((4, 16, 16), 1000, np.int16)   # background
    raw[1:3, 4:10, 4:10] = 8000                  # hot lesion
    raw[2, 6, 7] = 9100                          # one hotter voxel
    write_pt(tmp_path / "pt", raw, slope=1.0, DecayCorrection="ADMIN")
    ti, ji = read_both(tmp_path / "pt")
    roi = np.zeros((4, 16, 16), np.uint8)
    roi[1:3, 3:11, 3:11] = 1                     # lesion + 1-voxel rim
    for img in (ti, ji):
        img.create_roi(name="Lesion", color=[255, 0, 0])
        img.rois["Lesion"].convert_mask(roi)
        img.create_roi(name="Empty", color=[1, 2, 3])
        img.rois["Empty"].convert_mask(np.zeros_like(roi))
    return ti, ji


@pytest.mark.parametrize("threshold,relative", [
    (4000 * 70000.0 / DOSE, False), (2.5, False), (0.41, True),
    (0.95, True)])
def test_mtv_tlg_equal_to_jax(tmp_path, threshold, relative):
    ti, ji = lesion_case(tmp_path)
    suv = ti.compute_suv()
    np.testing.assert_array_equal(
        np.asarray(ti.rois["Lesion"].compute_mask()),
        np.asarray(ji.rois["Lesion"].compute_mask()))
    out = ti.compute_mtv_tlg("Lesion", suv=suv, threshold=threshold,
                             relative=relative)
    ref = ji.compute_mtv_tlg("Lesion", suv=suv, threshold=threshold,
                             relative=relative)
    assert out == ref
    assert all(type(v) is float for v in out.values())
    # without a SUV map the image's own is taken
    assert ti.compute_mtv_tlg("Lesion", threshold=threshold,
                              relative=relative) == ref


def test_mtv_tlg_pinned_and_empty(tmp_path):
    """tests/test_suv.py's hand-pinned figures, and the empty ROI's
    schema in both modes."""
    ti, ji = lesion_case(tmp_path)
    suv = ti.compute_suv()
    scale = 70000.0 / DOSE
    voxel_cc = 2.0 * 2.0 * 3.0 / 1000.0
    out = ti.compute_mtv_tlg("Lesion", suv=suv, threshold=4000 * scale)
    assert out["mtv_cc"] == pytest.approx(72 * voxel_cc)
    assert out["tlg"] == pytest.approx(
        (71 * 8000 + 9100) * scale * voxel_cc, rel=1e-5)
    assert out["suv_max"] == pytest.approx(9100 * scale, rel=1e-5)
    rel = ti.compute_mtv_tlg("Lesion", suv=suv, threshold=0.41,
                             relative=True)
    assert rel["mtv_cc"] == pytest.approx(72 * voxel_cc)
    for relative in (False, True):
        e = ti.compute_mtv_tlg("Empty", suv=np.zeros((4, 16, 16)),
                               relative=relative)
        r = ji.compute_mtv_tlg("Empty", suv=np.zeros((4, 16, 16)),
                               relative=relative)
        assert e.keys() == r.keys() and e["mtv_cc"] == 0.0
        assert all(e[k] == r[k] or (np.isnan(e[k]) and np.isnan(r[k]))
                   for k in e)
    with pytest.raises(ValueError, match="SUV shape"):
        ti.compute_mtv_tlg("Lesion", suv=np.zeros((2, 2, 2)))
