"""RTPLAN ingest, the Plan object, its writer and its json persistence in
both packages, on the CPU (the cases of tests/test_rtplan.py): every
harvested field equal between the packages, each format written by one
and read by the other.

Tolerances: none. Plan fields are parsed numbers and strings, equal;
datasets equal element by element with the writers' generated UIDs
masked (test_torch_reg.assert_same_dataset).
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.structure import plan as tplan
from medicalimageanalysis_torch.structure.dose import Dose as TDose
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.dicom import (Dataset, Sequence, dcmwrite,
                                            generate_uid, uids)
from medicalimageanalysis_tpu.structure import plan as jplan
from medicalimageanalysis_tpu.structure.dose import Dose as JDose
from test_deformable_dose import write_rtdose_file
from test_rtplan import write_rtplan_file
from test_torch_reg import assert_same_dataset

FIELDS = ("plan_name", "modality", "label", "name", "description",
          "approval_status", "n_fractions", "target_prescription_dose",
          "dose_references", "fraction_groups", "beams",
          "referenced_structure_set_sop", "referenced_dose_sops", "sops",
          "patient_name", "mrn", "birthdate", "series_uid", "frame_ref")


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


def read_both(**kw):
    jmia.read_dicoms(**kw)
    return tmia.read_dicoms(**kw)


def assert_same_plan(t, j):
    for key in FIELDS:
        assert getattr(t, key) == getattr(j, key), key
    assert str(t.date) == str(j.date) and str(t.time) == str(j.time)
    assert t.summary() == j.summary()
    assert t.total_beam_meterset() == j.total_beam_meterset()
    assert t.linked_dose_names() == j.linked_dose_names()


def test_rtplan_ingest_matches_jax(tmp_path):
    write_rtplan_file(tmp_path / "rp.dcm")
    report = read_both(folder_path=str(tmp_path)).report
    assert TData.plan_list == JData.plan_list == ["RTPLAN 01"]
    assert report.plans_created == ["RTPLAN 01"]
    assert report.summary()["plans"] == ["RTPLAN 01"]
    t = TData.plan["RTPLAN 01"]
    assert_same_plan(t, JData.plan["RTPLAN 01"])
    assert t.n_fractions == 30 and t.total_beam_meterset() == 480.0
    assert t.beams[0]["gantry_angle"] == 181.0


def dose_folder(tmp_path, seed=0):
    rng = np.random.default_rng(seed)
    arr = rng.integers(-500, 500, size=(4, 16, 16)).astype(np.int16)
    info = write_ct_series(tmp_path, arr, spacing=(1, 1), thickness=2.0)
    write_rtdose_file(tmp_path / "rd.dcm",
                      np.full((4, 16, 16), 20000, np.uint32), info)
    read_both(folder_path=str(tmp_path))
    return TData.dose["RTDOSE 01"].sops[0]


@pytest.mark.parametrize("direction", ["plan_to_dose", "dose_to_plan"])
def test_rtplan_links_to_dose_like_jax(tmp_path, direction):
    dose_sop = dose_folder(tmp_path)
    if direction == "plan_to_dose":
        write_rtplan_file(tmp_path / "rp.dcm", dose_sop=dose_sop)
    else:
        plan_sop = write_rtplan_file(tmp_path / "rp.dcm")
        from medicalimageanalysis_tpu.dicom import dcmread
        d = dcmread(str(tmp_path / "rd.dcm"))
        item = Dataset()
        item.ReferencedSOPClassUID = uids.RTPlanStorage
        item.ReferencedSOPInstanceUID = plan_sop
        d.ReferencedRTPlanSequence = Sequence([item])
        dcmwrite(str(tmp_path / "rd.dcm"), d)
    read_both(folder_path=str(tmp_path))
    t, j = TData.plan["RTPLAN 01"], JData.plan["RTPLAN 01"]
    assert t.linked_dose_names() == j.linked_dose_names() == ["RTDOSE 01"]
    # the fractionation feeds EQD2 directly
    eq = TData.dose["RTDOSE 01"].compute_eqd2(t.n_fractions, alpha_beta=3.0,
                                              register=False)
    d = 20.0 / 30.0
    np.testing.assert_allclose(eq[0, 0, 0], 20.0 * (d + 3.0) / 5.0,
                               rtol=1e-5)


def test_rtplan_minimal_and_degenerate(tmp_path):
    ds = Dataset()
    ds.SOPClassUID = uids.RTPlanStorage
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = "RTPLAN"
    dcmwrite(tmp_path / "rp_min.dcm", ds)
    read_both(folder_path=str(tmp_path))
    t = TData.plan["RTPLAN 01"]
    assert_same_plan(t, JData.plan["RTPLAN 01"])
    assert t.n_fractions is None and t.beams == []
    assert t.total_beam_meterset() is None and t.linked_dose_names() == []


def test_rtplan_respects_only_modality(tmp_path):
    write_rtplan_file(tmp_path / "rp.dcm")
    read_both(folder_path=str(tmp_path), only_modality=["CT"])
    assert TData.plan_list == JData.plan_list == []


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rtplan_writer_round_trips_across_packages(tmp_path, writer):
    write_rtplan_file(tmp_path / "rp.dcm")
    read_both(folder_path=str(tmp_path))
    t_ds = TData.plan["RTPLAN 01"].create_rtplan()
    j_ds = JData.plan["RTPLAN 01"].create_rtplan()
    assert_same_dataset(t_ds, j_ds)
    before = TData.plan["RTPLAN 01"]
    out = tmp_path / "export"
    out.mkdir()
    dcmwrite(str(out / "rp2.dcm"), t_ds if writer == "port" else j_ds)
    read_both(folder_path=str(out))
    t, j = TData.plan["RTPLAN 01"], JData.plan["RTPLAN 01"]
    assert_same_plan(t, j)
    # a summary export: one control point a beam (PS3.3 C.8.8.14)
    assert t.beams == [dict(b, n_control_points=1) for b in before.beams]
    assert t.fraction_groups == before.fraction_groups
    assert t.dose_references == before.dose_references


def write_ion_plan(path):
    ds = Dataset()
    ds.SOPClassUID = uids.RTIonPlanStorage
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = "RTPLAN"
    ds.RTPlanLabel = "ProtonPBS"
    cp = Dataset()
    cp.ControlPointIndex = 0
    cp.NominalBeamEnergy = 120.0
    cp.GantryAngle = 90.0
    cp.IsocenterPosition = [0.0, -150.0, 30.0]
    b = Dataset()
    b.BeamNumber = 1
    b.BeamName = "Field1"
    b.RadiationType = "PROTON"
    b.NumberOfControlPoints = 40
    b.IonControlPointSequence = Sequence([cp])
    ds.IonBeamSequence = Sequence([b])
    dcmwrite(path, ds)


def test_rtplan_ion_beams_match_jax(tmp_path):
    write_ion_plan(tmp_path / "ionplan.dcm")
    read_both(folder_path=str(tmp_path))
    t = TData.plan["RTPLAN 01"]
    assert_same_plan(t, JData.plan["RTPLAN 01"])
    out = t.create_rtplan(path=tmp_path / "ion_out.dcm")
    assert_same_dataset(out, JData.plan["RTPLAN 01"].create_rtplan())
    assert str(out.SOPClassUID) == uids.RTIonPlanStorage
    assert "IonBeamSequence" in out and "BeamSequence" not in out
    read_both(file_list=[str(tmp_path / "ion_out.dcm")])
    assert_same_plan(TData.plan["RTPLAN 01"], JData.plan["RTPLAN 01"])
    assert TData.plan["RTPLAN 01"].beams[0]["energy"] == 120.0


def test_rtplan_byte_flip_fuzz_matches_jax(tmp_path):
    """Corrupt plans never escape the tolerant flow, and both packages
    register the same plans from each."""
    write_rtplan_file(tmp_path / "rp.dcm")
    good = (tmp_path / "rp.dcm").read_bytes()
    rng = np.random.default_rng(11)
    mut = tmp_path / "mut.dcm"
    for _ in range(40):
        blob = bytearray(good)
        for _ in range(int(rng.integers(1, 16))):
            blob[int(rng.integers(0, len(blob)))] = int(
                rng.integers(0, 256))
        mut.write_bytes(bytes(blob))
        read_both(file_list=[str(mut)])
        assert TData.plan_list == JData.plan_list
        for name in TData.plan_list:
            assert_same_plan(TData.plan[name], JData.plan[name])


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_plan_save_load_across_packages(tmp_path, saver):
    write_rtplan_file(tmp_path / "rp.dcm")
    read_both(folder_path=str(tmp_path))
    src = (TData if saver == "port" else JData).plan["RTPLAN 01"]
    base = src.save_plan(str(tmp_path / "store"))
    assert base.endswith("RTPLAN 01")
    TData.clear()
    JData.clear()
    t = tplan.load_plan(base)
    j = jplan.load_plan(base)
    assert TData.plan_list == JData.plan_list == ["RTPLAN 01"]
    assert_same_plan(t, j)
    assert t.total_beam_meterset() == 480.0
    # collisions suffix as the other loaders do
    t2 = tplan.Plan.load_plan(base)
    assert t2.plan_name == "RTPLAN 01_1"
    assert TData.plan_list == ["RTPLAN 01", "RTPLAN 01_1"]


def test_plan_dose_linkage_survives_save_load_like_jax(tmp_path):
    dose_sop = dose_folder(tmp_path, seed=3)
    write_rtplan_file(tmp_path / "rp.dcm", dose_sop=dose_sop)
    for data, pkg in ((TData, tmia), (JData, jmia)):
        pkg.read_dicoms(file_list=[str(tmp_path / "rp.dcm")], clear=False)
        data.dose["RTDOSE 01"].save_image(str(tmp_path / pkg.__name__))
        data.plan["RTPLAN 01"].save_plan(str(tmp_path / pkg.__name__))
    plan_date = TData.plan["RTPLAN 01"].date
    TData.clear()
    JData.clear()
    store = tmp_path / "medicalimageanalysis_torch"
    d2 = TDose.load_image(str(store / "RTDOSE 01"))
    p2 = tplan.Plan.load_plan(str(store / "RTPLAN 01"))
    jstore = tmp_path / "medicalimageanalysis_tpu"
    jd = JDose.load_image(str(jstore / "RTDOSE 01"))
    jp = jplan.Plan.load_plan(str(jstore / "RTPLAN 01"))
    assert d2.sops == jd.sops == [dose_sop]
    assert p2.linked_dose_names() == jp.linked_dose_names() == ["RTDOSE 01"]
    assert str(p2.date) == str(plan_date) != "00000"
    assert_same_plan(p2, jp)
