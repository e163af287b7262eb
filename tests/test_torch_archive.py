"""A whole RT patient folder in one ``read_dicoms`` pass through both
packages, on the CPU: CT + RTSTRUCT + SEG + RTDOSE + RTPLAN + a rigid REG
+ a deformable REG + MR + PT (the JAX package's kitchen-sink archive,
tests/test_integration_archive.py, with the plan and the deformable REG
added). The registries must be equal: names, ROIs and their masks, the
dose grid, the plan, the matrices and the field.

Tolerances: none. Arrays, masks, matrices and fields are bit-equal; the
dose statistics (one ``affine`` resample) agree within 1e-4 Gy, the
tolerance of tests/test_torch_dose.py.
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import square_contour_mm, write_ct_series, write_rtstruct
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.dicom import Dataset, Sequence
from medicalimageanalysis_tpu.utils.creation import CreateDicomImage
from test_deformable_dose import make_blob, write_reg_file, write_rtdose_file
from test_rtplan import write_rtplan_file
from test_torch_reg import write_deformable_reg


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


def write_archive(folder):
    base = make_blob(shape=(8, 24, 24)).astype(np.int16)
    ct_info = write_ct_series(folder / "ct", base, spacing=(1, 1),
                              thickness=2.0)
    rois = {"Target": [(square_contour_mm(ct_info, z, 6, 14), z)
                       for z in range(2, 6)]}
    write_rtstruct(folder / "ct" / "rs.dcm", ct_info, rois)
    dose_raw = np.full((8, 24, 24), 20000, np.uint32)
    dose_raw[3:5, 8:12, 8:12] = 23000
    write_rtdose_file(folder / "ct" / "rd.dcm", dose_raw, ct_info)

    mr_info = write_ct_series(folder / "mr", np.roll(base, 2, axis=2),
                              spacing=(1, 1), thickness=2.0, modality="MR")
    m = np.eye(4)
    m[:3, 3] = [5.0, -3.0, 2.0]
    write_reg_file(folder / "reg.dcm", ct_info, mr_info, m)
    field = np.random.default_rng(9).normal(0, 0.7, (8, 24, 24, 3)) \
        .astype("<f4")
    write_deformable_reg(folder / "dreg.dcm", ct_info, mr_info, field,
                         np.linalg.inv(m), origin=ct_info["origin"],
                         resolution=(1.0, 1.0, 2.0))

    info = Dataset()
    info.RadionuclideTotalDose = 3.5e8
    info.RadionuclideHalfLife = 6586.2
    info.RadiopharmaceuticalStartTime = "080000"
    CreateDicomImage(str(folder / "pt"),
                     np.full((4, 16, 16), 5000, np.int16),
                     spacing=[2.0, 2.0], thickness=3.0).run(
        modality="PT", rescale_slope=1.0,
        extra_tags={"Units": "BQML", "DecayCorrection": "ADMIN",
                    "PatientWeight": 70.0,
                    "RadiopharmaceuticalInformationSequence":
                        Sequence([info])})

    # a first pass to author the SEG on the CT, as the JAX test does
    jmia.read_dicoms(folder_path=str(folder))
    ct = [n for n in JData.image_list
          if JData.image[n].modality == "CT"][0]
    img = JData.image[ct]
    auto = np.zeros((8, 24, 24), np.uint8)
    auto[2:6, 6:14, 6:14] = 1
    img.create_roi(name="AutoSeg", color=[0, 200, 100])
    img.rois["AutoSeg"].convert_mask(auto)
    img.create_seg(roi_names=["AutoSeg"], path=str(folder / "ct"
                                                   / "seg.dcm"))
    dose_sop = JData.dose["RTDOSE 01"].sops[0]
    write_rtplan_file(folder / "rp.dcm", n_fractions=20, prescription=46.0,
                      dose_sop=dose_sop)
    JData.clear()
    return m, field, auto


def test_whole_archive_reads_in_one_pass_like_jax(tmp_path):
    m, field, auto = write_archive(tmp_path)
    jreport = jmia.read_dicoms(folder_path=str(tmp_path)).report
    report = tmia.read_dicoms(folder_path=str(tmp_path)).report

    assert not report.failed_series and not jreport.failed_series
    assert not report.unmatched_rtstructs and not report.unmatched_segs
    summary, jsummary = report.summary(), jreport.summary()
    for key in ("images", "doses", "plans", "rigid", "deformable",
                "failed", "failed_series", "unmatched_rtstructs",
                "unmatched_segs"):
        assert summary[key] == jsummary[key], key
    for key in ("image_list", "dose_list", "plan_list", "rigid_list",
                "deformable_list"):
        assert getattr(TData, key) == getattr(JData, key), key
    assert sorted(TData.roi_list) == sorted(JData.roi_list)
    assert len(TData.image_list) == 3 and len(TData.plan_list) == 1
    assert {TData.image[n].modality for n in TData.image_list} \
        == {"CT", "MR", "PT"}

    for name in TData.image_list:
        t, j = TData.image[name], JData.image[name]
        np.testing.assert_array_equal(t.array, np.asarray(j.array))
        assert sorted(t.rois) == sorted(j.rois)
        masks = t.compute_roi_masks()
        for roi in t.rois:
            np.testing.assert_array_equal(
                masks[roi], np.asarray(j.rois[roi].compute_mask()))
    ct = [n for n in TData.image_list
          if TData.image[n].modality == "CT"][0]
    np.testing.assert_array_equal(
        TData.image[ct].rois["AutoSeg"].compute_mask(), auto)
    assert "Target" in TData.image[ct].rois

    rigid, jrigid = (d.rigid[d.rigid_list[0]] for d in (TData, JData))
    np.testing.assert_array_equal(rigid.matrix, jrigid.matrix)
    np.testing.assert_allclose(rigid.matrix, np.linalg.inv(m), atol=1e-12)
    deform, jdeform = (d.deformable[d.deformable_list[0]]
                       for d in (TData, JData))
    np.testing.assert_array_equal(deform.dvf.numpy(), field)
    np.testing.assert_array_equal(deform.dvf.numpy(),
                                  np.asarray(jdeform.dvf))
    np.testing.assert_array_equal(deform.rigid_matrix, jdeform.rigid_matrix)

    dose, jdose = TData.dose["RTDOSE 01"], JData.dose["RTDOSE 01"]
    np.testing.assert_array_equal(dose.array, np.asarray(jdose.array))
    stats = dose.compute_roi_dose_statistics(ct, "Target")
    jstats = jdose.compute_roi_dose_statistics(ct, "Target")
    for key in ("Dmean", "Dmax", "D95"):
        np.testing.assert_allclose(stats[key], jstats[key], atol=1e-4)
    plan, jplan = TData.plan["RTPLAN 01"], JData.plan["RTPLAN 01"]
    assert plan.linked_dose_names() == jplan.linked_dose_names() \
        == ["RTDOSE 01"]
    assert plan.summary() == jplan.summary()
    assert plan.n_fractions == 20

    pt = [n for n in TData.image_list
          if TData.image[n].modality == "PT"][0]
    np.testing.assert_allclose(TData.image[pt].compute_suv(),
                               5000.0 * 70000.0 / 3.5e8, rtol=1e-5)
