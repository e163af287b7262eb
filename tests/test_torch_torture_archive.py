"""The JAX package's one-folder torture archive (tests/test_torture_archive.py)
through both packages in one ``read_dicoms`` pass each, on the CPU: a
JPEG-LS CT, a 3-phase 4D CT, MR, PT, a US grayscale cine, an NM RECON
TOMO, RTSTRUCT (ROI + POI), SEG, a rigid and a deformable REG, an RTDOSE
with descending offsets and its RTPLAN, a zip of one more CT, and a
corrupt, a truncated and an extension-less file. The registries must be
equal.

Tolerances: none. Every image array and geometry, ROI mask, POI, matrix,
field, dose grid, plan and the report's bookkeeping are equal to the JAX
package's; the dose statistics (one ``affine`` resample) agree within
1e-4 Gy, the tolerance of tests/test_torch_dose.py.
"""

import zipfile

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import square_contour_mm, write_ct_series, write_rtstruct
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.dicom import (Dataset, Sequence, dcmread,
                                            dcmwrite, generate_uid, uids)
from medicalimageanalysis_tpu.utils.creation import CreateDicomImage
from test_deformable_dose import make_blob, write_reg_file, write_rtdose_file
from test_rtplan import write_rtplan_file
from test_torch_nm import assert_same_images
from test_torture_archive import (PHASES, _phase_volume,
                                  _write_deformable_reg, _write_nm_recon,
                                  _write_us_cine)


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


def write_torture_archive(tmp_path):
    """tests/test_torture_archive.py's folder, object for object."""
    rng = np.random.default_rng(42)
    root = tmp_path / "patient"
    root.mkdir()

    ct_arr = make_blob(shape=(8, 24, 24)).astype(np.int16)
    ct_dir = root / "ct_anat"
    ct_dir.mkdir()
    gen = CreateDicomImage(ct_dir, ct_arr, origin=[-100.0, -120.0, -50.0],
                           spacing=[1.0, 1.0], thickness=2.0,
                           transfer_syntax=uids.JPEGLSLossless)
    gen.run(modality="CT")
    ct_info = {"series_uid": gen.series, "sops": list(gen.sops),
               "origin": np.array([-100.0, -120.0, -50.0]),
               "spacing": np.array([1.0, 1.0]), "thickness": 2.0,
               "frame": gen.frame}

    gated_dir = root / "ct_gated"
    gated_dir.mkdir()
    study, series, frame = generate_uid(), generate_uid(), generate_uid()
    for k in range(PHASES):
        CreateDicomImage(gated_dir, _phase_volume(k), study=study,
                         series=series, frame=frame, origin=[0, 0, 0],
                         spacing=[1, 1], thickness=2.0).run(
            modality="CT",
            extra_tags={"TemporalPositionIdentifier": str(k + 1),
                        "NumberOfTemporalPositions": str(PHASES)},
            instance_offset=k * 4)

    mr_info = write_ct_series(root / "mr", np.roll(ct_arr, 2, axis=2),
                              spacing=(1, 1), thickness=2.0, modality="MR")
    suv_info = Dataset()
    suv_info.RadionuclideTotalDose = 3.5e8
    suv_info.RadionuclideHalfLife = 6586.2
    suv_info.RadiopharmaceuticalStartTime = "080000"
    CreateDicomImage(str(root / "pt"), np.full((4, 16, 16), 5000, np.int16),
                     spacing=[2.0, 2.0], thickness=3.0).run(
        modality="PT", rescale_slope=1.0,
        extra_tags={"Units": "BQML", "DecayCorrection": "ADMIN",
                    "PatientWeight": 70.0,
                    "RadiopharmaceuticalInformationSequence":
                        Sequence([suv_info])})

    us_cine = _write_us_cine(root / "us", rng)
    nm_arr = _write_nm_recon(root / "nm", rng)

    rois = {"Target": [(square_contour_mm(ct_info, z, 6, 14), z)
                       for z in range(2, 6)]}
    write_rtstruct(root / "rs.dcm", ct_info, rois,
                   pois={"Marker": (-95.0, -110.0, -46.0)})

    dose_up = np.zeros((8, 24, 24), np.uint32)
    dose_up[2:6, 6:15, 6:15] = 20000
    info_top = dict(ct_info)
    top_origin = np.asarray(ct_info["origin"], float).copy()
    top_origin[2] += 7 * 2.0
    info_top["origin"] = top_origin
    write_rtdose_file(root / "rd.dcm", dose_up[::-1].copy(), info_top)
    d = dcmread(str(root / "rd.dcm"))
    d.GridFrameOffsetVector = [-2.0 * i for i in range(8)]
    dose_sop = d.SOPInstanceUID
    dcmwrite(str(root / "rd.dcm"), d)
    write_rtplan_file(root / "rp.dcm", n_fractions=30, prescription=60.0,
                      dose_sop=dose_sop)

    rig_m = np.eye(4)
    rig_m[:3, 3] = [5.0, -3.0, 2.0]
    write_reg_file(root / "reg_rigid.dcm", ct_info, mr_info, rig_m)
    dvf = rng.normal(0, 1.0, size=(4, 8, 8, 3)).astype("<f4")
    pre_m = np.eye(4)
    pre_m[:3, 3] = [1.0, 2.0, 3.0]
    _write_deformable_reg(root / "reg_dvf.dcm", ct_info, mr_info, dvf,
                          pre_m)

    JData.clear()
    jmia.read_dicoms(folder_path=str(ct_dir))
    seg_mask = np.zeros((8, 24, 24), np.uint8)
    seg_mask[2:6, 6:14, 6:14] = 1
    img0 = JData.image[JData.image_list[0]]
    img0.create_roi(name="AutoSeg", color=[0, 200, 100])
    img0.rois["AutoSeg"].convert_mask(seg_mask)
    img0.create_seg(roi_names=["AutoSeg"], path=str(root / "seg.dcm"))
    JData.clear()

    zip_src = tmp_path / "zipsrc"
    zip_arr = rng.integers(-200, 800, size=(3, 12, 12)).astype(np.int16)
    write_ct_series(zip_src, zip_arr, spacing=(1, 1), thickness=2.5)
    with zipfile.ZipFile(root / "extra.zip", "w") as z:
        for f in sorted(zip_src.iterdir()):
            z.write(f, f.name)

    (root / "junk.dcm").write_bytes(rng.bytes(512))
    valid = sorted(ct_dir.glob("*.dcm"))[0].read_bytes()
    (root / "trunc.dcm").write_bytes(valid[: len(valid) // 3])
    (root / "trunc_pixels.dcm").write_bytes(valid[: int(len(valid) * 0.9)])
    noext_src = tmp_path / "noext_src"
    write_ct_series(noext_src,
                    rng.integers(-100, 100, size=(2, 10, 10)).astype(
                        np.int16), spacing=(1, 1), thickness=2.0)
    for i, f in enumerate(sorted(noext_src.iterdir())):
        (root / f"IMG{i:04d}").write_bytes(f.read_bytes())
    return root, dict(us=us_cine, nm=nm_arr, seg=seg_mask, dvf=dvf)


def test_torture_archive_reads_in_one_pass_like_jax(tmp_path):
    root, written = write_torture_archive(tmp_path)
    jreport = jmia.read_dicoms(folder_path=str(root)).report
    report = tmia.read_dicoms(folder_path=str(root)).report

    summary, jsummary = report.summary(), jreport.summary()
    for key in ("images", "doses", "plans", "rigid", "deformable",
                "failed", "failed_series", "unmatched_rtstructs",
                "unmatched_segs", "unverified"):
        assert summary[key] == jsummary[key], key
    assert {f.rsplit("/", 1)[-1] for f in report.failed_files} \
        == {"junk.dcm", "trunc.dcm", "trunc_pixels.dcm"}
    for key in ("image_list", "dose_list", "plan_list", "rigid_list",
                "deformable_list"):
        assert getattr(TData, key) == getattr(JData, key), key
    assert sorted(TData.roi_list) == sorted(JData.roi_list)
    assert sorted({TData.image[n].modality for n in TData.image_list}) \
        == ["CT", "MR", "NM", "PT", "US"]
    assert len(TData.image_list) == 10
    assert_same_images()

    for name in TData.image_list:
        t, j = TData.image[name], JData.image[name]
        assert sorted(t.rois) == sorted(j.rois)
        assert sorted(t.pois) == sorted(j.pois)
        for roi in t.rois:
            if t.rois[roi].contour_position:
                np.testing.assert_array_equal(
                    t.rois[roi].compute_mask(),
                    np.asarray(j.rois[roi].compute_mask()))
        for poi in t.pois:
            np.testing.assert_array_equal(
                np.asarray(t.pois[poi].point_position),
                np.asarray(j.pois[poi].point_position))
    by_mod = {TData.image[n].modality: TData.image[n]
              for n in TData.image_list}
    np.testing.assert_array_equal(by_mod["US"].array, written["us"])
    assert by_mod["NM"].array.dtype == np.float32
    np.testing.assert_array_equal(by_mod["NM"].array,
                                  written["nm"].astype(np.float32))

    rigid, jrigid = (d.rigid[d.rigid_list[0]] for d in (TData, JData))
    np.testing.assert_array_equal(rigid.matrix, jrigid.matrix)
    assert (rigid.reference_name, rigid.moving_name) \
        == (jrigid.reference_name, jrigid.moving_name)
    deform, jdeform = (d.deformable[d.deformable_list[0]]
                       for d in (TData, JData))
    np.testing.assert_array_equal(deform.dvf.cpu().numpy(),
                                  np.asarray(jdeform.dvf, np.float32))
    np.testing.assert_array_equal(deform.rigid_matrix, jdeform.rigid_matrix)

    dose, jdose = TData.dose["RTDOSE 01"], JData.dose["RTDOSE 01"]
    np.testing.assert_array_equal(dose.array, np.asarray(jdose.array))
    np.testing.assert_array_equal(dose.origin, jdose.origin)
    anat = rigid.reference_name
    stats = dose.compute_roi_dose_statistics(anat, "Target")
    jstats = jdose.compute_roi_dose_statistics(anat, "Target")
    for key in ("Dmean", "Dmax", "D95"):
        np.testing.assert_allclose(stats[key], jstats[key], atol=1e-4)
    plan, jplan = TData.plan["RTPLAN 01"], JData.plan["RTPLAN 01"]
    assert plan.linked_dose_names() == jplan.linked_dose_names()
    assert plan.summary() == jplan.summary()
