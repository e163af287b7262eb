"""Adaptive-radiotherapy walkthrough of the port: SEG ingest, deformable
dose accumulation, DICOM export.

The twin of examples/adaptive_rt.py, on a 16 x 48 x 48 planning CT:

1. planning CT + auto-segmentation as a DICOM SEG object
2. fraction image (anatomy shifted) + fraction RTDOSE on its grid
3. demons deformable registration fraction -> planning
4. ``accumulate_dose`` warps the fraction dose onto the planning grid
   (the CUDA warp kernel) and sums plan + warped fraction as a Dose
5. DVH statistics on the accumulated dose over the SEG-derived ROI, the
   Jacobian QA, ``compare_rois``, gamma, EQD2 and TCP
6. export: accumulated dose as RTDOSE, contours as RTSTRUCT + SEG, the
   deformable REG, and the export folder read back

    python -m medicalimageanalysis_torch.examples.adaptive_rt [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np

from ._common import cli, host, work_folder


def make_anatomy(shift=0):
    zz, yy, xx = np.mgrid[0:16, 0:48, 0:48]
    body = 1000 * np.exp(-(((zz - 8) / 6.0) ** 2
                           + ((yy - 24) / 14.0) ** 2
                           + ((xx - 24 - shift) / 14.0) ** 2)) - 1000
    return body.astype(np.int16)


def write_fraction_dose(path, frame, fx_dose):
    """The fraction dose as an RTDOSE file tied to the fraction's frame."""
    from medicalimageanalysis_torch.dicom import (Dataset, dcmwrite,
                                                  generate_uid, uids)

    ds = Dataset()
    ds.SOPClassUID = uids.RTDoseStorage
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = "RTDOSE"
    ds.FrameOfReferenceUID = frame
    ds.ImagePositionPatient = [-100.0, -100.0, -40.0]
    ds.ImageOrientationPatient = [1, 0, 0, 0, 1, 0]
    ds.PixelSpacing = [1.0, 1.0]
    ds.SliceThickness = 2.0
    ds.GridFrameOffsetVector = [2.0 * i for i in range(16)]
    ds.DoseGridScaling = 1e-3
    ds.DoseUnits = "GY"
    ds.DoseType = "PHYSICAL"
    ds.DoseSummationType = "FRACTION"
    ds.NumberOfFrames, ds.Rows, ds.Columns = 16, 48, 48
    ds.BitsAllocated = ds.BitsStored = 32
    ds.HighBit = 31
    ds.PixelRepresentation = 0
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "MONOCHROME2"
    ds.PixelData = np.round(fx_dose / 1e-3).astype("<u4").tobytes()
    dcmwrite(path, ds)


def main(device=None, workdir=None):
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.device import using_device
    from medicalimageanalysis_torch.utils import (accumulate_dose,
                                                  compare_rois,
                                                  register_dose_grid)
    from medicalimageanalysis_torch.utils.creation import CreateDicomImage

    tmp = work_folder(workdir, "mia_art_")
    out = {}
    with using_device(device):
        # -- 1. planning CT + SEG ------------------------------------------
        CreateDicomImage(os.path.join(tmp, "plan_ct"), make_anatomy(0),
                         origin=[-100, -100, -40], spacing=[1.0, 1.0],
                         thickness=2.0).run(patient_name="ART^Demo")
        mia.read_dicoms(folder_path=os.path.join(tmp, "plan_ct"))
        plan_ct = Data.image_list[0]
        img = Data.image[plan_ct]

        target = np.zeros((16, 48, 48), np.uint8)
        target[5:11, 16:33, 16:33] = 1
        img.create_roi(name="GTV", color=[255, 40, 40])
        img.rois["GTV"].convert_mask(target)
        seg_path = os.path.join(tmp, "plan_ct", "seg.dcm")
        img.create_seg(path=seg_path)
        print("wrote SEG:", seg_path)

        # -- 2. fraction image (anatomy shifted 3 px in x) + fraction dose -
        fx_gen = CreateDicomImage(os.path.join(tmp, "fx_ct"),
                                  make_anatomy(3),
                                  origin=[-100, -100, -40],
                                  spacing=[1.0, 1.0], thickness=2.0)
        fx_gen.run(modality="MR")
        fx_dose = np.zeros((16, 48, 48), np.float32)
        fx_dose[5:11, 16:33, 19:36] = 2.0   # 2 Gy fraction
        write_fraction_dose(os.path.join(tmp, "fx_ct", "rd_fx.dcm"),
                            fx_gen.frame, fx_dose)

        # -- one combined ingest: plan CT + SEG + fraction MR + dose -------
        Data.clear()
        mia.read_dicoms(folder_path=tmp)
        plan_ct = [n for n in Data.image_list
                   if Data.image[n].modality == "CT"][0]
        img = Data.image[plan_ct]
        assert "GTV" in img.rois, "SEG did not round-trip"
        print("SEG ingested from disk, ROIs:", list(img.rois))
        fx_name = [n for n in Data.image_list
                   if Data.image[n].modality == "MR"][0]
        fx_dose_name = Data.dose_list[0]
        print("fraction dose:", fx_dose_name)

        # -- 3. deformable registration fraction -> planning ---------------
        deform = mia.Deformable(reference_name=plan_ct, moving_name=fx_name,
                                roi_names=[])
        deform.compute_demons(method="demons", modality_gradient=False,
                              iterations=60, crop=0)
        print("demons field:", tuple(host(deform.dvf).shape))

        # -- 4. warp fraction dose + accumulate on the planning grid -------
        acc = accumulate_dose(
            plan_ct, [(fx_dose_name, deform.deformable_name)],
            weights=[30.0],             # 30 identical fractions
            name="Accumulated")
        out["accumulated_max_gy"] = float(host(acc.array).max())
        print("accumulated dose:", acc.dose_name,
              "max %.2f Gy" % out["accumulated_max_gy"])

        # -- 5. DVH on the SEG-derived ROI ---------------------------------
        stats = acc.compute_roi_dose_statistics(plan_ct, "GTV")
        out["gtv_dvh"] = {k: (round(v, 2) if isinstance(v, float) else v)
                          for k, v in stats.items()
                          if k in ("ROI", "Volume (cc)", "Dmin", "Dmax",
                                   "Dmean", "D95")}
        print("GTV DVH:", out["gtv_dvh"])
        bins, vol_pct = acc.compute_dvh_curve(plan_ct, "GTV")
        print("DVH curve points:", len(bins),
              "V(0)=%.1f%%" % vol_pct[0] if len(bins) else "")

        # -- 5b. registration QA before trusting the accumulation ----------
        qa = deform.compute_jacobian()
        out["jacobian"] = qa
        print("jacobian QA: folding %.4f%%, det in [%.3f, %.3f]" % (
            100 * qa["folding_fraction"], qa["det_min"], qa["det_max"]))

        # contour QA: propagate the fraction-day GTV back (voxel indicator
        # warp, Deformable.update_mask) and compare with the plan GTV
        fx_target = np.zeros((16, 48, 48), np.uint8)
        fx_target[5:11, 16:33, 19:36] = 1           # GTV on the fraction
        mapped = host(deform.update_mask(fx_target))
        img.create_roi(name="GTV_fx_mapped", color=[255, 200, 0])
        img.rois["GTV_fx_mapped"].convert_mask(mapped)
        panel = compare_rois(img, "GTV", "GTV_fx_mapped", tolerance_mm=2.0)
        out["panel"] = {k: round(v, 3) for k, v in panel.items()}
        print("GTV vs mapped fraction GTV:", out["panel"])

        # -- 5c. dose QA: gamma against the planned course (3 %/3 mm) -----
        planned = register_dose_grid(
            host(Data.dose[fx_dose_name].array).astype(np.float32) * 30.0,
            Data.dose[fx_dose_name], name="Planned course")
        g = planned.compute_gamma("Accumulated", dose_pct=3.0, dta_mm=3.0)
        out["gamma"] = g
        print("gamma 3%%/3mm: pass %.1f%% (mean %.2f, max %.2f over %d vox)"
              % (g["pass_rate"], g["mean"], g["max"], g["analysed_voxels"]))

        # -- 5d. radiobiology: EQD2-weighted DVH + outcome models ----------
        acc_eqd2 = acc.compute_eqd2(n_fractions=30, alpha_beta=10.0,
                                    name="Accumulated EQD2")
        s2 = acc_eqd2.compute_roi_dose_statistics(plan_ct, "GTV")
        out["eqd2_dmean_gy"] = s2["Dmean"]
        print("GTV EQD2 Dmean %.2f Gy (physical %.2f)"
              % (s2["Dmean"], stats["Dmean"]))
        tcp = acc_eqd2.compute_tcp(plan_ct, "GTV", tcd50=45.0, gamma50=2.0)
        # cold spots drive a < 0: the fraction dose never covered some GTV
        # voxels (D95 is ~23 Gy), so the gEUD collapses and TCP ~ 0
        d = host(acc_eqd2.compute_roi_dose_array(plan_ct, "GTV"))
        out["tcp"] = tcp
        print("TCP(logistic, EQD2): %.1f%% at gEUD %.1f Gy "
              "(%d cold voxels < 5 Gy drive it)"
              % (100 * tcp["tcp"], tcp["gEUD"], int((d < 5.0).sum())))

        # -- 6. export everything back to DICOM ----------------------------
        export = os.path.join(tmp, "export")
        os.makedirs(export, exist_ok=True)
        acc.create_rtdose(path=os.path.join(export, "rd_accumulated.dcm"),
                          dose_summation_type="MULTI_PLAN")
        img.create_rtstruct(path=os.path.join(export, "rs.dcm"))
        img.create_seg(path=os.path.join(export, "seg.dcm"))
        deform.create_reg(path=os.path.join(export, "dvf_reg.dcm"))
        out["exported"] = sorted(os.listdir(export))
        print("exported:", out["exported"])

        # the exported accumulated dose re-ingests
        Data.clear()
        mia.read_dicoms(folder_path=export)
        out["reingested_doses"] = list(Data.dose_list)
        print("re-ingest of export dir:", "doses:", Data.dose_list,
              "(images: none, as expected)" if not Data.image_list else "")
        print("OK")
    return out


if __name__ == "__main__":
    cli(main, __doc__)
