"""End-to-end walkthrough of the port on synthetic data.

The twin of examples/end_to_end.py: ingest -> FFS volume, the external
ROI -> mask -> mesh, radiomics, rigid registration and the overlay
reslice, demons, save and the RTSTRUCT writer, on a 24 x 64 x 64 CT.

    python -m medicalimageanalysis_torch.examples.end_to_end [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np

from ._common import cli, host, work_folder


def main(device=None, workdir=None):
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.device import using_device
    from medicalimageanalysis_torch.utils.creation import CreateDicomImage

    tmp = work_folder(workdir, "mia_demo_")
    with using_device(device):
        # -- 1. synthesize + ingest a CT series ------------------------------
        zz, yy, xx = np.mgrid[0:24, 0:64, 0:64]
        body = 1000 * np.exp(-(((zz - 12) / 8.0) ** 2
                               + ((yy - 32) / 18.0) ** 2
                               + ((xx - 32) / 18.0) ** 2)) - 1000
        CreateDicomImage(os.path.join(tmp, "ct"), body.astype(np.int16),
                         origin=[-120, -120, -60], spacing=[1.0, 1.0],
                         thickness=2.5).run(patient_name="Demo^Patient")
        report = mia.read_dicoms(folder_path=tmp).report
        print("ingest:", report.summary())

        img = Data.image["CT 01"]
        print("volume:", img.array.shape, "spacing:", img.spacing,
              "origin:", img.origin)

        # -- 2. external contour -> ROI -> device mask -> mesh ---------------
        img.create_external(threshold=-250)
        ext = img.rois["External"]
        mask = ext.compute_mask()
        ext.create_mesh()
        external = dict(mask_voxels=int(host(mask).sum()),
                        mesh_points=int(ext.mesh.number_of_points),
                        volume_cc=round(ext.volume / 1000.0, 1))
        print("external: mask voxels", external["mask_voxels"],
              "mesh pts", external["mesh_points"],
              "volume cc", external["volume_cc"])

        # -- 2b. radiomics panel on the ROI (device texture counting) --------
        rx = img.compute_radiomics("External", bin_width=25.0)
        radiomics = dict(Ng=rx["meta"]["Ng"],
                         Mean=round(rx["firstorder"]["Mean"], 1),
                         Contrast=round(rx["glcm"]["Contrast"], 3),
                         Coarseness=round(rx["ngtdm"]["Coarseness"], 5),
                         Sphericity=round(rx["shape"]["Sphericity"], 3))
        print("radiomics: Ng", radiomics["Ng"],
              "firstorder Mean", radiomics["Mean"],
              "GLCM Contrast", radiomics["Contrast"],
              "NGTDM Coarseness", radiomics["Coarseness"],
              "Sphericity", radiomics["Sphericity"])

        # -- 3. a second (shifted) series + rigid registration ---------------
        moved = np.roll(body, shift=(1, -2), axis=(1, 2))
        CreateDicomImage(os.path.join(tmp, "mr"), moved.astype(np.int16),
                         origin=[-120, -120, -60], spacing=[1.0, 1.0],
                         thickness=2.5).run(modality="MR")
        mia.read_dicoms(folder_path=os.path.join(tmp, "mr"), clear=False)
        mr_name = [n for n in Data.image_list
                   if Data.image[n].modality == "MR"][0]

        rigid = mia.Rigid("CT 01", mr_name)
        rigid.compute_intensity(levels=((2, 60, 0.2), (1, 30, 0.05)))
        translation = np.round(rigid.retrieve_translation(), 2)
        print("rigid translation (mm):", translation)
        overlay = rigid.create_image()
        print("overlay grid:", host(overlay["array"]).shape)

        # -- 4. deformable registration --------------------------------------
        deform = mia.Deformable(reference_name="CT 01", moving_name=mr_name,
                                roi_names=[])
        deform.compute_demons(modality_gradient=False, iterations=25,
                              crop=0)
        dvf = host(deform.dvf)
        dvf_max = round(float(np.abs(dvf).max()), 2)
        print("DVF:", dvf.shape, "max |d| mm:", dvf_max)

        # -- 5. save / reload --------------------------------------------------
        img.save_image(os.path.join(tmp, "saved"))
        rs = img.create_rtstruct(path=os.path.join(tmp, "rs_out.dcm"))
        saved = sorted(os.listdir(os.path.join(tmp, "saved", "CT 01")))
        print("persisted:", saved, "+ RTSTRUCT with",
              len(rs.StructureSetROISequence), "structure(s)")
    return dict(volume_shape=tuple(img.array.shape), external=external,
                radiomics=radiomics, translation_mm=translation.tolist(),
                overlay_shape=tuple(host(overlay["array"]).shape),
                dvf_shape=dvf.shape, dvf_max_mm=dvf_max, persisted=saved)


if __name__ == "__main__":
    cli(main, __doc__)
