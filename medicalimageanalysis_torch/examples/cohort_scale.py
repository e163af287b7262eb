"""Cohort-scale walkthrough of the port on a (data, space) mesh.

The twin of examples/cohort_scale.py. The JAX example builds a virtual
8-device CPU mesh; here the mesh has 8 logical devices, space = 2: the
card repeated (the shards share it and run in lockstep), or the CPU when
asked for. On a cohort of four 16 x 64 x 64 CT series written to disk:

1. ``ingest_cohort``  - read_dicoms + the batched preprocess, split
                        over 'data';
2. the rigid batch    - every pair descends together, the pair axis
                        split over 'data';
3. ``demons_batch``   - deformable refinement over 'data';
4. ``demons_z_sharded`` - one volume z-sharded over 'space' with halo
                        exchange;
5. ``compare_masks_batch`` and ``dvh_batch`` over 'data';
6. ``rasterize_batch`` of every ROI's contours, and the meshes of
   ``mask_to_mesh`` voxelized back by ``voxelize_batch``.

    python -m medicalimageanalysis_torch.examples.cohort_scale [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ._common import cli, host, work_folder

N_DEVICES = 8
SPACE = 2


def main(device=None, workdir=None):
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.device import (default_device,
                                                   using_device)
    from medicalimageanalysis_torch.models.rigid_intensity import (
        register_rigid_intensity_batch)
    from medicalimageanalysis_torch.ops import geometry as geo
    from medicalimageanalysis_torch.ops.marching_cubes import mask_to_mesh
    from medicalimageanalysis_torch.ops.voxelize import voxelize_batch
    from medicalimageanalysis_torch.parallel.batch import (
        compare_masks_batch, demons_batch, dvh_batch, rasterize_batch)
    from medicalimageanalysis_torch.parallel.cohort import ingest_cohort
    from medicalimageanalysis_torch.parallel.halo import demons_z_sharded
    from medicalimageanalysis_torch.parallel.mesh import make_mesh
    from medicalimageanalysis_torch.utils.creation import CreateDicomImage

    tmp = work_folder(workdir, "mia_cohort_")
    out = {}
    with using_device(device):
        dev = default_device()
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(N_DEVICES, space=SPACE, devices=[dev] * N_DEVICES)
        print(f"mesh: {dict(mesh.shape)} on {dev.type}")

        # -- synthesize a cohort: 4 patients, same anatomy, per-patient shift
        rng = np.random.default_rng(0)
        zz, yy, xx = np.mgrid[0:16, 0:64, 0:64].astype(np.float32)
        body = (np.exp(-(((zz - 8) / 5) ** 2 + ((yy - 32) / 18) ** 2
                         + ((xx - 32) / 18) ** 2)) * 1200 - 1000)
        for p in range(4):
            arr = np.roll(body, shift=p, axis=2) \
                + rng.normal(0, 8, body.shape)
            CreateDicomImage(os.path.join(tmp, f"pat{p}"),
                             arr.astype(np.int16), spacing=[1.0, 1.0],
                             thickness=2.0).run()

        # -- 1. cohort ingest: one batched preprocess over 'data' -----------
        results = ingest_cohort(folder_path=tmp, out_shape=(16, 64, 64),
                                mesh=mesh)
        names = sorted(results)
        vols = np.stack([host(results[n]["volume"]) for n in names])
        print(f"ingested {len(names)} series; volume[0] "
              f"{vols[0].shape}, device-resident")

        # -- 2. batched rigid registration over 'data' ----------------------
        B = vols.shape[0]
        refs = np.broadcast_to(vols[0], vols.shape).copy()
        p2p = geo.pixel_to_position_matrix(np.eye(3), np.ones(3),
                                           np.zeros(3)).astype(np.float32)
        pos2pix = np.linalg.inv(p2p).astype(np.float32)
        centers = np.tile(np.array([32.0, 32.0, 8.0], np.float32), (B, 1))
        lo, hi = np.percentile(refs, [2, 98])

        def nrm(a):
            return np.clip((a - lo) / max(hi - lo, 1e-6), 0, 1) \
                .astype(np.float32)

        poses, _ = register_rigid_intensity_batch(
            nrm(refs), nrm(vols),
            np.broadcast_to(p2p, (B, 4, 4)).copy(),
            np.broadcast_to(pos2pix, (B, 4, 4)).copy(), centers,
            levels=((2, 40, 0.2), (1, 25, 0.05)), mesh=mesh)
        poses = host(poses)
        # series ingest order need not match patient order: shifts are
        # relative to the first series; the SET must be {0,1,2,3} + offset
        rel = np.round(poses[:, 3] - poses[:, 3].min()).astype(int)
        out["x_shifts"] = poses[:, 3]
        out["relative_shifts"] = sorted(rel.tolist())
        print("recovered x-shifts:", np.round(poses[:, 3], 2),
              f"-> relative set {out['relative_shifts']} "
              "(truth [0, 1, 2, 3])")

        # -- 3. batched demons over 'data' ----------------------------------
        dvfs = host(demons_batch(nrm(refs), nrm(vols), iterations=15,
                                 mesh=mesh))
        out["demons_batch_max_mm"] = float(np.abs(dvfs).max())
        print(f"demons batch DVFs {dvfs.shape}, "
              f"max |d| {out['demons_batch_max_mm']:.2f} mm")

        # -- 4. sequence-parallel demons: one volume over 'space' -----------
        d1 = host(demons_z_sharded(nrm(refs)[0], nrm(vols)[1], mesh,
                                   iterations=10, std=1, halo=8))
        out["z_sharded_max_mm"] = float(np.abs(d1).max())
        print(f"z-sharded demons DVF {d1.shape}, "
              f"max |d| {out['z_sharded_max_mm']:.2f} mm")

        # -- 5. cohort QA: the seg panel and the DVH over 'data' ------------
        masks_auto = np.stack([host(results[n]["mask"])
                               for n in names]).astype(np.uint8)
        masks_manual = np.roll(masks_auto, (0, 1, 1, -1), (0, 1, 2, 3))
        qa = compare_masks_batch(masks_auto, masks_manual, (1.0, 1.0, 1.0),
                                 tolerance_mm=2.0, mesh=mesh)
        out["dice"] = host(qa["dice"])
        out["hd95_mm"] = host(qa["hd95_mm"])
        print("seg QA dice:", np.round(out["dice"], 3),
              "hd95 mm:", np.round(out["hd95_mm"], 2))
        doses = np.abs(vols).astype(np.float32) \
            / max(np.abs(vols).max(), 1) * 70
        dvh = dvh_batch(doses, masks_auto, 0.001, mesh=mesh)
        out["dmean_gy"] = host(dvh["Dmean"])
        print("cohort DVH Dmean Gy:", np.round(out["dmean_gy"], 2))

        # -- 6. cohort geometry: every ROI's contours rasterized in one
        #       pooled pass; the meshes voxelized back ----------------------
        th = np.linspace(0, 2 * np.pi, 24, endpoint=False)
        S, Hh, Ww = masks_auto.shape[1:]
        sets = []
        for b in range(masks_auto.shape[0]):
            sets.append([np.stack([Ww / 2 + (6 + b) * np.cos(th),
                                   Hh / 2 + (5 + b) * np.sin(th),
                                   np.full_like(th, float(z))], axis=1)
                         for z in range(2, S - 2)])
        rois = rasterize_batch(sets, masks_auto.shape[1:], plane="Axial",
                               mesh=mesh)
        out["roi_voxels"] = rois.sum(axis=(1, 2, 3))
        print("cohort rasterized ROI voxels:", out["roi_voxels"])

        meshes = []
        for b in range(rois.shape[0]):
            m = mask_to_mesh(rois[b], [1.0, 1.0, 1.0], [0, 0, 0], np.eye(3))
            meshes.append((np.asarray(m.points, np.float64),
                           np.asarray(m.faces)))
        revox = voxelize_batch(meshes, rois.shape[1:], plane="Axial")
        out["overlap"] = [(revox[b] & rois[b]).sum() / max(rois[b].sum(), 1)
                          for b in range(rois.shape[0])]
        print("mesh->voxel round-trip overlap:", np.round(out["overlap"], 3))

        Data.clear()
        print("cohort walkthrough OK")
    return out


if __name__ == "__main__":
    cli(main, __doc__)
