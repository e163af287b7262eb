#!/usr/bin/env python3
"""Full-size card checks behind two choices of chip_smoke.py's
registration_rest phase: the elastix map it holds to its bounds and the
ROI meshes it holds ICP to.

    python3 scripts/registration_probe.py elastix   # about 4 minutes
    python3 scripts/registration_probe.py icp       # about 4 minutes

- ``elastix``: on chip_smoke's bump pair (the reference phantom and its
  4 mm Gaussian-bump copy, 128 x 512 x 512), DeformableTorch.elastix at
  its defaults ("Intensity", mean squares) and with metric="MI",
  elastix_registration at its defaults, and mean-squares / MI maps of
  other level counts, grid spacings, steps and rates; each field's
  residual ratio in the body and its error against the known bump
  (median, p95), as the phase measures them. Then fast demons (4, 2, 1)
  masked by a "Body" external on both images, and unmasked, each
  ratio inside the mask.
- ``icp``: chip_smoke's structure set on the reference phantom, meshed
  by Roi.create_mesh; on the left lung and the heart, each moved by
  ICP_MOTION, Rigid.compute_icp_vtk and compute_o3d (point with the
  default tolerance and with rmse=0, plane) and the VTK variant over
  every vertex; the vertex RMS against the known motion, the steps, the
  mean distance and the seconds.

One JSON line per case. Needs the card (prints its name and power
limit first).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def elastix(dev, ref, mov):
    from medicalimageanalysis_torch import interop
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch.ops.registration.bspline import (
        elastix_registration)
    from medicalimageanalysis_torch.ops.registration.dvf import (
        invert_dvf, warp_volume)
    from medicalimageanalysis_torch.utils.deformable.torch_backend import (
        DeformableTorch)

    fixed, moving = ref.astype(np.float32), mov.astype(np.float32)
    body = fixed > -900.0
    g = cs.known_bump()

    def score(name, fn):
        torch.cuda.synchronize()
        t0 = time.time()
        info = {}
        d = fn(info)
        torch.cuda.synchronize()
        s = time.time() - t0
        w = warp_volume(moving, d, cs.SPACING, background=-3001.0,
                        device=dev).cpu().numpy()
        pf = invert_dvf(d, cs.SPACING, device=dev)
        pf = pf.cpu().numpy() if torch.is_tensor(pf) else pf
        err = np.sqrt((pf[..., 0] - cs.BUMP_MM * g) ** 2
                      + (pf[..., 1] - cs.BUMP_MM * g) ** 2
                      + pf[..., 2] ** 2)[body]
        print(json.dumps({
            "case": name, "s": s,
            "ratio": cs.residual_ratio(w, moving, fixed, body),
            "p50_p95": list(np.percentile(err, [50, 95])),
            "max_abs_d": float(np.abs(d).max()),
            "level_s": info.get("level_seconds")}), flush=True)

    def backend(info, **kw):
        b = DeformableTorch(device=dev)
        b.create_sitk_image(ref, cs.REF_ORIGIN, cs.SPACING, np.eye(3))
        b.create_sitk_image(mov, cs.REF_ORIGIN, cs.SPACING, np.eye(3),
                            reference=False)
        return b.elastix(info=info, **kw)["array"]

    score("backend_default_mse", backend)
    score("backend_mi", lambda info: backend(info, metric="MI"))
    score("registration_defaults_mi", lambda info: elastix_registration(
        fixed, moving, cs.SPACING, device=dev, info=info)[0])
    for res, grid, its, lr in ((3, 40.0, 100, 0.25), (4, 20.0, 150, 0.25),
                               (4, 10.0, 300, 0.1), (4, 20.0, 300, 0.25)):
        for metric in ("mse", "mi"):
            score(f"{metric}_r{res}_g{grid}_i{its}_lr{lr}",
                  lambda info: elastix_registration(
                      fixed, moving, cs.SPACING, metric=metric,
                      resolutions=res, final_grid_spacing=grid,
                      iterations=its, lr=lr, device=dev, info=info)[0])

    a = interop.image_from_arrays(ref, cs.SPACING, cs.REF_ORIGIN, np.eye(3),
                                  "CT", "ref")
    b = interop.image_from_arrays(mov, cs.SPACING, cs.REF_ORIGIN, np.eye(3),
                                  "CT", "def")
    for im in (a, b):
        im.create_external(name="Body")
    mask = mia.Deformable(reference_name="ref", moving_name="def",
                          roi_names=["Body"], device=dev).roi_mask_union()[0]
    for roi_names in (["Body"], []):
        d = mia.Deformable(reference_name="ref", moving_name="def",
                           roi_names=roi_names, device=dev)
        t0 = time.time()
        d.compute_demons(method="fast", pyramid=cs.DEMONS_PYRAMID)
        torch.cuda.synchronize()
        s = time.time() - t0
        out = d.create_image()["array"]
        keep = (mask > 0) & (out != -3001.0)
        print(json.dumps({
            "case": "masked_demons" if roi_names else "unmasked_demons",
            "s": s, "ratio_in_mask": float(
                np.abs(out - fixed)[keep].mean()
                / np.abs(moving - fixed)[keep].mean()),
            "dvf_shape": list(d.dvf.shape)}), flush=True)


def icp(dev, ref):
    import medicalimageanalysis_torch as mia
    from scipy.spatial.transform import Rotation

    from medicalimageanalysis_torch import interop
    from medicalimageanalysis_torch.utils.mesh.trimesh import TriMesh

    img = interop.image_from_arrays(ref, cs.SPACING, cs.REF_ORIGIN,
                                    np.eye(3), "CT", "ref")
    interop.rois_from_numpy(img, {n: [c for c, _ in v]
                                  for n, v in cs.structure_set().items()})
    for name in ("Lung_L", "Heart"):
        img.rois[name].create_mesh()
        mesh = img.rois[name].mesh
        c = np.asarray(mesh.points, np.float64).mean(axis=0)
        axis = np.array([1.0, -2.0, 0.5]) / np.linalg.norm([1.0, -2.0, 0.5])
        R = Rotation.from_rotvec(np.deg2rad(cs.ICP_MOTION[0]) * axis) \
            .as_matrix()
        M = np.eye(4)
        M[:3, :3] = R
        M[:3, 3] = c - R @ c + cs.ICP_MOTION[1] * np.array([0.6, 0.0, 0.8])
        target = TriMesh(np.asarray(mesh.points, np.float64) @ R.T
                         + M[:3, 3], np.asarray(mesh.faces))
        pts = np.asarray(mesh.points, np.float64)
        want = pts @ R.T + M[:3, 3]
        for key, entry, kw in (
                ("vtk", "compute_icp_vtk", {}),
                ("o3d_point", "compute_o3d",
                 dict(method="point", iterations=200)),
                ("o3d_point_rmse0", "compute_o3d",
                 dict(method="point", iterations=300, rmse=0.0)),
                ("o3d_plane", "compute_o3d",
                 dict(method="plane", iterations=200)),
                ("vtk_all", "compute_icp_vtk",
                 dict(landmarks=len(pts), distance=0.0, iterations=300))):
            rigid = mia.Rigid("ref", "ref", device=dev)
            torch.cuda.synchronize()
            t0 = time.time()
            getattr(rigid, entry)(
                TriMesh(mesh.points.copy(), mesh.faces.copy()),
                TriMesh(target.points.copy(), target.faces.copy()), **kw)
            torch.cuda.synchronize()
            s = time.time() - t0
            G = np.asarray(rigid.matrix)
            got = pts @ G[:3, :3].T + G[:3, 3]
            info = rigid.misc["icp_info"]
            print(json.dumps({
                "roi": name, "vertices": int(len(pts)), "case": key,
                "rms": float(np.sqrt(np.mean(np.sum((got - want) ** 2, 1)))),
                "it": int(info["iterations"]),
                "md": float(info["mean_distance"]), "s": s}), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("probe", choices=["elastix", "icp"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("registration_probe: no CUDA device", file=sys.stderr)
        return 2
    from medicalimageanalysis_torch.device import (set_default_device,
                                                   set_numerics)
    set_numerics()
    dev = torch.device("cuda", 0)
    set_default_device(dev)
    print(cs.nvidia_smi(), flush=True)
    ref = cs.phantom(torch.Generator().manual_seed(cs.SEED))
    if args.probe == "elastix":
        elastix(dev, ref, cs.bump_deformed(ref))
    else:
        icp(dev, ref)
    return 0


if __name__ == "__main__":
    sys.exit(main())
