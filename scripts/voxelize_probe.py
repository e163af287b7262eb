#!/usr/bin/env python3
"""Mesh voxelization at clinical size on the CPU, in both packages:
each device path against its own float64 host twin.

    JAX_PLATFORMS=cpu python3 scripts/voxelize_probe.py     # about 1 min

The mesh: a body-sized ellipsoid mask on a 128 x 512 x 512 grid (radii
70, 160 and 205 voxels), marching tetrahedra, 20 Taubin steps, then each
vertex moved by a seeded N(0, 1e-3) pixel jitter (about 1.15 M points,
2.3 M faces, the size of chip_smoke.py's external). For each slicing
plane it prints one JSON line: the voxels and the ray columns on which
the port's device path (ops/voxelize, run on the CPU) differs from the
port's host twin, and the same for the JAX package's XLA device path
against its host twin (Axial; with ``--no-jax`` only the port's). A
whole column differing is a ray that no face (or two faces) claimed.
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
SHAPE = (128, 512, 512)


def body_mesh():
    from medicalimageanalysis_torch.ops.marching_cubes import (
        marching_cubes_mask)
    from medicalimageanalysis_torch.utils.mesh.surface import taubin_smooth

    S, H, W = SHAPE
    zz, yy, xx = np.ogrid[0:S, 0:H, 0:W]
    mask = (((zz - 63.5) / 70) ** 2 + ((yy - 260) / 160) ** 2
            + ((xx - 250) / 205) ** 2 <= 1).astype(np.uint8)
    mesh = taubin_smooth(marching_cubes_mask(torch.as_tensor(mask)),
                         iterations=20, passband=0.001, device="cpu")
    pts = mesh.points + np.random.default_rng(0).normal(
        0, 1e-3, mesh.points.shape)
    return pts, mesh.faces.astype(np.int64)


def differ(got, want):
    at = np.argwhere(got != want)
    return dict(voxels=int(len(at)), columns=int(
        len(np.unique(at[:, 1:], axis=0)) if len(at) else 0))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--no-jax", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from medicalimageanalysis_torch.ops.voxelize import voxelize_mesh_device
    from medicalimageanalysis_torch.utils.convert.voxelize import (
        host_voxelize)

    pts, faces = body_mesh()
    print(json.dumps(dict(points=len(pts), faces=len(faces),
                          shape=list(SHAPE))), flush=True)
    for plane in ("Axial", "Coronal", "Sagittal"):
        t0 = time.perf_counter()
        got = voxelize_mesh_device(pts, faces, SHAPE, plane=plane,
                                   device="cpu")
        t1 = time.perf_counter()
        want = host_voxelize(pts, faces, SHAPE, plane)
        row = dict(plane=plane, port=differ(got, want),
                   port_s=t1 - t0, host_s=time.perf_counter() - t1)
        if plane == "Axial" and not args.no_jax:
            from medicalimageanalysis_tpu.ops.voxelize import (
                voxelize_mesh_device as jax_device)
            from medicalimageanalysis_tpu.utils.convert.voxelize import (
                voxelize_mesh as jax_voxelize)
            row["jax"] = differ(jax_device(pts, faces, SHAPE, plane=plane),
                                jax_voxelize(pts, faces, SHAPE, plane=plane,
                                             backend="host"))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
