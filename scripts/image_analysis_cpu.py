#!/usr/bin/env python3
"""Full-size CPU checks behind two choices of chip_smoke.py's
image-analysis phase: its MR control spacing and its demons_batch pairs.

    python3 scripts/image_analysis_cpu.py n4 [--jax]       # about 1 minute
    python3 scripts/image_analysis_cpu.py demons [--jax]   # about 5 minutes

- ``n4``: N4 of chip_smoke's MR phantom at MR_SHAPE, shrink 4, for two
  noise seeds and control-spacing floors of 32-256 voxels; the field's
  spread against tests/test_n4.py's recovery bound.
- ``demons``: demons_batch (fast, DEMONS_BATCH_ITERATIONS iterations) at
  DEMONS_BATCH_SHAPE on the phase's two pairs (chip_smoke.
  demons_batch_pairs) and on the deformed series registered to the
  reference; each residual ratio beside the known field's.

``--jax`` runs the JAX package's function beside the port's on the same
arrays (the residual ratios of both measured by the port's warp). Runs
on the CPU; no number here is a card figure.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from medicalimageanalysis_torch.device import set_default_device  # noqa: E402


def n4(with_jax):
    from medicalimageanalysis_torch.ops import n4 as tn4

    runs = [("port", tn4.n4_bias_correction)]
    if with_jax:
        from medicalimageanalysis_tpu.ops import n4 as jn4
        runs.append(("jax", jn4.n4_bias_correction))
    for seed in (cs.SEED, cs.SEED + 1):
        vol, _, bias = cs.mr_phantom(seed)
        arr = np.round(vol)
        limit = 0.25 * bias.std() / bias.mean()
        for floor in (32.0, 64.0, 128.0, 256.0):
            for name, fn in runs:
                t0 = time.perf_counter()
                _, field = fn(arr, shrink=cs.MR_SHRINK, return_field=True,
                              min_control_spacing=floor)
                r = field / bias
                r = r / r.mean()
                print(f"seed {seed} floor {floor:g} {name}: spread "
                      f"{r.std():.4f} (bound {limit:.4f}), "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)


def demons(with_jax):
    from medicalimageanalysis_torch.ops.registration.dvf import warp_volume
    from medicalimageanalysis_torch.parallel.batch import demons_batch

    ref = cs.phantom(torch.Generator().manual_seed(cs.SEED))
    fixed, moving, sp, known = cs.demons_batch_pairs(
        ref, cs.bump_deformed(ref), "cpu")
    del ref
    names = ("reference onto the deformed series",
             "reference onto the opposite bump",
             "deformed series onto the reference")
    # the third pair swaps the first: its known field is not on the grid
    fixed = torch.cat([fixed, moving[:1]])
    moving = torch.cat([moving, fixed[:1]])
    fields = [known[0], known[1], None]
    runs = [("port", lambda: demons_batch(
        fixed, moving, sp, method="fast",
        iterations=cs.DEMONS_BATCH_ITERATIONS, device="cpu"))]
    if with_jax:
        from medicalimageanalysis_tpu.parallel.batch import (
            demons_batch as j_demons_batch)
        runs.append(("jax", lambda: np.asarray(j_demons_batch(
            fixed.numpy(), moving.numpy(), sp, method="fast",
            iterations=cs.DEMONS_BATCH_ITERATIONS))))
    for run, fn in runs:
        t0 = time.perf_counter()
        dvfs = fn()
        seconds = time.perf_counter() - t0
        for b, name in enumerate(names):
            fx, mv = fixed[b], moving[b]
            body = fx.numpy() > -900.0

            def ratio(d):
                w = warp_volume(mv, torch.tensor(np.asarray(d)), sp,
                                background=-3001.0).numpy()
                return cs.residual_ratio(w, mv.numpy(), fx.numpy(), body)

            floor = "" if fields[b] is None \
                else f", known field {ratio(fields[b]):.4f}"
            print(f"{run}: {name}: residual ratio {ratio(dvfs[b]):.4f}"
                  f"{floor}", flush=True)
        print(f"{run}: {seconds:.1f} s for {len(names)} pairs", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what", choices=("n4", "demons"))
    parser.add_argument("--jax", action="store_true",
                        help="also run the JAX package's function")
    args = parser.parse_args()
    if args.jax:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
    set_default_device("cpu")
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    (n4 if args.what == "n4" else demons)(args.jax)


if __name__ == "__main__":
    main()
