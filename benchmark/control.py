#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from, on the card.

    python benchmark/control.py --workload dirlab-4dct.demons \
        --seeds 11,12,13 --seconds 3 [--variants program,control,float32]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, and then every number the job can compare, for the
program's kept output (``program``), for the plain reference computed one
precision step below the configuration's in the program's place
(``control``), and where the job has it for other variants. One JSON line
a seed and variant. The lower reading of a limit is the largest that the
program gives over a dozen seeds or more; the upper the smallest that the
control gives (PERF.md gives both for each limit). The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(workload, seeds, seconds, variants, device, config=None,
             mix=None, manifest=None):
    """Yield one dict a (seed, variant)."""
    import torch

    from harness import core
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.device import using_device

    manifest = manifest or core.load_manifest()
    cell, cfg_entry, _, _ = core.cell_spec(manifest, workload)
    config = config or core.load_config(cfg_entry)
    mix = mix or core.load_traffic(cell["traffic"])
    for seed in seeds:
        Data.clear()
        t0 = time.perf_counter()
        with using_device(None if device == "cuda" else device):
            job = core.job_class(mix["job"])(config, mix, seed, device, {})
            job.warm()
            run = core.Run(workload, False)
            core.measure(job, run, seconds, lambda: torch.cuda.synchronize()
                         if torch.device(device).type == "cuda" else None)
            job.release()
        for variant in variants:
            t1 = time.perf_counter()
            with using_device(None if device == "cuda" else device):
                got = job.stats(variant)
            yield dict(workload=workload, seed=seed, variant=variant,
                       jobs=len(run.jobs), seconds=time.perf_counter() - t1,
                       run_s=t1 - t0, **got)
        del job


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--variants", default="program,control")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    sys.path[:0] = [str(HERE), str(ROOT)]
    from run import build_caches

    build_caches()
    import torch

    if not torch.cuda.is_available():
        print("control.py reads the card: no CUDA device", file=sys.stderr)
        return 3
    out = open(args.out, "a") if args.out else None
    for row in readings(args.workload,
                        [int(s) for s in args.seeds.split(",")],
                        args.seconds, args.variants.split(","), "cuda"):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
