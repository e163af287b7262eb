#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python benchmark/run.py --workload dirlab-4dct.demons --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout. The cell's configuration, traffic mix and
metrics are found by name from ``BENCHMARK.json`` (see
``benchmark/harness/__init__.py``). Set-up makes the inputs from the seed
on the card and runs one job of every shape the traffic uses; then jobs
run in a closed loop for ``--seconds``. ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a
torch.profiler trace of the window. After the window the sampled output
is checked against the plain reference: the numbers compared go to
standard error as the last lines, each beside its limit, and into the
result's ``checks``. The last line of standard output is the result.

Exits non-zero, and prints no result, without a CUDA card (or with fewer
than the cell asks for), or if JAX or the JAX package was imported.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import resource
import subprocess
import time
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def build_caches(root=ROOT):
    """Every build and kernel cache at a fixed path inside the checkout
    (``build/``, where the port also builds its CUDA and C++ libraries),
    so that only a checkout's first run compiles."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(root / "build" / sub)


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run_cell(workload, seed, seconds, traced, device, manifest=None,
             config=None, mix=None, limits=None):
    """One run of ``workload``: returns (result dict, checks). ``config``,
    ``mix`` and ``limits`` replace the files' (the tests' small sizes);
    ``device`` 'cpu' runs the port's plain versions (the tests)."""
    from medicalimageanalysis_torch.device import using_device

    with using_device(None if device == "cuda" else device):
        return _run_cell(workload, seed, seconds, traced, device, manifest,
                         config, mix, limits)


def _run_cell(workload, seed, seconds, traced, device, manifest, config,
              mix, limits):
    import torch

    from harness import core
    from harness.tracing import Trace

    manifest = manifest or core.load_manifest()
    cell, cfg_entry, e2e, layer = core.cell_spec(manifest, workload)
    config = config or core.load_config(cfg_entry)
    mix = mix or core.load_traffic(cell["traffic"])
    if limits is None:
        path = HERE / "limits" / f"{workload}.json"
        limits = core.load_json(path) if path.exists() else {}
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    split = {"imports": core.process_age_s()}
    job_class = core.job_class(mix["job"])
    if on_card:
        # the hand kernels the traffic launches, built or loaded here
        # rather than at their first launch, so that set-up splits
        from medicalimageanalysis_torch.ops import _build

        for name in job_class.KERNELS:
            getattr(_build, f"load_{name}_library")()
    split["kernels"] = core.process_age_s()
    job = job_class(config, mix, seed, device, limits)
    sync()
    split["inputs"] = core.process_age_s()
    job.warm()
    sync()
    run = core.Run(workload, traced)
    run.setup_s = split["warm_job"] = core.process_age_s()
    before = launch_shapes()
    usage = resource.getrusage(resource.RUSAGE_SELF)
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        if on_card:
            # a trace can lose its first device records: short sleeps go
            # first, outside the window
            for _ in range(8):
                torch.cuda._sleep(2000)
            sync()
        with torch.profiler.record_function("bench.window"):
            core.measure(job, run, seconds, sync)
        prof.stop()
        run.trace = Trace.from_profiler(prof)
        del prof
    else:
        core.measure(job, run, seconds, sync)
    host = host_usage(usage, resource.getrusage(resource.RUSAGE_SELF))
    after = launch_shapes()
    run.launch_shapes = {k: {s: n - before[k].get(s, 0)
                             for s, n in v.items()
                             if n - before[k].get(s, 0) > 0}
                         for k, v in after.items()}
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics = {}
    for m in (layer if traced else e2e):
        value = core.load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    marks = list(split.items())
    took = [b - a for a, b in run.jobs]
    result = {"correct": False, "attempted": len(run.jobs) + run.failed,
              "failed": run.failed, "metrics": metrics, "device": dev,
              "setup_split_s": {k: v - (marks[i - 1][1] if i else 0.0)
                                for i, (k, v) in enumerate(marks)},
              "job_s": {"first": took[:3],
                        "quartiles": core.quartiles(took),
                        "max": max(took, default=None)}}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    run.trace = None
    job.release()
    host.update(host_probe())
    result["host"] = host
    checks = job.check()
    ok = bool(run.jobs) and run.failed == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)
    result["correct"] = ok
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    return result, checks


def host_usage(a, b):
    """The CPU seconds this process used in the window (getrusage):
    context to read a run's host-bound metrics by, no metric."""
    return {"cpu_s": b.ru_utime + b.ru_stime - a.ru_utime - a.ru_stime}


def host_probe():
    """The host's speed after the window, on fixed work: a Python loop
    and 256 MiB of fresh memory touched. Runs that differ in these differ
    by the machine, not by the program."""
    import numpy as np

    t0 = time.perf_counter()
    x = 0
    for i in range(2_000_000):
        x += i
    t1 = time.perf_counter()
    a = np.empty(1 << 25)
    a.fill(1.0)
    t2 = time.perf_counter()
    del a
    return {"python_loop_s": t1 - t0, "touch_256mib_s": t2 - t1}


def launch_shapes():
    """The port's hand-kernel launches by shape, so far: {'warp': {(op, B,
    grad, out dims, volume dims): n}, 'hist': {(n, bins): n}}."""
    from medicalimageanalysis_torch.ops import hist, warp

    return {"warp": dict(warp.LAUNCH_SHAPES),
            "hist": dict(hist.LAUNCH_SHAPES)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    build_caches()
    sys.path[:0] = [str(HERE), str(ROOT)]
    from harness import core

    cell = core.cell_spec(core.load_manifest(), args.workload)[0]
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    card = power_limit()
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda")
    result["device"]["nvidia_smi"] = card
    found = core.forbidden_modules()
    if found:
        print(f"the run imported {found}: the benchmark measures the "
              f"PyTorch port alone", file=sys.stderr)
        return 4
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
