"""Cells, spans, the measured window and the result line.

A cell is one entry of ``workloads`` in ``BENCHMARK.json``: a
configuration file, a traffic file and the metrics that the manifest
gives it. ``run.py`` builds the job of the traffic's kind from the seed
(set-up, which warms every shape the traffic uses), runs jobs in a
closed loop for the window (:func:`measure`), reads the metrics, and
then checks the sampled output against the plain reference.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import random
import sys
import time
from collections import defaultdict
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "medicalimageanalysis_tpu")


def process_age_s():
    """Seconds since this process started (``/proc``); the clock of
    ``setup_s``, so that the interpreter's start and the imports count."""
    with open("/proc/self/stat") as f:
        stat = f.read()
    start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_manifest(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell_spec(manifest, workload):
    """(workload entry, config entry, end-to-end metric entries, per-layer
    metric entries) of one cell. A metric without ``workloads`` belongs to
    every cell; a per-layer metric without it to every cell that reports
    the end-to-end metric it moves."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in manifest["configs"]}[cell["config"]]

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in manifest["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return cell, config, e2e, layer


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_config(entry, root=ROOT):
    cfg = load_json(Path(root) / entry["file"])
    cfg.setdefault("name", entry["name"])
    return cfg


def load_traffic(name, bench=BENCH):
    mix = load_json(Path(bench) / "workloads" / f"{name}.json")
    mix.setdefault("name", name)
    return mix


def load_metric(name, bench=BENCH):
    """The reader module ``benchmark/metrics/<name>.py``."""
    path = Path(bench) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def job_class(kind):
    """The job kind a traffic file names: ``harness/jobs/<kind>.py``'s
    ``Job``."""
    return importlib.import_module(f"harness.jobs.{kind}").Job


def forbidden_modules(modules=None):
    """Names in ``sys.modules`` whose top-level name (the part before the
    first dot) is one of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in list(modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


class Run:
    """What one run records: the jobs' host intervals, the benchmark's
    own spans around the calls into each layer, and after a traced
    window its :class:`harness.tracing.Trace`."""

    def __init__(self, workload, traced):
        self.workload = workload
        self.traced = traced
        self.jobs = []                       # (start, end) per job
        self.spans = defaultdict(list)       # name -> [(start, end)]
        self.window = None                   # (start, end), perf_counter
        self.trace = None
        self.launch_shapes = {}              # kernel -> {shape key: n}
        self.failed = 0

    @contextlib.contextmanager
    def span(self, name):
        """Host interval of a call into a layer. In a traced run it is a
        profiler range ``bench.<name>`` too, and it waits for the card
        at its end, so that its wall time covers the work it issued."""
        if not self.traced:
            yield
            return
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function("bench." + name):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self.spans[name].append((t0, time.perf_counter()))

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    def span_total_s(self, name):
        return sum(b - a for a, b in self.spans.get(name, ()))


class Job:
    """What every job kind shares. A kind sets ``KERNELS`` (the
    ``ops/_build`` loaders its traffic uses) and has ``warm()``,
    ``step(i, run)``, which hands its answer to :meth:`keep`, and
    ``stats(variant)``, every number it can compare for the kept answer
    against the plain reference."""

    KERNELS = ()

    def __init__(self, seed, limits=None):
        self.limits = dict(limits or {})
        self._draw = random.Random(int(seed))
        self.completed = 0
        self.kept = None

    def keep(self, answer):
        """A reservoir of one, drawn from the seed: after n completed jobs
        each of them is the one kept with chance 1/n."""
        self.completed += 1
        if self._draw.random() * self.completed < 1.0:
            self.kept = answer

    def release(self):
        """Frees the window's device memory before the reference runs."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self):
        """(name, number, limit) for each number the limits file holds."""
        if self.kept is None:
            return [("jobs_kept", 0.0, -1.0)]
        got = self.stats()
        return [(name, got[name], self.limits[name])
                for name in self.limits]


def quantile(values, q):
    """The ``q`` quantile of all values, linear between order statistics
    (numpy's default)."""
    v = sorted(values)
    if not v:
        return None
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def quartiles(values):
    """[q1, median, q3] (linear between order statistics)."""
    return [quantile(values, q) for q in (0.25, 0.5, 0.75)]


def measure(job, run, seconds, sync):
    """The closed loop: one client starts the next job when the last one
    has returned its result, until ``seconds`` have passed; the window
    ends when the last job started inside it ends. A job that raises is
    counted as failed, and the loop goes on."""
    sync()
    t0 = time.perf_counter()
    i = 0
    while True:
        s = time.perf_counter()
        if s - t0 >= seconds:
            break
        try:
            job.step(i, run)
        except Exception as exc:      # a failed job: counted, reported
            run.failed += 1
            print(f"job {i} failed: {exc!r}", file=sys.stderr)
        else:
            run.jobs.append((s, time.perf_counter()))
        i += 1
    sync()
    run.window = (t0, time.perf_counter())
