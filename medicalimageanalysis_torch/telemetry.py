"""Tracing / logging / ingest reporting.

Carried over from medicalimageanalysis_tpu/telemetry.py: a structured
logger, spans around the pipeline stages and the IngestReport.

The spans' contract:

- A span is a ``torch.profiler.record_function`` range and nothing
  else. A ``torch.profiler`` trace holds it on the clock it gives the
  device's activities, with the launches made inside it, so a reader of
  the trace can put device time, copies and the device's idle gaps
  under the span that issued them.
- It is free when nothing records: :func:`trace` asks the profiler
  whether it is on at every entry (one call well under a microsecond)
  and, when it is off, enters no range at all.
- There is no second clock: no host timer runs beside the range, and
  no span waits for the device.

Names follow ``mia.<layer>.<stage>``; ``PERF.md`` lists every span, its
site and the benchmark metric that reads it.
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass, field

import torch

logger = logging.getLogger("medicalimageanalysis_torch")
logger.addHandler(logging.NullHandler())

__all__ = ["logger", "trace", "IngestReport"]


@contextlib.contextmanager
def trace(name):
    """A profiler range ``name`` around a region while a profiler
    records; otherwise nothing."""
    if not torch._C._autograd._profiler_enabled():
        yield
        return
    with torch.profiler.record_function(name):
        yield


@dataclass
class IngestReport:
    """Tolerant-ingest outcome summary."""

    files_total: int = 0
    parsed_ok: int = 0
    failed_files: list = field(default_factory=list)
    failed_series: list = field(default_factory=list)
    images_created: list = field(default_factory=list)
    doses_created: list = field(default_factory=list)
    plans_created: list = field(default_factory=list)
    rigid_created: list = field(default_factory=list)
    deformable_created: list = field(default_factory=list)
    unmatched_rtstructs: list = field(default_factory=list)
    unmatched_segs: list = field(default_factory=list)
    unverified: dict = field(default_factory=dict)
    skipped_slices: dict = field(default_factory=dict)
    warnings: list = field(default_factory=list)
    elapsed_s: float = 0.0

    def warn(self, message):
        self.warnings.append(message)
        logger.warning(message)

    def summary(self):
        return {
            "files_total": self.files_total,
            "parsed_ok": self.parsed_ok,
            "failed": len(self.failed_files),
            "failed_series": len(self.failed_series),
            "images": list(self.images_created),
            "doses": list(self.doses_created),
            "plans": list(self.plans_created),
            "rigid": list(self.rigid_created),
            "deformable": list(self.deformable_created),
            "unmatched_rtstructs": len(self.unmatched_rtstructs),
            "unmatched_segs": len(self.unmatched_segs),
            "unverified": dict(self.unverified),
            "warnings": len(self.warnings),
            "elapsed_s": round(self.elapsed_s, 4),
        }
