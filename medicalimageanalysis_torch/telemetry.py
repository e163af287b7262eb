"""Tracing / logging / ingest reporting.

Carried over from medicalimageanalysis_tpu/telemetry.py: a structured
logger, profiler annotations around the pipeline stages (here
``torch.profiler.record_function``, so the spans show in a
``torch.profiler`` trace beside the CUDA kernels) and the IngestReport.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field

import torch

logger = logging.getLogger("medicalimageanalysis_torch")
logger.addHandler(logging.NullHandler())

__all__ = ["logger", "trace", "IngestReport"]


@contextlib.contextmanager
def trace(name):
    """Wall-clock + profiler annotation around a region."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        try:
            yield
        finally:
            logger.debug("%s took %.4fs", name, time.perf_counter() - t0)


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
