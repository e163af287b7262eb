"""Seconds per study in the port's mia.ingest.build span (program span)."""

from harness import readers


def read(run):
    return readers.port_span_s(run, 'mia.ingest.build')
