"""Seconds per study in the port's mia.ingest.read and mia.ingest.group
spans (program span)."""

from harness import readers


def read(run):
    return readers.port_span_s(run, 'mia.ingest.read', 'mia.ingest.group')
