"""Seconds per study read: the window over the studies it completed (host
clock)."""

from harness import readers


def read(run):
    return readers.seconds_per_job(run)
