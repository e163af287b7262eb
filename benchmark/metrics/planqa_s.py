"""Seconds per plan check: the window over the checks it completed (host
clock)."""

from harness import readers


def read(run):
    return readers.seconds_per_job(run)
