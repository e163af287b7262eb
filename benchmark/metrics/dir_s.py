"""Seconds per deformable registration: the window over the registrations
it completed (host clock)."""

from harness import readers


def read(run):
    return readers.seconds_per_job(run)
