"""95th percentile of every view update in the window, request to planes on
the host, in ms (host clock)."""

from harness import readers


def read(run):
    return readers.job_p95_ms(run)
