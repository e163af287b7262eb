"""Wall ms of compute_gamma per plan check, from the benchmark's own span
around it (host clock; the span waits for the card)."""

from harness import readers


def read(run):
    return readers.span_wall_ms(run, 'gamma')
