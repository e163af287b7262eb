"""Wall ms of the goals and the DVH curves per plan check, from the
benchmark's own spans around them (host clock; the spans wait for the
card)."""

from harness import readers


def read(run):
    return readers.span_wall_ms(run, 'goals', 'dvh')
