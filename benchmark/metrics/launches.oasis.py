"""Device activities per registration launched under the port's
mia.demons span: every kernel, copy and fill of compute_demons, the
coarse levels' dispatch among them (device trace)."""

from harness import spans


def read(run):
    return spans.per_job(run, spans.launches(run.trace, "mia.demons"))
