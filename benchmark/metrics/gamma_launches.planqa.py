"""Device activities per plan check launched under the port's
mia.gamma.scan span: gamma's offset scan, its inputs and its map's copy
to the host (device trace)."""

from harness import spans


def read(run):
    return spans.per_job(run, spans.launches(run.trace, "mia.gamma.scan"))
