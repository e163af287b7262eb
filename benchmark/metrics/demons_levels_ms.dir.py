"""Device ms per registration launched under the port's mia.demons.level
spans: the solver's pyramid levels, without the volumes' copies in and
the field's out (device trace)."""

from harness import spans


def read(run):
    if run.trace is None:
        return None
    return spans.per_job(run, run.trace.span_device_s("mia.demons.level")[0],
                         1e3)
