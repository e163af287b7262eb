"""Device ms per registration launched under the port's mia.syn.assemble
span: the fixed half inverted at full size and the moving half composed
with it (device trace). A port without the span reads nothing."""

from harness import spans


def read(run):
    if run.trace is None:
        return None
    total, n = run.trace.span_device_s("mia.syn.assemble")
    return spans.per_job(run, total, 1e3) if n else None
