"""Device ms per step of the cohort launched under the benchmark's own
bench.demons_batch span around its demons_batch call: every card's
uploads, solver set-up, iterations and fields' copies (device trace)."""

from harness import readers


def read(run):
    return readers.span_device_ms(run, "demons_batch")
