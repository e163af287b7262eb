"""Device ms per registration under the benchmark's span around
compute_demons (device trace)."""

from harness import readers


def read(run):
    return readers.span_device_ms(run, 'demons')
