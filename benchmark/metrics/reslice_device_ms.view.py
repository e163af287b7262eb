"""Device ms per view update under the benchmark's span around the update
and its planes (device trace)."""

from harness import readers


def read(run):
    return readers.span_device_ms(run, 'update')
