"""Share of the traced window in which no operation ran on the device, in %
(device trace)."""

from harness import readers


def read(run):
    return readers.device_idle(run)
