"""The port's hand kernels in the window: sum of their launches' bounds
over their device time, in % (device trace)."""

from harness import readers


def read(run):
    return readers.kernel_roofline(run)
