"""The port's hand kernels in the window, on every card: sum of their
launches' bounds over their device time, in % (device trace)."""

from harness import readers


def read(run):
    return readers.kernel_roofline(run)
