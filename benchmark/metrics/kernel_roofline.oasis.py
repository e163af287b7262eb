"""The port's hand kernels in the window, here the warp kernel's disp
launches at the SyN shapes: sum of their launches' bounds over their
device time, in % (device trace)."""

from harness import readers


def read(run):
    return readers.kernel_roofline(run)
