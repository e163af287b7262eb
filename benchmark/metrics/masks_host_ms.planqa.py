"""Ms per plan check inside the port's mia.rois.masks span
(Image.compute_roi_masks) in which the device ran nothing: the
structure layer's host work (program span on the device trace's clock)."""

from harness import spans


def read(run):
    return spans.per_job(run, spans.idle_s(run.trace, "mia.rois.masks"), 1e3)
