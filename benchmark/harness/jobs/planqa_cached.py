"""A thoracic plan check on a structure set already masked: the DVH
goals, a DVH curve a ROI and 3-D gamma of a re-computed dose, the
rasterizer bypassed.

The inputs are the plan-QA job's (``jobs/planqa.py``), from the same
seed. Set-up hands the port the structure set once and computes its
masks once (``compute_roi_masks``, into the port's mask cache); each
check of the window then runs ``Dose.evaluate_constraints``,
``compute_dvh_curve`` for each ROI and ``compute_gamma``, as a physicist
does who checks a re-computed or re-planned dose on contours that have
not changed. The kept check is compared with the plan-QA job's plain
reference, and its masks are the set-up's.
"""

from __future__ import annotations

from .. import core
from . import planqa
from .planqa import STATS  # noqa: F401  (the numbers a limit may name)


class Job(planqa.Job):
    def _structures(self):
        from medicalimageanalysis_torch.data import Data

        image = Data.image[self.ct_name]
        image.rois = {}
        self.interop.rois_from_numpy(image, self.contours)
        self.masks = image.compute_roi_masks()

    def _check(self, run):
        from medicalimageanalysis_torch.data import Data

        dose = Data.dose["RTDOSE plan"]
        g = self.mix["gamma"]
        with run.span("goals"):
            goals = dose.evaluate_constraints(self.goals,
                                              image_name=self.ct_name)
        with run.span("dvh"):
            curves = {n: dose.compute_dvh_curve(
                self.ct_name, n, n_bins=self.mix["dvh_bins"])
                for n in self.contours}
        with run.span("gamma"):
            gam = dose.compute_gamma("RTDOSE recomputed",
                                     dose_pct=g["dose_pct"],
                                     dta_mm=g["dta_mm"],
                                     threshold_pct=g["threshold_pct"],
                                     cap=g["cap"])
        return dict(masks=self.masks,
                    goals=[(r["roi"], r["goal"], r["value"])
                           for r in goals],
                    curves=curves, gamma=gam["gamma"],
                    pass_rate=gam["pass_rate"])

    def warm(self):
        self._structures()
        self._check(core.Run("warm", False))
