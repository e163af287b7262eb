"""A thoracic plan check: the masks of a fresh structure set, the DVH
goals, a DVH curve a ROI and 3-D gamma of a re-computed dose.

Set-up makes, from the seed: the CT on the card (``phantoms.thorax``, as
int16 on the host), the LCTSC organs at risk and a PTV as contours
(``phantoms.organ_contours``), the plan's dose on its coarser grid stored
as uint32 with DoseGridScaling, and a re-computed dose (the isocentre
shifted and the dose rescaled, both drawn from the seed) on the same
grid. Each job of the window hands the port a fresh structure set (new
ROI objects, so no mask is cached) and runs ``compute_roi_masks``,
``Dose.evaluate_constraints``, ``compute_dvh_curve`` for each ROI and
``compute_gamma``. One completed check, drawn from the seed, keeps its
answers; after the window the plain reference
(``reference/planqa.py``) works every one of them out again from the
same contours and doses.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import core, phantoms
from ..reference import planqa as reference

STATS = ("mask_voxels_differ", "goal_gap_pct", "dvh_gap_pct", "gamma_gap",
         "pass_rate_gap_pct")


class Job(core.Job):
    KERNELS = ("warp", "hist")  # the ops/_build loaders its traffic uses

    def __init__(self, config, mix, seed, device, limits=None):
        import medicalimageanalysis_torch as mia
        from medicalimageanalysis_torch import interop

        super().__init__(seed, limits)
        self.mia, self.interop = mia, interop
        self.device = torch.device(device)
        self.shape = tuple(config["shape_zyx"])
        self.spacing = [float(v) for v in config["spacing_xyz_mm"]]
        self.origin = [float(v) for v in config["origin_mm"]]
        self.mix = mix
        self.goals = config["goals"]
        plan = config["plan"]
        self.rx = float(plan["prescription_gy"])
        gen = phantoms.generator(seed, self.device)
        a = phantoms.anatomy(self.shape, self.spacing, gen)
        ct = phantoms.thorax(self.shape, self.spacing, gen, a)
        self.ct_name = "CT thorax"
        interop.image_from_arrays(ct.to(torch.int16).cpu().numpy(),
                                  self.spacing, self.origin, np.eye(3),
                                  "CT", self.ct_name)
        del ct
        self.ptv = phantoms.ptv_of(a, gen)
        self.contours = phantoms.organ_contours(
            self.shape, self.spacing, self.origin, a, self.ptv)
        sp = float(plan["dose_spacing_mm"])
        self.dose_shape, self.dose_origin = phantoms.dose_grid(
            self.shape, self.spacing, self.origin, a, sp)
        self.dose_spacing = [sp, sp, sp]
        centre = [self.origin[i] + (n - 1) / 2 * self.spacing[i]
                  for i, n in enumerate(self.shape[::-1])]
        first = phantoms.uniform(gen, 0.0, 2 * math.pi)
        angles = [first + 2 * math.pi * b / plan["beams"]
                  for b in range(plan["beams"])]
        shift = [phantoms.uniform(gen, -1.0, 1.0) for _ in range(3)]
        scale = 1.0 + phantoms.uniform(gen, *plan["recompute_scale"])
        self.doses = {}
        for name, kw in (("plan", {}), ("recomputed",
                                        dict(shift=shift, scale=scale))):
            gy = phantoms.plan_dose(
                self.dose_shape, self.dose_origin, sp, centre, a, self.ptv,
                angles, plan["prescription_gy"], device=self.device, **kw)
            # stored as uint32 with DoseGridScaling, read back as Gy
            stored = torch.round(gy / plan["dose_grid_scaling"]).cpu() \
                .numpy().astype(np.uint32)
            arr = (stored.astype(np.float64)
                   * plan["dose_grid_scaling"]).astype(np.float32)
            self.doses[name] = arr
            interop.dose_from_numpy(arr, self.dose_spacing,
                                    self.dose_origin, np.eye(3),
                                    name=f"RTDOSE {name}")

    def _check(self, run):
        from medicalimageanalysis_torch.data import Data

        image = Data.image[self.ct_name]
        dose = Data.dose["RTDOSE plan"]
        g = self.mix["gamma"]
        with run.span("structures"):
            image.rois = {}
            self.interop.rois_from_numpy(image, self.contours)
        with run.span("masks"):
            masks = image.compute_roi_masks()
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
        return dict(masks=masks, goals=[(r["roi"], r["goal"], r["value"])
                                        for r in goals],
                    curves=curves, gamma=gam["gamma"],
                    pass_rate=gam["pass_rate"])

    def warm(self):
        self._check(core.Run("warm", False))

    def step(self, i, run):
        out = self._check(run)
        self.keep(out)

    def answers(self, dtype=torch.float64):
        """The reference's answers to the same check; ``dtype`` the dose
        arithmetic's (bfloat16 for the control)."""
        dev = self.device
        masks = reference.masks(self.contours, self.shape, self.spacing,
                                self.origin, dev)
        plan = torch.as_tensor(self.doses["plan"], device=dev)
        on_ct = reference.dose_on_grid(
            plan, self.dose_origin, self.dose_spacing, self.shape,
            self.spacing, self.origin, dtype)
        voxel_cc = float(np.prod(self.spacing)) / 1000.0
        doses = {name: on_ct[torch.as_tensor(masks[name], device=dev) > 0]
                 .to(torch.float64).cpu().numpy() for name in self.contours}
        goals = [(name, goal) + reference.goal_value(goal, doses[name],
                                                     voxel_cc)
                 + (doses[name].size * voxel_cc,)
                 for name, goal_list in self.goals.items()
                 for goal in goal_list]
        curves = {name: reference.dvh_curve(d, self.mix["dvh_bins"])
                  for name, d in doses.items()}
        g = self.mix["gamma"]
        gam, rate, analysed = reference.gamma(
            plan, torch.as_tensor(self.doses["recomputed"], device=dev),
            self.dose_spacing, g["dose_pct"], g["dta_mm"],
            g["threshold_pct"], g["cap"], dtype)
        return dict(masks=masks, goals=goals, curves=curves, gamma=gam,
                    pass_rate=rate, analysed=analysed)

    def gaps(self, got, ref):
        rx = self.rx
        goal_gap = 0.0
        for (roi, goal, value), (r_roi, r_goal, r_value, unit, vol) in zip(
                got["goals"], ref["goals"]):
            assert (roi, goal) == (r_roi, r_goal)
            scale = {"Gy": rx / 100.0, "%": 1.0, "cc": vol / 100.0}[unit]
            goal_gap = max(goal_gap, abs(value - r_value) / scale)
        dvh_gap = max(float(np.abs(np.asarray(got["curves"][n][1],
                                              np.float64)
                                   - ref["curves"][n][1]).max())
                      for n in self.contours)
        a = ref["analysed"]
        return dict(
            mask_voxels_differ=float(sum(
                int((got["masks"][n] != ref["masks"][n]).sum())
                for n in self.contours)),
            goal_gap_pct=goal_gap, dvh_gap_pct=dvh_gap,
            gamma_gap=float(np.abs(got["gamma"][a].astype(np.float64)
                                   - ref["gamma"][a]).max()),
            pass_rate_gap_pct=abs(got["pass_rate"] - ref["pass_rate"]))

    def stats(self, variant="program"):
        """The numbers of :data:`STATS` for the kept check against the
        float64 reference; ``variant`` 'control' puts the reference's
        bfloat16 answers in the program's place."""
        if getattr(self, "_ref", None) is None:
            self._ref = self.answers()
        got = self.kept
        if variant == "control":
            c = self.answers(torch.bfloat16)
            got = dict(c, goals=[g[:3] for g in c["goals"]])
        return self.gaps(got, self._ref)
