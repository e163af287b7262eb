"""Deformable registration of 4D-CT phases: ``Deformable.compute_demons``
then ``create_image``, the exhale phase onto the inhale phase.

Set-up makes ``pairs`` inhale / exhale pairs on the card from the seed
(``phantoms.breathing_pair``), registers them as port images (int16 on
the host, as a read series is held) and runs one job. Each job of the
window registers the next pair in turn and copies the deformed image to
the host. One completed job, drawn from the seed (a reservoir of one),
keeps its field and image; after the window the plain reference
(``reference/demons.py``) registers the same pair and the two are
compared.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import core, phantoms
from ..reference import demons as reference

STATS = ("field_gap_mm", "field_interior_max_mm", "field_p999_mm",
         "field_mean_mm", "field_voxels_over_50um", "image_gap_hu",
         "image_interior_max_hu", "image_p999_hu", "image_mean_hu",
         "image_voxels_over_1hu", "edge_flips")


def gaps(field, warped, ref_field, ref_warped, background):
    """The numbers a comparison can take, program against reference. The
    interior leaves out the grid's outer faces, where a sample that lies
    within rounding of the last slice, row or column falls inside on one
    side and to the background on the other; ``edge_flips`` counts the
    voxels where exactly one side reads the background. The counts of
    voxels over 50 um and 1 HU are the interior's."""
    df = np.abs(field.astype(np.float64) - ref_field).max(-1)
    di = np.abs(warped.astype(np.float64) - ref_warped)
    inner = (slice(1, -1),) * 3
    flips = (warped == np.float32(background)) != (ref_warped == background)
    return dict(field_gap_mm=float(df.max()),
                field_interior_max_mm=float(df[inner].max()),
                field_p999_mm=float(np.quantile(df, 0.999)),
                field_mean_mm=float(df.mean()),
                field_voxels_over_50um=float(np.count_nonzero(
                    df[inner] > 0.05)),
                image_gap_hu=float(di.max()),
                image_interior_max_hu=float(di[inner].max()),
                image_p999_hu=float(np.quantile(di, 0.999)),
                image_mean_hu=float(di.mean()),
                image_voxels_over_1hu=float(np.count_nonzero(di[inner] > 1.0)),
                edge_flips=float(np.count_nonzero(flips)))


class Job(core.Job):
    KERNELS = ("warp",)  # the ops/_build loaders its traffic uses

    def __init__(self, config, mix, seed, device, limits=None):
        import medicalimageanalysis_torch as mia
        from medicalimageanalysis_torch import interop
        from medicalimageanalysis_torch.config import config as mia_config

        super().__init__(seed, limits)
        self.mia = mia
        self.device = torch.device(device)
        self.shape = tuple(config["shape_zyx"])
        self.spacing = [float(v) for v in config["spacing_xyz_mm"]]
        self.solver = mix["solver"]
        self.background = float(mia_config.background_fill)
        gen = phantoms.generator(seed, self.device)
        self.pairs = []
        for k in range(int(mix["pairs"])):
            inhale, exhale, _ = phantoms.breathing_pair(
                self.shape, self.spacing, gen, config["breathing_peak_mm"])
            names = []
            for phase, vol in (("T00", inhale), ("T50", exhale)):
                name = f"{phase} pair {k}"
                interop.image_from_arrays(
                    vol.to(torch.int16).cpu().numpy(), self.spacing,
                    config["origin_mm"], np.eye(3), "CT", name)
                names.append(name)
            self.pairs.append(tuple(names))
            del inhale, exhale

    def _register(self, k, run):
        from medicalimageanalysis_torch.data import Data

        ref, mov = self.pairs[k % len(self.pairs)]
        d = self.mia.Deformable(reference_name=ref, moving_name=mov,
                                device=self.device)
        try:
            with run.span("demons"):
                d.compute_demons(method="fast",
                                 pyramid=tuple(self.solver["pyramid"]),
                                 iterations=self.solver["iterations"],
                                 step=self.solver["step"],
                                 std=self.solver["std"],
                                 intensity_threshold=self.solver[
                                     "intensity_threshold"])
            with run.span("create_image"):
                out = d.create_image()["array"]
        finally:
            Data.deformable.pop(d.deformable_name, None)
            if d.deformable_name in Data.deformable_list:
                Data.deformable_list.remove(d.deformable_name)
        return d.dvf, out

    def warm(self):
        self._register(0, core.Run("warm", False))

    def step(self, i, run):
        field, out = self._register(i, run)
        self.keep((i % len(self.pairs), field, out))

    def reference(self, k, dtype=torch.float64, tf32=False,
                  strict_faces=False):
        from medicalimageanalysis_torch.data import Data

        ref, mov = self.pairs[k]
        return reference.register_and_warp(
            Data.image[ref].array, Data.image[mov].array, self.spacing,
            self.solver, self.background, dtype=dtype, tf32=tf32,
            device=self.device, strict_faces=strict_faces)

    def stats(self, variant="program"):
        """All of :data:`STATS` for the kept job against the float64
        reference. ``variant`` 'control' puts the reference computed in
        TF32 (the precision below the configuration's float32 with TF32
        off) in the program's place, 'float32' the reference in full
        float32, 'edge_fault' the float32 reference with strict faces."""
        k, field, out = self.kept
        if getattr(self, "_ref", (None,))[0] != k:
            self._ref = (k,) + self.reference(k)
        if variant != "program":
            field, out = self.reference(
                k, torch.float32, tf32=variant == "control",
                strict_faces=variant == "edge_fault")
        return gaps(np.asarray(field), out, *self._ref[1:], self.background)
