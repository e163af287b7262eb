"""Checking a registration by hand: nudges of a ``Rigid`` overlay of a
4D-CT pair, each followed by the three orthogonal planes on the host.

Set-up makes one inhale / exhale pair from the seed (as the deformable
cell does), registers a ``Rigid`` of the exhale onto the inhale at the
identity, reslices the overlay, and runs one cycle of nudges. Request j
of the run is, by j mod 4: ``update_translation`` by a_g, then
``update_rotation`` by b_g, then by -a_g and -b_g (g = j // 4), so the
pose stays near the start and every seed does the same work: a_g a
direction drawn from the seed and 0.5-2 mm, b_g an axis and 0.5-2
degrees. After each nudge ``retrieve_array_plane`` gives the three
planes. One request, drawn from the seed, keeps its planes; after the
window the plain reference (``reference/review.py``) follows every nudge
up to it and samples the same planes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import core, phantoms
from ..reference import review as reference

STATS = ("plane_gap_hu", "plane_p999_hu", "plane_mean_hu",
         "plane_voxels_over_1hu", "planes_misplaced")


def nudges(seed, n):
    """The request sequence: [(kind, vector)] of length n."""
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    out = []
    for g in range((n + 3) // 4):
        a = rng.normal(size=3)
        a *= rng.uniform(0.5, 2.0) / np.linalg.norm(a)
        b = rng.normal(size=3)
        b *= rng.uniform(0.5, 2.0) / np.linalg.norm(b)
        out += [("translate", a), ("rotate", b), ("translate", -a),
                ("rotate", -b)]
    return out[:n]


class Job(core.Job):
    KERNELS = ("warp",)  # the ops/_build loaders its traffic uses

    WARM = 4  # one cycle of nudges in set-up

    def __init__(self, config, mix, seed, device, limits=None):
        import medicalimageanalysis_torch as mia
        from medicalimageanalysis_torch import interop
        from medicalimageanalysis_torch.config import config as mia_config

        super().__init__(seed, limits)
        self.device = torch.device(device)
        self.shape = tuple(config["shape_zyx"])
        self.spacing = [float(v) for v in config["spacing_xyz_mm"]]
        self.origin = [float(v) for v in config["origin_mm"]]
        self.background = float(mia_config.background_fill)
        gen = phantoms.generator(seed, self.device)
        inhale, exhale, _ = phantoms.breathing_pair(
            self.shape, self.spacing, gen, config["breathing_peak_mm"])
        names = []
        for phase, vol in (("T00", inhale), ("T50", exhale)):
            name = f"{phase} review"
            interop.image_from_arrays(vol.to(torch.int16).cpu().numpy(),
                                      self.spacing, self.origin, np.eye(3),
                                      "CT", name)
            names.append(name)
        del inhale, exhale
        self.names = names
        self.rigid = mia.Rigid(names[0], names[1], device=self.device)
        self.sequence = nudges(seed, int(mix["max_requests"]))
        self.applied = 0

    def _request(self, run):
        kind, v = self.sequence[self.applied]
        with run.span("update"):
            if kind == "translate":
                self.rigid.update_translation(*(float(x) for x in v))
            else:
                self.rigid.update_rotation(
                    r_x=float(v[0]), r_y=float(v[1]), r_z=float(v[2]))
            planes = {p: self.rigid.retrieve_array_plane(p)
                      for p in reference.PLANES}
        self.applied += 1
        return planes

    def warm(self):
        run = core.Run("warm", False)
        for p in reference.PLANES:            # the first reslice
            self.rigid.retrieve_array_plane(p)
        for _ in range(self.WARM):
            self._request(run)

    def step(self, i, run):
        planes = self._request(run)
        self.keep((self.applied, planes))

    def answers(self, upto, dtype=torch.float64):
        from medicalimageanalysis_torch.data import Data

        ref, mov = (Data.image[n] for n in self.names)
        state = reference.ViewState(ref.array.shape, self.spacing,
                                    self.origin, mov.array.shape,
                                    self.spacing, self.origin)
        state.reslice()
        for kind, v in self.sequence[:upto]:
            if kind == "translate":
                state.translate(v)
            else:
                state.rotate(v)
        return state.planes(mov.array, self.background, dtype, self.device)

    @staticmethod
    def gaps(got, ref):
        diffs, misplaced = [], 0
        for p in reference.PLANES:
            a, b = got[p], ref[p]
            if (a is None) != (b is None) or (
                    a is not None and a.shape != b.shape):
                misplaced += 1
            elif a is not None:
                diffs.append(np.abs(a.astype(np.float64) - b).ravel())
        d = np.concatenate(diffs) if diffs else np.zeros(1)
        return dict(plane_gap_hu=float(d.max()),
                    plane_p999_hu=float(np.quantile(d, 0.999)),
                    plane_mean_hu=float(d.mean()),
                    plane_voxels_over_1hu=float((d > 1.0).sum()),
                    planes_misplaced=float(misplaced))

    def stats(self, variant="program"):
        """:data:`STATS` of the kept request against the float64
        reference; 'control' puts the reference in bfloat16 there."""
        upto, got = self.kept
        ref = self.answers(upto)
        if variant == "control":
            got = self.answers(upto, torch.bfloat16)
        return self.gaps(got, ref)
