"""A cohort's deformable registrations on a mesh's data axis:
``parallel.batch.demons_batch(fixed, moving, mesh=make_mesh(n))``, one
inhale / exhale pair a card.

Set-up makes ``pairs`` pairs on the first device from the seed
(``phantoms.breathing_pair``), holds them on the host as int16 (B, Z, Y,
X) stacks, as read series are held, builds the mesh over the
deployment's ``chips`` devices and runs one job. Each job registers every
pair in one ``demons_batch`` call and gets the host fields back. One
completed job, drawn from the seed (a reservoir of one), keeps its
fields; after the window each pair's field is compared with the plain
reference's single level (``reference/demons.Plain.fast_demons`` with the
pyramid (1,)), computed on the device that pair's row ran on, and the
worst pair decides each number.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import core, phantoms
from ..reference import demons as reference
from .demons import STATS as DEMONS_STATS
from .demons import gaps

# demons_batch returns fields and no image: the field numbers of gaps()
STATS = tuple(s for s in DEMONS_STATS if s.startswith("field_"))
_NO_IMAGE = np.zeros((3, 3, 3), np.float32)


def field_gaps(field, ref_field):
    """:data:`STATS` of one field against its reference, as
    :func:`jobs.demons.gaps` computes them."""
    got = gaps(field, _NO_IMAGE, ref_field, _NO_IMAGE, 0.0)
    return {k: got[k] for k in STATS}


class Job(core.Job):
    KERNELS = ("warp",)  # the ops/_build loaders its traffic uses

    def __init__(self, config, mix, seed, device, limits=None):
        from medicalimageanalysis_torch.parallel.mesh import make_mesh

        super().__init__(seed, limits)
        self.device = torch.device(device)
        self.shape = tuple(config["shape_zyx"])
        self.spacing = [float(v) for v in config["spacing_xyz_mm"]]
        self.solver = mix["solver"]
        n = int(config["deployment"]["chips"])
        self.mesh = make_mesh(n) if self.device.type == "cuda" \
            else make_mesh(n, devices=[self.device] * n)
        B = int(mix["pairs"])
        per_row = B // n
        # the device each pair's row runs on: its reference runs there
        self.devices = [self.mesh.devices[k // per_row, 0] for k in range(B)]
        gen = phantoms.generator(seed, self.device)
        fixed, moving = [], []
        for _ in range(B):
            inhale, exhale, _ = phantoms.breathing_pair(
                self.shape, self.spacing, gen, config["breathing_peak_mm"])
            fixed.append(inhale.to(torch.int16).cpu().numpy())
            moving.append(exhale.to(torch.int16).cpu().numpy())
            del inhale, exhale
        self.fixed, self.moving = np.stack(fixed), np.stack(moving)
        self._refs = None

    def _register(self, run):
        from medicalimageanalysis_torch.parallel import batch

        s = self.solver
        with run.span("demons_batch"):
            return batch.demons_batch(
                self.fixed, self.moving, self.spacing, method=s["method"],
                iterations=s["iterations"], std=s["std"], step=s["step"],
                intensity_threshold=s["intensity_threshold"],
                smooth=s["smooth"], mesh=self.mesh, forces=s["forces"])

    def warm(self):
        self._register(core.Run("warm", False))

    def step(self, i, run):
        self.keep(self._register(run))

    def _each_pair(self, fn):
        """[fn(k) for every pair k], one thread a pair, so that the cards
        (and numpy, which lets go of the interpreter in its large loops)
        work at once."""
        with ThreadPoolExecutor(len(self.fixed)) as pool:
            return list(pool.map(fn, range(len(self.fixed))))

    def reference(self, k, dtype=torch.float64):
        """Pair ``k``'s sampling field (Z, Y, X, 3) mm from the plain
        reference's single level, on the device its row ran on."""
        s = self.solver
        p = reference.Plain(dtype, self.devices[k])
        with torch.no_grad():
            return p.fast_demons(
                p.t(self.fixed[k]), p.t(self.moving[k]), p.t(self.spacing),
                (1,), s["iterations"], s["step"], s["std"],
                s["intensity_threshold"]).cpu().numpy()

    def stats(self, variant="program"):
        """:data:`STATS` of the kept job against the float64 reference,
        each the largest over the pairs. ``variant`` 'control' puts the
        reference computed in TF32 (the precision below the
        configuration's float32 with TF32 off) in the program's place,
        'float32' the reference in full float32. The TF32 switch is the
        process's: it is set once, around the threads."""
        if self._refs is None:
            self._refs = self._each_pair(self.reference)

        def gap(k):
            field = self.kept[k] if variant == "program" else \
                self.reference(k, torch.float32)
            return field_gaps(field, self._refs[k])

        with reference.matmul_tf32(variant == "control"):
            rows = self._each_pair(gap)
        # np.max: a NaN in any pair stays NaN
        return {name: float(np.max([r[name] for r in rows]))
                for name in STATS}
