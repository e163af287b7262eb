"""Inter-subject registration of T1 brain MR: greedy SyN with ANTs-CC
forces (``Deformable.compute_demons(method="syn", forces="lncc")``) on
ANTs' schedule, then ``create_image``, subject k + 1 onto subject k.

Set-up makes ``pairs`` + 1 subjects on the card from the seed
(``brain.subject``: one seeded template, each subject warped from it by
its own field, with its own bias and noise), registers them as port
images (int16 on the host, as a read series is held) and runs one job.
Each job of the window registers the next pair in turn, copies the
deformed image to the host and reads the field. One completed job,
drawn from the seed (a reservoir of one), keeps its field and image;
after the window the plain reference (``reference/syn.py``) registers
the same pair and the two are compared with the demons job's numbers.

The port's SyN counter (``ops/registration/demons.SYN``) is read around
each job of the window, and its change is left on the run as ``run.syn``
(None where the port has no such counter), for ``box_sums.oasis``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import brain, core, phantoms
from ..reference import syn as reference
from .demons import gaps as demons_gaps

# the demons job's numbers, in the image's own units
RENAME = {"image_gap_hu": "image_gap",
          "image_interior_max_hu": "image_interior_max",
          "image_p999_hu": "image_p999", "image_mean_hu": "image_mean",
          "image_voxels_over_1hu": "image_voxels_over_1"}
STATS = tuple(RENAME.get(k, k) for k in (
    "field_gap_mm", "field_interior_max_mm", "field_p999_mm",
    "field_mean_mm", "field_voxels_over_50um", "image_gap_hu",
    "image_interior_max_hu", "image_p999_hu", "image_mean_hu",
    "image_voxels_over_1hu", "edge_flips"))


def gaps(field, warped, ref_field, ref_warped, background):
    """:func:`jobs.demons.gaps`, the image's numbers named without HU."""
    return {RENAME.get(k, k): v for k, v in demons_gaps(
        field, warped, ref_field, ref_warped, background).items()}


def syn_counts():
    """The port's SyN counter as it stands, or None without one."""
    from medicalimageanalysis_torch.ops.registration import demons

    syn = getattr(demons, "SYN", None)
    return None if syn is None else dict(syn)


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
        s = config["subjects"]
        gen = phantoms.generator(seed, self.device)
        t = brain.template(gen)
        names = []
        for k in range(int(mix["pairs"]) + 1):
            vol, _ = brain.subject(self.shape, self.spacing, t, gen,
                                   s["deformation_peak_mm"], s["bias"],
                                   s["noise"])
            names.append(f"T1 subject {k}")
            interop.image_from_arrays(
                vol.to(torch.int16).cpu().numpy(), self.spacing,
                config["origin_mm"], np.eye(3), "MR", names[-1])
            del vol
        # as Learn2Reg's validation pairs: subject k + 1 onto subject k
        self.pairs = list(zip(names[:-1], names[1:]))

    def _register(self, k, run):
        from medicalimageanalysis_torch.data import Data

        ref, mov = self.pairs[k % len(self.pairs)]
        s = self.solver
        d = self.mia.Deformable(reference_name=ref, moving_name=mov,
                                device=self.device)
        try:
            with run.span("demons"):
                d.compute_demons(method=s["method"], forces=s["forces"],
                                 lncc_radius=s["lncc_radius"],
                                 pyramid=tuple(s["pyramid"]),
                                 iterations=tuple(s["iterations"]),
                                 std=s["std"], smooth=s["smooth"],
                                 step=s["step"])
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
        before = syn_counts()
        field, out = self._register(i, run)
        if before is not None:
            got = getattr(run, "syn", None) or dict.fromkeys(before, 0)
            run.syn = {k: got[k] + n - before[k]
                       for k, n in syn_counts().items()}
        self.keep((i % len(self.pairs), field, out))

    def reference(self, k, **kw):
        from medicalimageanalysis_torch.data import Data

        ref, mov = self.pairs[k]
        return reference.register_and_warp(
            Data.image[ref].array, Data.image[mov].array, self.spacing,
            self.solver, self.background, device=self.device, **kw)

    def stats(self, variant="program"):
        """All of :data:`STATS` for the kept job against the float64
        reference. ``variant`` 'control' puts the reference computed in
        TF32 (the precision below the configuration's float32 with TF32
        off) in the program's place, 'float32' the reference in full
        float32, 'bfloat16' the reference with bfloat16 contractions (the
        control on a CPU, which has no TF32), 'edge_fault' the float32
        reference with strict faces."""
        k, field, out = self.kept
        if getattr(self, "_ref", (None,))[0] != k:
            self._ref = (k,) + self.reference(k)
        if variant != "program":
            kw = {"control": dict(tf32=True),
                  "float32": {},
                  "bfloat16": dict(contract=torch.bfloat16),
                  "edge_fault": dict(strict_faces=True)}[variant]
            field, out = self.reference(k, dtype=torch.float32, **kw)
        return gaps(np.asarray(field), out, *self._ref[1:], self.background)
