"""Reading a thoracic study: one ``read_dicoms`` of a folder holding the
CT series, its RTSTRUCT and its RTDOSE, into a registry cleared first.

Set-up makes the plan-QA deployment's inputs from the seed (the CT, the
organs' contours, the plan's dose stored as uint32 with DoseGridScaling)
and writes them once as a study folder under a ``mkdtemp`` of
``TMPDIR`` with the benchmark's own writer (``harness/dicomfile.py``),
in the layout of ``chip_smoke.write_rt``. Each job of the window reads
the folder. One read, drawn from the seed, keeps what it gave; after the
window it is compared with what was written: the CT voxels exactly, the
geometry and the contours' vertices as their decimal strings read in
float64, the dose as stored times DoseGridScaling. The folder is removed
at the end of the run.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile

import numpy as np
import torch

from .. import core, dicomfile, phantoms

STATS = ("ct_voxels_differ", "geometry_gap", "contours_missing",
         "contour_gap_mm", "dose_gap_gy")


def as_written(v):
    """A number as its decimal string reads back in float64."""
    return float(dicomfile.ds(v))


class Job(core.Job):
    # the first reads of a process after one warm read still take up to
    # 1.6 times the median read (PERF.md section 5): set-up reads three
    WARM_READS = 3

    def __init__(self, config, mix, seed, device, limits=None):
        import medicalimageanalysis_torch as mia

        super().__init__(seed, limits)
        self.mia = mia
        self.device = torch.device(device)
        self.shape = tuple(config["shape_zyx"])
        self.spacing = [as_written(v) for v in config["spacing_xyz_mm"]]
        self.origin = [as_written(v) for v in config["origin_mm"]]
        plan = config["plan"]
        gen = phantoms.generator(seed, self.device)
        a = phantoms.anatomy(self.shape, self.spacing, gen)
        self.ct = phantoms.thorax(self.shape, self.spacing, gen, a) \
            .to(torch.int16).cpu().numpy()
        ptv = phantoms.ptv_of(a, gen)
        contours = phantoms.organ_contours(self.shape, self.spacing,
                                           self.origin, a, ptv)
        # as written: ContourData at three decimals
        self.contours = {n: [np.round(c, 3) for c in cs]
                         for n, cs in contours.items()}
        sp = as_written(plan["dose_spacing_mm"])
        dose_shape, dose_origin = phantoms.dose_grid(
            self.shape, self.spacing, self.origin, a, sp)
        self.dose_origin = [as_written(v) for v in dose_origin]
        self.dose_spacing = sp
        centre = [self.origin[i] + (n - 1) / 2 * self.spacing[i]
                  for i, n in enumerate(self.shape[::-1])]
        first = phantoms.uniform(gen, 0.0, 2 * math.pi)
        angles = [first + 2 * math.pi * b / plan["beams"]
                  for b in range(plan["beams"])]
        gy = phantoms.plan_dose(dose_shape, self.dose_origin, sp, centre, a,
                                ptv, angles, plan["prescription_gy"],
                                device=self.device)
        self.scaling = as_written(plan["dose_grid_scaling"])
        self.stored = torch.round(gy / self.scaling).cpu().numpy() \
            .astype(np.uint32)
        del gy
        self.folder = tempfile.mkdtemp(prefix="bench-ingest-")
        self._write(seed)
        # on disk before the window, so that no writeback runs inside it
        for root, _, names in os.walk(self.folder):
            for name in names:
                fd = os.open(os.path.join(root, name), os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)

    # -- the study folder ------------------------------------------------
    def _write(self, seed):
        """The study as the benchmark's own writer writes it
        (``harness/dicomfile.py``), nothing of the program's."""
        f = dicomfile
        series, study, frame = (f.uid(seed, n) for n in (1, 2, 3))
        patient = {0x00100010: ("PN", "Bench^Thorax"),
                   0x00100020: ("LO", "BENCH"),
                   0x00100040: ("CS", "M"),
                   0x0020000D: ("UI", study)}
        sx, sy, sz = self.spacing
        ox, oy, oz = self.origin
        os.makedirs(os.path.join(self.folder, "ct"))
        sops = []
        for k, plane in enumerate(self.ct):
            sops.append(f.uid(seed, 1, k + 1))
            f.write(os.path.join(self.folder, "ct", f"{k}.dcm"), {
                **patient,
                0x00080016: ("UI", f.CT_IMAGE),
                0x00080018: ("UI", sops[-1]),
                0x00080020: ("DA", "20240101"),
                0x00080030: ("TM", "100000"),
                0x00080060: ("CS", "CT"),
                0x0008103E: ("LO", "bench thorax"),
                0x00180050: ("DS", sz),
                0x0020000E: ("UI", series),
                0x00200010: ("SH", "1"),
                0x00200011: ("IS", 2),
                0x00200012: ("IS", 1),
                0x00200013: ("IS", k + 1),
                0x00200032: ("DS", [ox, oy, oz + k * sz]),
                0x00200037: ("DS", [1, 0, 0, 0, 1, 0]),
                0x00200052: ("UI", frame),
                0x00280002: ("US", 1),
                0x00280004: ("CS", "MONOCHROME2"),
                0x00280010: ("US", plane.shape[0]),
                0x00280011: ("US", plane.shape[1]),
                0x00280030: ("DS", [sy, sx]),
                0x00280100: ("US", 16),
                0x00280101: ("US", 16),
                0x00280102: ("US", 15),
                0x00280103: ("US", 1),
                0x00281052: ("DS", 0),
                0x00281053: ("DS", 1),
                0x7FE00010: ("OW", f.pixels(plane, "<i2")),
            })

        def rt(modality, sop_class, n):
            return {**patient,
                    0x00080016: ("UI", sop_class),
                    0x00080018: ("UI", f.uid(seed, n)),
                    0x00080060: ("CS", modality),
                    0x0020000E: ("UI", f.uid(seed, n + 1))}

        rois, contours = [], []
        for number, (name, polys) in enumerate(self.contours.items(),
                                               start=1):
            rois.append({0x30060022: ("IS", number),
                         0x30060024: ("UI", frame),
                         0x30060026: ("LO", name)})
            items = []
            for xyz in polys:
                k = int(round((xyz[0, 2] - oz) / sz))
                items.append({
                    0x30060016: ("SQ", [{0x00081150: ("UI", f.CT_IMAGE),
                                         0x00081155: ("UI", sops[k])}]),
                    0x30060042: ("CS", "CLOSED_PLANAR"),
                    0x30060046: ("IS", len(xyz)),
                    0x30060050: ("DS", xyz.reshape(-1).tolist()),
                })
            contours.append({0x3006002A: ("IS", [255, 40 * number % 256, 0]),
                             0x30060040: ("SQ", items),
                             0x30060084: ("IS", number)})
        f.write(os.path.join(self.folder, "rs.dcm"), {
            **rt("RTSTRUCT", f.RT_STRUCT, 4),
            0x30060002: ("SH", "bench"),
            0x30060010: ("SQ", [{
                0x30060024: ("UI", frame),
                0x30060012: ("SQ", [{
                    0x30060014: ("SQ", [{0x0020000E: ("UI", series)}])}]),
            }]),
            0x30060020: ("SQ", rois),
            0x30060039: ("SQ", contours),
        })

        sp = self.dose_spacing
        nz, ny, nx = self.stored.shape
        f.write(os.path.join(self.folder, "rd.dcm"), {
            **rt("RTDOSE", f.RT_DOSE, 6),
            0x00180050: ("DS", sp),
            0x00200032: ("DS", list(self.dose_origin)),
            0x00200037: ("DS", [1, 0, 0, 0, 1, 0]),
            0x00200052: ("UI", frame),
            0x00280002: ("US", 1),
            0x00280004: ("CS", "MONOCHROME2"),
            0x00280008: ("IS", nz),
            0x00280009: ("AT", 0x3004000C),
            0x00280010: ("US", ny),
            0x00280011: ("US", nx),
            0x00280030: ("DS", [sp, sp]),
            0x00280100: ("US", 32),
            0x00280101: ("US", 32),
            0x00280102: ("US", 31),
            0x00280103: ("US", 0),
            0x30040002: ("CS", "GY"),
            0x30040004: ("CS", "PHYSICAL"),
            0x3004000A: ("CS", "PLAN"),
            0x3004000C: ("DS", [sp * i for i in range(nz)]),
            0x3004000E: ("DS", self.scaling),
            0x7FE00010: ("OW", f.pixels(self.stored, "<u4")),
        })

    # -- the window ------------------------------------------------------
    def _read(self, run):
        from medicalimageanalysis_torch.data import Data

        Data.clear()
        with run.span("read_dicoms"):
            self.mia.read_dicoms(folder_path=self.folder,
                                 device=self.device)
        image = Data.image[Data.image_list[0]]
        dose = Data.dose[Data.dose_list[0]]
        return dict(ct=image.array, spacing=np.asarray(image.spacing),
                    origin=np.asarray(image.origin),
                    matrix=np.asarray(image.matrix),
                    contours={n: list(r.contour_position or [])
                              for n, r in image.rois.items()},
                    dose=np.asarray(dose.array),
                    dose_spacing=np.asarray(dose.spacing),
                    dose_origin=np.asarray(dose.origin))

    def warm(self):
        for _ in range(self.WARM_READS):
            self._read(core.Run("warm", False))

    def step(self, i, run):
        self.keep(self._read(run))

    def release(self):
        shutil.rmtree(self.folder, ignore_errors=True)
        super().release()

    # -- the comparison --------------------------------------------------
    def answers(self, control=False):
        """What the study holds. The control reads every decimal string
        in float32 and works the dose out in bfloat16, one precision step
        below the configuration's float64 geometry and float32 dose."""
        dtype = torch.bfloat16 if control else torch.float64

        def parse(values):
            a = np.asarray(values, np.float64)
            return a.astype(np.float32).astype(np.float64) if control else a

        stored = torch.as_tensor(self.stored.astype(np.float64))
        dose = (stored.to(dtype) * torch.tensor(self.scaling, dtype=dtype)) \
            .to(torch.float64).numpy()
        return dict(ct=self.ct, spacing=parse(self.spacing),
                    origin=parse(self.origin), matrix=np.eye(3),
                    contours={n: [parse(c) for c in cs]
                              for n, cs in self.contours.items()},
                    dose=dose,
                    dose_spacing=parse(np.full(3, self.dose_spacing)),
                    dose_origin=parse(self.dose_origin))

    @staticmethod
    def gaps(got, ref):
        geometry = max(float(np.abs(np.asarray(got[k], np.float64)
                                    - ref[k]).max())
                       for k in ("spacing", "origin", "matrix",
                                 "dose_spacing", "dose_origin"))
        missing, gap = 0, 0.0
        for name, polys in ref["contours"].items():
            mine = got["contours"].get(name, [])
            if len(mine) != len(polys):
                missing += abs(len(polys) - len(mine))
            for a, b in zip(mine, polys):
                a = np.asarray(a, np.float64)
                if a.shape != b.shape:
                    missing += 1
                    continue
                gap = max(gap, float(np.abs(a - b).max()))
        same_ct = got["ct"].shape == ref["ct"].shape
        return dict(
            ct_voxels_differ=float(np.count_nonzero(
                got["ct"].astype(np.int32) != ref["ct"].astype(np.int32)))
            if same_ct else float(ref["ct"].size),
            geometry_gap=geometry, contours_missing=float(missing),
            contour_gap_mm=gap,
            dose_gap_gy=float(np.abs(got["dose"].astype(np.float64)
                                     - ref["dose"]).max())
            if got["dose"].shape == ref["dose"].shape else math.inf)

    def stats(self, variant="program"):
        got = self.answers(control=True) if variant == "control" \
            else self.kept
        return self.gaps(got, self.answers())
