"""Whole runs at CPU sizes, the chip check skipped: each cell comes out
correct as it stands, and not correct with its timed path broken
underneath (a step that returns its state unchanged, an answer altered
where it is produced) or with the control, the reference one precision
step down, in the program's place."""

import numpy as np
import pytest
import torch
from conftest import small_cell

import run as bench_run


def run_small(workload, seconds=1.0, seed=2 ** 31 + 5):
    manifest, cfg, mix, limits = small_cell(workload)
    result, checks = bench_run.run_cell(workload, seed, seconds, False,
                                        "cpu", manifest=manifest,
                                        config=cfg, mix=mix, limits=limits)
    assert result["attempted"] >= 1 and checks
    return result


@pytest.mark.parametrize("workload", ["dirlab-4dct.demons",
                                      "lctsc-thorax.planqa",
                                      "dirlab-4dct.review",
                                      "lctsc-thorax.ingest"])
def test_sound_run_is_correct(workload):
    result = run_small(workload)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


def _demons_state_unchanged(mp):
    from medicalimageanalysis_torch.ops.registration import demons

    def stuck(fixed, moving, sp, *args, u0=None, **kwargs):
        u = torch.zeros((3,) + tuple(fixed.shape)) if u0 is None else u0
        return torch.movedim(u, 0, -1) * sp

    mp.setattr(demons, "_demons_core", stuck)


def _demons_image_altered(mp):
    from medicalimageanalysis_torch.structure import deformable

    real = deformable.warp_disp
    mp.setattr(deformable, "warp_disp",
               lambda vol, disp, bg=0.0: real(vol, disp, bg) + 5.0)


def _planqa_mask_altered(mp):
    from medicalimageanalysis_torch.ops import rasterize

    real = rasterize.rasterize_polygons_grouped

    def flipped(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0, out.shape[1] // 2, 10, 10] ^= 1
        return out

    mp.setattr(rasterize, "rasterize_polygons_grouped", flipped)


def _planqa_gamma_altered(mp):
    from medicalimageanalysis_torch.ops import gamma

    real = gamma.gamma_index

    def off(*args, **kwargs):
        out = real(*args, **kwargs)
        out["gamma"] = out["gamma"] * np.float32(1.01)
        return out

    mp.setattr(gamma, "gamma_index", off)


def _planqa_dose_altered(mp):
    from medicalimageanalysis_torch.structure import dose

    real = dose.affine_resample
    mp.setattr(dose, "affine_resample",
               lambda *a, **k: real(*a, **k) * 1.002)


def _review_rotation_unchanged(mp):
    from medicalimageanalysis_torch.structure import rigid

    def still(self, center=None, r_x=0, r_y=0, r_z=0):
        self.display.compute_reslice()

    mp.setattr(rigid.Rigid, "update_rotation", still)


def _review_plane_altered(mp):
    from medicalimageanalysis_torch.structure import rigid

    real = rigid.Display.compute_array_slice

    def off(self, slice_plane):
        out = real(self, slice_plane)
        return None if out is None else out + 50.0

    mp.setattr(rigid.Display, "compute_array_slice", off)


def _ingest_voxel_altered(mp):
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch import reader
    from medicalimageanalysis_torch.data import Data

    real = reader.read_dicoms

    def off(*args, **kwargs):
        out = real(*args, **kwargs)
        Data.image[Data.image_list[0]].array[1, 2, 3] += 1
        return out

    mp.setattr(reader, "read_dicoms", off)
    mp.setattr(mia, "read_dicoms", off, raising=False)


def _ingest_dose_altered(mp):
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch import reader
    from medicalimageanalysis_torch.data import Data

    real = reader.read_dicoms

    def off(*args, **kwargs):
        out = real(*args, **kwargs)
        d = Data.dose[Data.dose_list[0]]
        d.array = np.asarray(d.array) * np.float32(1.001)
        return out

    mp.setattr(reader, "read_dicoms", off)
    mp.setattr(mia, "read_dicoms", off, raising=False)


def _ingest_contour_altered(mp):
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch import reader
    from medicalimageanalysis_torch.data import Data

    real = reader.read_dicoms

    def off(*args, **kwargs):
        out = real(*args, **kwargs)
        roi = next(iter(Data.image[Data.image_list[0]].rois.values()))
        first = np.array(roi.contour_position[0], dtype=np.float64)
        first[0, 0] += 0.001
        roi.contour_position = [first] + list(roi.contour_position[1:])
        return out

    mp.setattr(reader, "read_dicoms", off)
    mp.setattr(mia, "read_dicoms", off, raising=False)


FAULTS = [("dirlab-4dct.demons", _demons_state_unchanged),
          ("dirlab-4dct.demons", _demons_image_altered),
          ("lctsc-thorax.planqa", _planqa_mask_altered),
          ("lctsc-thorax.planqa", _planqa_gamma_altered),
          ("lctsc-thorax.planqa", _planqa_dose_altered),
          ("dirlab-4dct.review", _review_rotation_unchanged),
          ("dirlab-4dct.review", _review_plane_altered),
          ("lctsc-thorax.ingest", _ingest_voxel_altered),
          ("lctsc-thorax.ingest", _ingest_dose_altered),
          ("lctsc-thorax.ingest", _ingest_contour_altered)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f.__name__.strip("_") for _, f in FAULTS])
def test_broken_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = run_small(workload)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", ["lctsc-thorax.planqa",
                                      "dirlab-4dct.review",
                                      "lctsc-thorax.ingest"])
def test_control_fails_a_limit(workload):
    """The bfloat16 control in the program's place fails at least one of
    the cell's limits (the demons cell's TF32 control needs the card)."""
    import control

    manifest, cfg, mix, limits = small_cell(workload)
    (row,) = control.readings(workload, [7], 0.5, ["control"], "cpu",
                              cfg, mix, manifest)
    assert any(row[k] > v for k, v in limits.items()), row


def test_ingest_control_fails_geometry_and_contours():
    """Decimal strings read in float32 fail both limits that the dose's
    bfloat16 does not reach."""
    import control

    manifest, cfg, mix, limits = small_cell("lctsc-thorax.ingest")
    (row,) = control.readings("lctsc-thorax.ingest", [2 ** 31 + 3], 0.5,
                              ["control"], "cpu", cfg, mix, manifest)
    assert row["contour_gap_mm"] > limits["contour_gap_mm"], row
    assert row["geometry_gap"] > limits["geometry_gap"], row


@pytest.mark.card
def test_demons_control_fails_a_limit(card):
    """At the cell's own size: TF32 shows only in the smoothing GEMMs."""
    import control
    from conftest import BENCH

    from harness import core

    limits = core.load_json(BENCH / "limits" / "dirlab-4dct.demons.json")
    (row,) = control.readings("dirlab-4dct.demons", [7], 1.0, ["control"],
                              card)
    assert any(row[k] > v for k, v in limits.items()), row
