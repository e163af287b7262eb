"""The cell ``oasis-mr.syn`` at CPU sizes: its inputs follow the seed, a
whole run's check passes, and it fails with the program broken underneath
(the SyN halves swapped where they are assembled; the CC window one voxel
wider than asked) or with the control in the program's place.

Sizes: 20 x 24 x 28 voxels of 8 mm (the OASIS field of view), a 3-level
pyramid at 4, 3 and 2 iterations, a 2 mm step so that the halves move
several mm, CC radius 2. The limits are those of
``tests/test_torch_syn_lncc.py`` at the same size, where the reference in
float32 forks from float64 exactly as the port does: at 8 mm voxels the
smoothing reaches the grid's faces, so the cell's own limits, set at 1 mm
on the card, do not apply."""

import copy

import numpy as np
import pytest

from harness import core
import run as bench_run

CELL = "oasis-mr.syn"
SMALL = dict(shape_zyx=[28, 24, 20], spacing_xyz_mm=[8.0, 8.0, 8.0],
             origin_mm=[-76.0, -92.0, -108.0])
SOLVER = dict(pyramid=[4, 2, 1], iterations=[4, 3, 2], step=2.0,
              lncc_radius=2)
LIMITS = {"field_interior_max_mm": 0.1, "field_mean_mm": 5e-3,
          "image_voxels_over_1": 10.0, "edge_flips": 200.0}


def small():
    manifest = core.load_manifest()
    _, entry, _, _ = core.cell_spec(manifest, CELL)
    cfg = core.load_config(entry)
    cfg.update(copy.deepcopy(SMALL))
    mix = core.load_traffic("syn")
    mix["solver"] = {**mix["solver"], **SOLVER}
    return manifest, cfg, mix


def run_small(seed=2 ** 31 + 5):
    manifest, cfg, mix = small()
    result, checks = bench_run.run_cell(CELL, seed, 1.0, False, "cpu",
                                        manifest=manifest, config=cfg,
                                        mix=mix, limits=LIMITS)
    assert result["attempted"] >= 1 and checks
    return result


def subjects(seed):
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.device import using_device

    _, cfg, mix = small()
    Data.clear()
    with using_device("cpu"):
        job = core.job_class(mix["job"])(cfg, mix, seed, "cpu", {})
    return job, [np.asarray(Data.image[n].array) for n in Data.image_list]


def test_same_seed_same_subjects_other_seed_other_subjects():
    _, a = subjects(2 ** 31 + 11)
    _, b = subjects(2 ** 31 + 11)
    _, c = subjects(12)
    assert len(a) == 4 and all(x.dtype == np.int16 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    # every subject its own: the template moved by its own field
    assert not any(np.array_equal(a[i], a[j])
                   for i in range(4) for j in range(i))


def test_sound_run_is_correct():
    result = run_small()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


def test_counter_read_around_each_job():
    manifest, cfg, mix = small()
    from medicalimageanalysis_torch.device import using_device

    with using_device("cpu"):
        job = core.job_class(mix["job"])(cfg, mix, 7, "cpu", {})
        run = core.Run(CELL, False)
        job.step(0, run)
        job.step(1, run)
    assert run.syn["box_sums"] == 2 * 5 * sum(SOLVER["iterations"])
    assert run.syn["assembles"] == 2 and run.syn["levels"] == 6
    run.jobs = [(0.0, 1.0), (1.0, 2.0)]
    assert core.load_metric("box_sums.oasis").read(run) == 45.0


def _halves_swapped(mp):
    from medicalimageanalysis_torch.ops.registration import demons

    real = demons._syn_assemble
    mp.setattr(demons, "_syn_assemble", lambda u1, u2, sp: real(u2, u1, sp))


def _radius_off_by_one(mp):
    from medicalimageanalysis_torch.ops.registration import demons

    real = demons._operators
    mp.setattr(demons, "_operators",
               lambda shape, std, radius, forces, device: real(
                   shape, std, radius + 1, forces, device))


@pytest.mark.parametrize("fault", [_halves_swapped, _radius_off_by_one],
                         ids=lambda f: f.__name__.strip("_"))
def test_planted_fault_fails_the_check(fault, monkeypatch):
    fault(monkeypatch)
    result = run_small()
    assert not result["correct"], result["checks"]


def test_control_fails_the_check():
    """The reference with bfloat16 contractions in the program's place
    (the CPU has no TF32) fails at least one limit."""
    from medicalimageanalysis_torch.device import using_device

    manifest, cfg, mix = small()
    with using_device("cpu"):
        job = core.job_class(mix["job"])(cfg, mix, 2 ** 31 + 5, "cpu",
                                         LIMITS)
        job.step(0, core.Run(CELL, False))
        got = job.stats("bfloat16")
    assert any(got[k] > v for k, v in LIMITS.items()), got


def test_reference_imports_nothing_of_the_port():
    import ast
    from pathlib import Path

    src = (Path(core.BENCH) / "harness" / "reference" / "syn.py").read_text()
    names = [a.name for node in ast.walk(ast.parse(src))
             if isinstance(node, ast.Import) for a in node.names]
    names += [node.module or "" for node in ast.walk(ast.parse(src))
              if isinstance(node, ast.ImportFrom)]
    assert not [n for n in names
                if n.split(".")[0] in core.FORBIDDEN
                or n.startswith("medicalimageanalysis")], names
