"""The cell ``lctsc-thorax.planqa-cached`` at the plan-QA cell's CPU
sizes: a whole run's check passes, the window rasterizes no mask (the
structure set is masked once, in set-up), and a planted dose fault fails
the check."""

from conftest import small_cell

import run as bench_run

CELL = "lctsc-thorax.planqa-cached"


def run_small(seed=2 ** 31 + 5):
    manifest, cfg, mix, limits = small_cell(CELL)
    mix["gamma"] = {**mix["gamma"], "dta_mm": 8.0}  # as the plan-QA cell's
    result, checks = bench_run.run_cell(CELL, seed, 1.0, False, "cpu",
                                        manifest=manifest, config=cfg,
                                        mix=mix, limits=limits)
    assert result["attempted"] >= 1 and checks
    return result


def test_sound_run_is_correct_and_rasterizes_in_set_up_alone(monkeypatch):
    from medicalimageanalysis_torch.structure.image import Image

    real = Image.compute_roi_masks
    calls = []

    def counted(self, *args, **kwargs):
        calls.append(len(calls))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(Image, "compute_roi_masks", counted)
    result = run_small()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    # set-up's one call; the window's checks (one at least) made none
    assert len(calls) == 1
    assert set(result["checks"]) == {"goal_gap_pct", "dvh_gap_pct",
                                     "gamma_gap"}


def test_planted_dose_fault_fails_the_check(monkeypatch):
    from medicalimageanalysis_torch.structure import dose

    real = dose.affine_resample
    monkeypatch.setattr(dose, "affine_resample",
                        lambda *a, **k: real(*a, **k) * 1.002)
    assert not run_small()["correct"]
