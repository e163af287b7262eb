"""The cohort cell, ``cohort-4gpu.demons_batch``, at CPU sizes: its
manifest entries, a whole run over a mesh of four CPU entries, a planted
fault (two rows' fields swapped), and its four per-layer readers on a
made-up trace of four cards."""

import copy

import numpy as np
import pytest
from conftest import BENCH

import run as bench_run
from harness import core
from harness.tracing import Trace

CELL = "cohort-4gpu.demons_batch"
MANIFEST = core.load_manifest()
SMALL = dict(shape_zyx=[16, 40, 48], spacing_xyz_mm=[8.0, 7.0, 20.0])
READERS = ("cards_busy.cohort", "batch_device_ms.cohort", "copy_ms.cohort",
           "kernel_roofline.cohort")


def small_cohort():
    """(config, mix, limits) of the cell at a CPU size: four pairs of 16 x
    40 x 48, five iterations."""
    cell, entry, _, _ = core.cell_spec(MANIFEST, CELL)
    cfg = core.load_config(entry)
    cfg.update(copy.deepcopy(SMALL))
    mix = core.load_traffic(cell["traffic"])
    mix["solver"] = {**mix["solver"], "iterations": 5}
    limits = core.load_json(BENCH / "limits" / f"{CELL}.json")
    return cfg, mix, limits


def run_small(seconds=1.0, seed=2 ** 31 + 7):
    cfg, mix, limits = small_cohort()
    result, checks = bench_run.run_cell(CELL, seed, seconds, False, "cpu",
                                        manifest=MANIFEST, config=cfg,
                                        mix=mix, limits=limits)
    assert result["attempted"] >= 1 and checks
    return result


def test_manifest_entries():
    """One configuration on four cards, its one cell, the limits it
    compares, and the four readers; the one list extended is dir_s's."""
    cell, entry, e2e, layer = core.cell_spec(MANIFEST, CELL)
    assert entry["name"] == "cohort-4gpu" and entry["reduced"] == []
    assert entry["file"] == "benchmark/configs/cohort-4gpu.json"
    cfg = core.load_config(entry)
    assert cfg["reduced"] == [] and cfg["assumed"]
    assert cfg["deployment"]["chips"] == cell["chips"] == 4
    assert len(cfg["source"]) <= 200 and len(entry["source"]) <= 200
    other = [c for c in MANIFEST["configs"] if c["name"] != entry["name"]]
    assert entry["source"] not in {c["source"] for c in other}
    assert len(cell["why"]) <= 200
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert four == [cell]
    assert {m["name"] for m in e2e} == {"dir_s", "setup_s"}
    (dir_s,) = [m for m in MANIFEST["end_to_end"] if m["name"] == "dir_s"]
    assert dir_s["workloads"] == ["dirlab-4dct.demons", CELL]
    assert {m["name"] for m in layer} == set(READERS)
    for m in layer:
        assert m["workloads"] == [CELL] and m["moves"] == "dir_s"
    mix = core.load_traffic(cell["traffic"])
    assert mix["job"] == "demons_batch" and mix["pairs"] == 4
    job = __import__(core.job_class(mix["job"]).__module__,
                     fromlist=["STATS"])
    limits = core.load_json(BENCH / "limits" / f"{CELL}.json")
    assert set(limits) == {"field_p999_mm", "field_mean_mm",
                           "field_voxels_over_50um"} <= set(job.STATS)


def test_same_seed_same_inputs_other_seed_other_inputs():
    cfg, mix, _ = small_cohort()

    def job(seed):
        return core.job_class(mix["job"])(cfg, mix, seed, "cpu", {})

    a, b, c = job(2 ** 31 + 11), job(2 ** 31 + 11), job(12)
    assert a.fixed.dtype == a.moving.dtype == np.int16
    assert a.fixed.shape == (4, 16, 40, 48)
    assert np.array_equal(a.fixed, b.fixed)
    assert np.array_equal(a.moving, b.moving)
    assert not np.array_equal(a.fixed, c.fixed)
    # four patients, not one four times
    assert not np.array_equal(a.fixed[0], a.fixed[1])


def test_sound_run_is_correct():
    from medicalimageanalysis_torch.parallel import batch

    before = dict(batch.LOCKSTEP)
    result = run_small()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["device"]["count"] == 4
    jobs = result["attempted"] + 1                    # and the warm job
    assert batch.LOCKSTEP["rows"] - before["rows"] == 4 * jobs
    assert batch.LOCKSTEP["rounds"] - before["rounds"] == 5 * jobs


def test_swapped_rows_are_not_correct(monkeypatch):
    from medicalimageanalysis_torch.parallel import batch

    real = batch.demons_batch

    def swapped(*args, **kwargs):
        out = real(*args, **kwargs)
        return out[[1, 0, 2, 3]]

    monkeypatch.setattr(batch, "demons_batch", swapped)
    result = run_small()
    assert not result["correct"], result["checks"]


def four_card_trace():
    """A 10 ms window (ns) over four cards: two jobs, each a
    mia.batch.demons range inside the benchmark's bench.demons_batch, a
    copy up and a disp kernel on each card, and a copy down on two."""
    disp = ("void (anonymous namespace)::warp_kernel<((anonymous "
            "namespace)::Mode)2, false, 4, 2>(float const*")
    device, ranges = [], []
    for j, t0 in enumerate((0, 5_000_000)):
        ranges += [(t0, t0 + 4_000_000, "bench.demons_batch"),
                   (t0 + 10, t0 + 3_900_000, "mia.batch.demons")]
        for card in range(4):
            at = t0 + 100 + card
            device += [(at + 50, at + 150, "Memcpy HtoD (Pageable -> Device)",
                        at),
                       (at + 1_000, at + 2_001_000, disp, at + 10)]
        for card in range(2):
            at = t0 + 3_000_000 + card
            device.append((at + 10, at + 200_010,
                           "Memcpy DtoH (Device -> Pageable)", at))
    return Trace(device, ranges, (0, 10_000_000))


def traced_run(trace):
    run = core.Run(CELL, True)
    run.jobs = [(0.0, 0.004), (0.005, 0.009)]
    run.window = (0.0, 0.01)
    run.trace = trace
    run.launch_shapes = {"warp": {("warp_disp", 4, False, (128, 512, 512),
                                   (128, 512, 512)): 8}}
    return run


def test_readers_on_a_four_card_trace():
    run = traced_run(four_card_trace())
    got = {name: core.load_metric(name).read(run) for name in READERS}
    # 2 jobs x (4 x (100 + 2,000,000) + 2 x 200,000) ns over 4 x 10 ms
    busy = 2 * (4 * 2_000_100 + 2 * 200_000)
    assert got["cards_busy.cohort"] == pytest.approx(
        100.0 * busy / (4 * 10_000_000))
    # all of it launched inside bench.demons_batch, per job, in ms
    assert got["batch_device_ms.cohort"] == pytest.approx(busy / 2 * 1e-6)
    # copies under the benchmark's span: 4 x 100 + 2 x 200,000 ns a job
    assert got["copy_ms.cohort"] == pytest.approx(
        (4 * 100 + 2 * 200_000) * 1e-6)
    # 8 disp launches' bound over their 8 x 2 ms
    bound = 8 * 44 * 128 * 512 * 512 / 3.35e12
    assert got["kernel_roofline.cohort"] == pytest.approx(
        100.0 * bound / (8 * 2e-3))


def test_readers_without_the_ports_span():
    """A program without mia.batch.demons (the row-by-row demons_batch
    before the lockstep) reads every metric all the same: each reads the
    benchmark's own span or the whole window; untraced, none reads."""
    trace = four_card_trace()
    want = {name: core.load_metric(name).read(traced_run(trace))
            for name in READERS}
    trace.ranges = [r for r in trace.ranges if r[2] != "mia.batch.demons"]
    run = traced_run(trace)
    got = {name: core.load_metric(name).read(run) for name in READERS}
    assert got == pytest.approx(want)
    untraced = traced_run(None)
    assert all(core.load_metric(n).read(untraced) is None for n in READERS)


@pytest.mark.card
def test_cohort_control_fails_a_limit(card):
    """At the cell's own size, on four cards: TF32 in the reference's
    smoothing GEMMs fails a limit."""
    import torch

    import control

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    limits = core.load_json(BENCH / "limits" / f"{CELL}.json")
    (row,) = control.readings(CELL, [7], 1.0, ["control"], card,
                              manifest=MANIFEST)
    assert any(row[k] > v for k, v in limits.items()), row
    assert np.isfinite([row[k] for k in limits]).all()
