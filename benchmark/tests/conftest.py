"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

They run on the CPU at small sizes through the port's plain versions;
a test that needs the card is marked ``card`` and skips without one
(decided inside the test). Nothing here imports JAX."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import core  # noqa: E402

# the cells at sizes a CPU test holds: config and traffic changes
SMALL = {
    "dirlab-4dct": dict(shape_zyx=[16, 40, 48], spacing_xyz_mm=[8.0, 7.0,
                                                               20.0]),
    "lctsc-thorax": dict(shape_zyx=[20, 64, 64],
                         spacing_xyz_mm=[7.0, 7.0, 20.0],
                         origin_mm=[-220.5, -220.5, -190.0]),
}
SMALL_PLAN = {"dose_spacing_mm": 10.0}
SMALL_MIX = {"demons": {"solver": {"iterations": 5}},
             "planqa": {"gamma": {"dta_mm": 8.0}}}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


def full_manifest():
    """``BENCHMARK.json`` with the cells held out of it
    (``benchmark/held_out/<cell>.json``: the entries that would bring a
    cell back, PERF.md section 7), so that their job kinds stay tested."""
    out = core.load_manifest()
    for path in sorted((BENCH / "held_out").glob("*.json")):
        for key, entries in core.load_json(path).items():
            out[key] = out[key] + entries
    return out


def small_cell(workload):
    """(manifest, config, mix, limits) of ``workload`` at a CPU size."""
    manifest = full_manifest()
    cell, entry, _, _ = core.cell_spec(manifest, workload)
    cfg = core.load_config(entry)
    cfg.update(copy.deepcopy(SMALL[cfg["name"]]))
    if "plan" in cfg:
        cfg["plan"].update(SMALL_PLAN)
    mix = core.load_traffic(cell["traffic"])
    for key, sub in SMALL_MIX.get(cell["traffic"], {}).items():
        mix[key] = {**mix[key], **sub}
    limits = core.load_json(BENCH / "limits" / f"{workload}.json")
    return manifest, cfg, mix, limits


@pytest.fixture(autouse=True)
def clear_registry():
    from medicalimageanalysis_torch.data import Data

    Data.clear()
    yield
    Data.clear()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
