"""BENCHMARK.json and every file it names parse and keep to the
benchmark's contract: names, units, keys, and one file a configuration,
traffic mix and metric."""

import json
import re

import pytest
from conftest import BENCH

from harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
MANIFEST = core.load_manifest()


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == TOP
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert all(one_line(w) for w in MANIFEST["command"])
    assert MANIFEST["command"][1] == "benchmark/run.py"


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=lambda e: e["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and one_line(entry["source"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    cfg = core.load_config(entry)
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["deployment"]["chips"] == 1
    assert one_line(cfg["source"])
    assert cfg["assumed"]
    assert any(w["config"] == entry["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda c: c["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(cell[key])
    assert cell["chips"] == 1 and one_line(cell["why"])
    mix = core.load_traffic(cell["traffic"])
    assert (BENCH / "harness" / "jobs" / f"{mix['job']}.py").exists()
    limits = core.load_json(BENCH / "limits" / f"{cell['name']}.json")
    job = core.job_class(mix["job"])
    assert set(limits) <= set(__import__(job.__module__,
                                         fromlist=["STATS"]).STATS)
    _, _, e2e, layer = core.cell_spec(MANIFEST, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer


def test_cells_unique():
    pairs = [(c["config"], c["traffic"]) for c in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [c["name"] for c in MANIFEST["workloads"]]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"]
                         + MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_metric(metric):
    e2e = metric in MANIFEST["end_to_end"]
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if e2e else {"layer", "moves"})
    assert keys <= set(metric) <= keys | {"workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in MANIFEST["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert one_line(metric["layer"])
        moves = {m["name"]: m for m in MANIFEST["end_to_end"]}
        assert metric["moves"] in moves
        for cell in metric["workloads"]:
            assert cell in moves[metric["moves"]].get("workloads", [cell])
    assert hasattr(core.load_metric(metric["name"]), "read")


def test_metric_names_unique():
    names = [m["name"] for m in MANIFEST["end_to_end"]
             + MANIFEST["per_layer"]]
    assert len(set(names)) == len(names)
    bound = {m["name"]: m["bound"] for m in MANIFEST["end_to_end"]}
    assert bound["setup_s"] <= 0.25
