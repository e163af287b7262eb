"""The port's four examples against their JAX twins, on the CPU.

Each JAX example (examples/*.py) runs through ``runpy`` and its port
(``medicalimageanalysis_torch.examples.*``) with ``device="cpu"``, each
in a folder of its own under the test's tmp dir, their stdout captured.
The two print the same labelled lines, in the same order; the numbers of
each line agree within the tolerance stated for its label below, taken
from the parity test that covers the function (ROADMAP.md queue 3,
"Differences that are not faults") plus one unit of the last printed
digit. The port's own asserts (the twins') hold inside ``main``.

Synthetic series written within one second tie on their timestamps, and
the reader then orders them by their random series UIDs, in both
packages. So both packages' series writers get the same increasing UIDs
here, and the cohort's series come out in the order they were written.
Every JAX twin takes under 60 s on the CPU (8-30 s), so each example is
held against its twin's output, not only against its asserts.
"""

import importlib
import itertools
import os
import re
import runpy
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device

ROOT = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"-?\d+(?:\.\d*)?(?:e[-+]?\d+)?")

# label -> (atol, rtol) of its numbers; "text": the line is equal as
# text; "skip": the line is present, its text not compared (a path, or
# image names that depend on series order)
TOLERANCES = {
    "end_to_end": {
        "ingest": "ingest",                  # equal but for elapsed_s
        "volume": "text",
        # the table path's mesh and the mask are bit-equal
        # (test_torch_marching_cubes.py, test_torch_roi_mesh.py)
        "external": "text",
        # counts bit-equal, NGTDM sums 1e-6 relative
        # (test_torch_radiomics.py)
        "radiomics": (1e-3, 1e-5),
        # rigid poses within 1e-4 (test_torch_rigid.py)
        "rigid translation (mm)": (0.01 + 1e-4, 0),
        "overlay grid": "text",
        # demons fields within 1e-6 mm after 8 iterations; the gate can
        # fork later, so the field's largest value within 0.05 mm
        "DVF": (0.05, 0),
        "persisted": "text",
    },
    "registration_suite": {
        "images": "skip",
        "rigid CT<->CT": (0.01 + 1e-4, 0),
        "rigid CT<->MR (MI)": (0.01 + 1e-4, 0),
        "oblique 45-deg reslice": "text",
        # elastix fields within 0.05 mm (test_torch_elastix.py)
        "elastix DVF": (0.05, 0),
        # demons: residuals agree to 2 % (test_torch_demons.py)
        "demons pyramid": (0.1, 0.02),
        # LNCC fields within 5e-3 mm after 8 iterations; the median
        "LNCC demons CT<->MR": (0.01 + 5e-3, 0),
        # TPS fields within 1e-4 mm (test_torch_tps.py)
        "TPS": (1e-3 + 1e-4, 0),
        # the affine descent's loss: 3 significant digits, 1e-4 relative
        "affine intensity": (0, 0.01),
        # ICP within 2e-3 mm at its float32 floors (test_torch_icp.py)
        "ICP matrix t": (0.01 + 2e-3, 0),
        "OK": "text",
    },
    "adaptive_rt": {
        "wrote SEG": "skip",
        "SEG ingested from disk, ROIs": "text",
        "fraction dose": "text",
        "demons field": "text",
        # doses and DVH statistics within 1e-4 Gy (test_torch_dose.py)
        "accumulated dose": (0.01 + 1e-4, 0),
        "GTV DVH": (0.01 + 1e-4, 0),
        "DVH curve points": (0.1, 0),
        "jacobian QA": (1e-3 + 1e-4, 0),
        # the surface panel to 1e-5 relative (test_torch_metrics.py)
        "GTV vs mapped fraction GTV": (1e-3, 1e-5),
        # gamma within 1e-5 (test_torch_gamma.py)
        "gamma 3%/3mm": (0.1, 0),
        "GTV": (0.01 + 1e-4, 0),             # the EQD2 Dmean line
        "TCP(logistic, EQD2)": (0.1, 0),
        "exported": "text",
        "dicom": "text",
        "re-ingest of export dir": "text",
        "OK": "text",
    },
    "cohort_scale": {
        "mesh": "text",
        "ingested": "text",
        # the rigid batch within 1e-4 of the single pair
        # (test_torch_rigid_batch.py)
        "recovered x-shifts": (0.01 + 1e-4, 0),
        # demons_batch: the fields' largest value (as "DVF" above)
        "demons": (0.05, 0),
        "z-sharded": (0.05, 0),
        # compare_masks_batch / dvh_batch to 1e-5 relative
        "seg QA dice": (1e-3, 1e-5),
        "cohort DVH Dmean Gy": (0.01, 1e-5),
        "cohort rasterized ROI voxels": "text",
        "mesh->voxel round-trip overlap": "text",
        "cohort": "text",
    },
}


@pytest.fixture(autouse=True)
def torch_env(monkeypatch):
    import medicalimageanalysis_torch.utils.creation as tcreation
    import medicalimageanalysis_tpu.utils.creation as jcreation

    TData.clear()
    torch.set_num_threads(1)
    # the same increasing series, study and frame UIDs in both packages'
    # writers (see the module docstring)
    for module in (jcreation, tcreation):
        counter = itertools.count(1)
        monkeypatch.setattr(module, "generate_uid", lambda c=counter: (
            f"1.2.826.0.1.3680043.10.1017.{next(c):06d}"))
    # the JAX cohort example adds to XLA_FLAGS; keep the process's
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    yield
    TData.clear()
    set_default_device(None)


def label_of(line):
    head = line.split(":")[0] if ":" in line else line.split()[0]
    return head.strip()


def words(line):
    return " ".join(NUMBER.sub("#", line).split())


def lines_by_label(text):
    out = {}
    for line in text.splitlines():
        if line.strip():
            out.setdefault(label_of(line), []).append(line)
    return out


def compare(name, jax_out, port_out):
    rules = TOLERANCES[name]
    got, want = lines_by_label(port_out), lines_by_label(jax_out)
    assert list(got) == list(want), (list(got), list(want))
    assert set(want) == set(rules), set(want) ^ set(rules)
    for label, rule in rules.items():
        assert len(got[label]) == len(want[label]), label
        for g, w in zip(got[label], want[label]):
            if rule == "skip":
                continue
            if rule == "text":
                assert g == w, (g, w)
            elif rule == "ingest":
                drop = re.compile(r"'elapsed_s': [0-9.e-]+")
                assert drop.sub("", g) == drop.sub("", w), (g, w)
            else:
                atol, rtol = rule
                # the words around the numbers are the same (numpy
                # pads its arrays to the widest number)
                assert words(g) == words(w), (g, w)
                np.testing.assert_allclose(
                    [float(x) for x in NUMBER.findall(g)],
                    [float(x) for x in NUMBER.findall(w)], rtol=rtol,
                    atol=atol, err_msg=f"{name}: {label}: {g} | {w}")


def run_both(name, tmp_path, monkeypatch, capsys):
    jdir = tmp_path / "jax"
    jdir.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(jdir))
    runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                   run_name="__main__")
    jax_out = capsys.readouterr().out
    module = importlib.import_module(
        f"medicalimageanalysis_torch.examples.{name}")
    figures = module.main(device="cpu", workdir=str(tmp_path / "port"))
    port_out = capsys.readouterr().out
    compare(name, jax_out, port_out)
    return figures


def test_end_to_end(tmp_path, monkeypatch, capsys):
    figures = run_both("end_to_end", tmp_path, monkeypatch, capsys)
    assert figures["volume_shape"] == (24, 64, 64)
    assert figures["external"]["mask_voxels"] > 0
    assert os.path.isfile(tmp_path / "port" / "rs_out.dcm")


def test_registration_suite(tmp_path, monkeypatch, capsys):
    figures = run_both("registration_suite", tmp_path, monkeypatch, capsys)
    # the twin's asserts, also held here on the returned figures
    assert np.allclose(figures["rigid_mse_t"], [-2, 3, 0], atol=0.7)
    assert np.allclose(figures["rigid_mi_t"], [-2, 3, 0], atol=1.0)
    assert np.allclose(figures["lncc_median_mm"], [2, -3, 0], atol=1.0)


def test_adaptive_rt(tmp_path, monkeypatch, capsys):
    figures = run_both("adaptive_rt", tmp_path, monkeypatch, capsys)
    assert figures["exported"] == ["dvf_reg.dcm", "rd_accumulated.dcm",
                                   "rs.dcm", "seg.dcm"]
    assert figures["reingested_doses"] == ["RTDOSE 01"]


def test_cohort_scale(tmp_path, monkeypatch, capsys):
    figures = run_both("cohort_scale", tmp_path, monkeypatch, capsys)
    assert figures["relative_shifts"] == [0, 1, 2, 3]
    assert figures["overlap"] == [1.0] * 4


def test_main_without_a_card_raises(monkeypatch, tmp_path):
    from medicalimageanalysis_torch.examples import end_to_end

    set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        end_to_end.main(workdir=str(tmp_path))
