"""Import hygiene of the PyTorch port: neither the package nor
``chip_smoke.py`` may pull in jax, optax or psutil, which the GPU
machine does not have, nor any module of the JAX package
(``medicalimageanalysis_tpu``): the port carries its own copies."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from medicalimageanalysis_torch.device import set_default_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "medicalimageanalysis_torch"
FORBIDDEN = ("jax", "optax", "psutil", "medicalimageanalysis_tpu")

PROBE = r"""
import importlib, json, pkgutil, sys
import medicalimageanalysis_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
    pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke                     # its imports, without running it
print(json.dumps({"modules": names,
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in {forbidden})}))
"""


@pytest.fixture(autouse=True)
def torch_env():
    from medicalimageanalysis_torch.data import Data
    Data.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    Data.clear()
    set_default_device(None)


def test_port_and_smoke_import_no_jax_optax_psutil():
    import json

    code = PROBE.replace("{forbidden}", repr(set(FORBIDDEN)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["loaded"] == []
    # every module of the slice was imported
    for name in ("ops.warp", "ops._build", "models.rigid_intensity",
                 "structure.rigid", "read.dicom", "parallel.batch",
                 "interop", "utils.creation", "ops.filters",
                 "ops.resample", "ops.registration.dvf",
                 "ops.registration.demons", "ops.registration.bspline",
                 "utils.deformable.torch_backend",
                 "structure.deformable", "dicom.parser", "dicom.pixels",
                 "native", "ops.hist", "ops.dvh", "ops.rasterize",
                 "structure.roi", "structure.dose", "read.rtstruct",
                 "read.rtdose", "utils.convert.contour", "ops.lane_interp",
                 "structure.common", "structure.image", "config"):
        assert f"medicalimageanalysis_torch.{name}" in report["modules"]


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_import_statement(path):
    text = (ROOT / path).read_text()
    pattern = r"^\s*(import|from)\s+(" + "|".join(FORBIDDEN) + r")\b"
    assert not re.search(pattern, text, flags=re.MULTILINE), path
