"""Each cell's inputs are the same for the same seed and differ for
another."""

import numpy as np
import pytest
from conftest import full_manifest, small_cell

from harness import core

CELLS = [c["name"] for c in full_manifest()["workloads"]]


def inputs(workload, seed):
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.device import using_device

    _, cfg, mix, _ = small_cell(workload)
    Data.clear()
    with using_device("cpu"):
        job = core.job_class(mix["job"])(cfg, mix, seed, "cpu", {})
    arrays = [np.asarray(Data.image[n].array) for n in Data.image_list]
    arrays += [np.asarray(Data.dose[n].array) for n in Data.dose_list]
    for name in ("contours",):
        for polys in getattr(job, name, {}).values():
            arrays += [np.asarray(p) for p in polys]
    if hasattr(job, "stored"):
        arrays.append(job.stored)
    if hasattr(job, "sequence"):
        arrays += [np.asarray(v) for _, v in job.sequence[:16]]
    if hasattr(job, "release"):
        job.release()
    return arrays


@pytest.mark.parametrize("workload", CELLS)
def test_same_seed_same_inputs_other_seed_other_inputs(workload):
    a = inputs(workload, 2 ** 31 + 11)
    b = inputs(workload, 2 ** 31 + 11)
    c = inputs(workload, 12)
    assert len(a) == len(b) and a
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert len(a) != len(c) or any(
        x.shape != y.shape or not np.array_equal(x, y)
        for x, y in zip(a, c))
