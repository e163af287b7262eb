"""DVH reductions (ops/dvh.dvh_statistics, parallel/batch.dvh_batch)
against the JAX package on the CPU.

Tolerances: the voxel counts (volume and every VS bin), Dmin and Dmax are
bit-equal (integers and selected values); Dmean, Dstd, Dmedian and the
D percentiles to rtol 1e-6 (float32 sums taken in another order, and
XLA on the CPU contracts the percentile interpolation into an FMA)."""

import numpy as np
import pytest
import torch

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import dvh as tdvh
from medicalimageanalysis_torch.parallel import batch as tbatch
from medicalimageanalysis_torch.parallel.mesh import make_mesh
from medicalimageanalysis_tpu.ops import dvh as jdvh
from medicalimageanalysis_tpu.parallel import batch as jbatch

EXACT = ("Volume (cc)", "Dmin", "Dmax")


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def assert_dvh_equal(port, ref):
    assert port.keys() == ref.keys()
    for key, value in ref.items():
        if key == "ROI":
            assert port[key] == value
        elif key in EXACT or key.startswith("VS"):
            assert port[key] == value, key
        else:
            np.testing.assert_allclose(port[key], value, rtol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("n,max_dose,increment", [
    (1, 150, 5), (7, 150, 5), (3000, 150, 5), (20000, 80, 2)])
def test_dvh_statistics_matches_jax(n, max_dose, increment):
    r = np.random.default_rng(n)
    dose = (r.gamma(4.0, 9.0, n)).astype(np.float32)
    dose[: min(n, 5)] = [0.0, 5.0, 60.0, 75.0, 150.0][: min(n, 5)]
    port = tdvh.dvh_statistics(dose, 0.0064, roi_name="PTV",
                               max_dose=max_dose, increment=increment)
    ref = jdvh.dvh_statistics(dose, 0.0064, roi_name="PTV",
                              max_dose=max_dose, increment=increment)
    assert_dvh_equal(port, ref)


def test_dvh_statistics_empty_roi():
    assert tdvh.dvh_statistics(np.zeros(0, np.float32), 0.001, "x") \
        == jdvh.dvh_statistics(np.zeros(0, np.float32), 0.001, "x")


def test_dvh_batch_matches_jax_and_single():
    r = np.random.default_rng(11)
    shape = (3, 6, 20, 24)
    doses = r.uniform(0, 70, shape).astype(np.float32)
    masks = np.zeros(shape, np.uint8)
    masks[0, 1:5, 4:16, 5:20] = 1
    masks[1] = r.random(shape[1:]) < 0.3
    # masks[2] stays empty: NaN statistics, volume 0
    vox = np.array([0.001, 0.002, 0.003])
    port = tbatch.dvh_batch(doses, masks, vox)
    ref = jbatch.dvh_batch(doses, masks, vox)
    assert port.keys() == ref.keys()
    for key, value in ref.items():
        assert port[key].dtype == np.float64
        if key in EXACT or key.startswith("VS"):
            np.testing.assert_array_equal(port[key], value, err_msg=key)
        else:
            np.testing.assert_allclose(port[key], value, rtol=1e-6,
                                       err_msg=key)
    assert np.isnan(port["Dmean"][2]) and port["Volume (cc)"][2] == 0
    # the batch agrees with the per-ROI statistics of each pair
    for b in (0, 1):
        single = tdvh.dvh_statistics(doses[b][masks[b] > 0], float(vox[b]))
        for key in ("Dmin", "Dmax", "D95", "VS20Gy_cc"):
            np.testing.assert_allclose(port[key][b], single[key],
                                       rtol=1e-6, err_msg=key)
    # over a CPU mesh of 3 data rows x 2: each pair its own row, equal to
    # mesh=None (one pair at a time either way); 3 pairs do not split
    # over 2 rows
    sharded = tbatch.dvh_batch(doses, masks, vox, mesh=make_mesh(
        6, space=2, devices=["cpu"] * 6))
    assert sharded.keys() == port.keys()
    for key, value in port.items():
        np.testing.assert_array_equal(sharded[key], value, err_msg=key)
    with pytest.raises(ValueError, match="not divisible"):
        tbatch.dvh_batch(doses, masks, vox,
                         mesh=make_mesh(2, devices=["cpu"] * 2))
