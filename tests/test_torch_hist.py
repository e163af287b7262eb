"""The cumulative dose histogram (ops/hist): the plain twin that CPU
tensors take, against the JAX package's ``dose_below_histogram`` in
Pallas interpret mode (its TPU kernel's own CPU path). Counts are
integers: the comparison is bit-equal (tolerance 0)."""

import numpy as np
import pytest
import torch

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import hist as thist
from medicalimageanalysis_tpu.ops import pallas_kernels as jpk


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


SPECIAL_DOSE = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-40, 5.0, 10.0, 60.0]
SPECIAL_VALID = [0.0, 1.0, 0.5, -1.0, np.nan]


def case(seed, n, n_bins, sorted_thresholds=True):
    r = np.random.default_rng(seed)
    dose = r.uniform(0.0, 70.0, n).astype(np.float32)
    valid = r.choice(SPECIAL_VALID, n).astype(np.float32)
    k = min(n, 64)
    dose[r.choice(n, k, replace=False)] = r.choice(SPECIAL_DOSE, k)
    thr = np.linspace(0.0, 66.0, n_bins).astype(np.float32)
    if not sorted_thresholds:
        thr = r.permutation(np.concatenate(
            [thr, thr[:3], [np.nan, np.inf, -np.inf, -0.0, 5.0, 60.0]]))
        thr = thr.astype(np.float32)
    # some doses exactly on a threshold
    dose[:min(n, 8)] = thr[:min(n, 8)]
    return dose, valid, thr


@pytest.mark.parametrize("n,n_bins,sorted_thresholds", [
    (1, 32, True), (2047, 32, True), (2049, 300, True), (5000, 23, False),
    (6144, 300, False)])
def test_plain_twin_matches_jax_interpret(n, n_bins, sorted_thresholds):
    dose, valid, thr = case(n + n_bins, n, n_bins, sorted_thresholds)
    port = thist._hist_plain(torch.from_numpy(dose), torch.from_numpy(valid),
                             torch.from_numpy(thr))
    ref = np.asarray(jpk.dose_below_histogram(dose, valid, thr,
                                              interpret=True))
    assert port.dtype == torch.int64
    np.testing.assert_array_equal(port.numpy().astype(np.float32), ref)


def test_wrapper_on_cpu_takes_the_plain_twin():
    dose, valid, thr = case(3, 3000, 40)
    before = thist.LAUNCHES["dose_hist"]
    out = thist.dose_below_histogram(dose, valid > 0, thr)
    assert out.device.type == "cpu"
    assert thist.LAUNCHES["dose_hist"] == before     # no kernel launched
    np.testing.assert_array_equal(out.numpy(), thist._hist_plain(
        torch.from_numpy(dose), torch.from_numpy(valid),
        torch.from_numpy(thr)).numpy())


def test_counts_are_exact_above_2_pow_24():
    """A bin holding more than 2^24 voxels: the port counts in int64, so
    it is exact where the JAX kernel's float32 accumulator cannot be."""
    n = (1 << 24) + 3
    dose = torch.zeros(n)
    out = thist.dose_below_histogram(dose, torch.ones(n),
                                     np.array([-1.0, 1.0], np.float32))
    assert out.tolist() == [0, n]
    assert float(np.float32(n)) != n          # f32 cannot hold the count
