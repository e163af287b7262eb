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


SPECIAL_THRESHOLDS = {
    "ties_signed_zeros": [0.0, -0.0, 0.0, -0.0, 5.0, 5.0, 60.0],
    "denormals": [1e-40, -1e-40, 0.0, -0.0, 1e-38],
    "infinities_nan": [np.inf, -np.inf, np.nan, 3.0, np.nan, -np.inf, 60.0],
    "all_nan": [np.nan, np.nan, np.nan],
    "one": [10.0],
    "descending": list(np.linspace(70.0, -1.0, 37)),
}


@pytest.mark.parametrize("name", sorted(SPECIAL_THRESHOLDS))
def test_sort_thresholds(name):
    """Sorted thresholds and their permutation on the thresholds' device:
    sorted == thr[perm], ascending over the non-NaN ones, NaN last."""
    thr = torch.tensor(SPECIAL_THRESHOLDS[name], dtype=torch.float32)
    srt, perm = thist.sort_thresholds(thr)
    assert srt.device == thr.device and perm.dtype == torch.int64
    assert sorted(perm.tolist()) == list(range(thr.numel()))
    assert torch.equal(srt.isnan(), thr[perm].isnan())
    assert torch.equal(srt[~srt.isnan()], thr[perm][~srt.isnan()])
    k = int((~thr.isnan()).sum())
    assert bool(srt[k:].isnan().all()) and not bool(srt[:k].isnan().any())
    assert bool((srt[1:k] >= srt[:k - 1]).all()) if k > 1 else True


def interval_model(dose, valid, thr):
    """The CUDA kernel's algorithm in numpy: thresholds sorted by the
    wrapper's helper; p = #{sorted <= d} by a binary search over the
    sorted thresholds padded with +inf to a power of two above n (NaN
    thresholds compare as +inf); valid voxels with a dose below +inf add
    1 to interval p < n; the inclusive prefix of the intervals, scattered
    through the permutation, with 0 for the NaN thresholds."""
    srt, perm = (t.numpy() for t in thist.sort_thresholds(
        torch.from_numpy(thr)))
    n = thr.size
    P = 1 << n.bit_length()                      # the least power of 2 > n
    s = np.full(P, np.inf, np.float32)
    s[:n] = srt
    with np.errstate(invalid="ignore"):
        take = (valid > 0) & (dose < np.inf)
        p = np.zeros(dose.size, np.int64)
        step = P >> 1
        while step:
            p += np.where(s[p + step - 1] <= dose, step, 0)
            step >>= 1
    assert p[take].max(initial=0) <= n          # +inf doses reach the pad
    p = p[take & (p < n)]
    interval = np.bincount(p, minlength=n)[:n]
    counts = np.empty(n, np.int64)
    counts[perm] = np.where(np.isnan(srt), 0, np.cumsum(interval))
    return counts


@pytest.mark.parametrize("n,thr_name", [
    (1, "one"), (2047, "ties_signed_zeros"), (2049, "infinities_nan"),
    (1500, "denormals"),
    (3001, "all_nan"), (4000, "descending"), (5000, "sorted300"),
    (6144, "unsorted23")])
def test_interval_model_matches_plain_and_jax(n, thr_name):
    """The kernel's interval-count algorithm (numpy model) against the
    plain twin and the JAX package's Pallas kernel in interpret mode, on
    doses with NaN, +-inf, +-0.0, a denormal and doses on thresholds;
    denormal thresholds against the plain twin alone."""
    if thr_name == "sorted300":
        dose, valid, thr = case(n, n, 300)
    elif thr_name == "unsorted23":
        dose, valid, thr = case(n, n, 14, sorted_thresholds=False)
    else:
        thr = np.asarray(SPECIAL_THRESHOLDS[thr_name], np.float32)
        dose, valid, _ = case(n, n, 8)
        r = np.random.default_rng(n)
        finite = thr[np.isfinite(thr)]
        if finite.size:
            k = min(n, 40)
            dose[r.choice(n, k, replace=False)] = r.choice(finite, k)
        dose[:min(n, 4)] = [0.0, -0.0, np.inf, -np.inf][:min(n, 4)]
    model = interval_model(dose, valid, thr)
    plain = thist._hist_plain(torch.from_numpy(dose), torch.from_numpy(valid),
                              torch.from_numpy(thr)).numpy()
    np.testing.assert_array_equal(model, plain)
    if thr_name == "denormals":
        # the JAX package's CPU path flushes denormal float32 to zero in
        # its compares (XLA's FTZ); the port and its kernel do not
        return
    ref = np.asarray(jpk.dose_below_histogram(dose, valid, thr,
                                              interpret=True))
    np.testing.assert_array_equal(model.astype(np.float32), ref)
