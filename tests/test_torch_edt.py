"""The port's exact EDT and surface panel (ops/edt.py) against the JAX
package's, on the CPU.

Tolerances, stated per check:
- squared distances: bit-equal. Each min-plus sum rounds to float32 once
  and the minimum is exact, and XLA contracts no FMA there (a sum, not a
  product plus a sum), so the two agree to the bit;
- ``edt`` / ``distance_transform``: within 1 ulp. Their square roots of
  those equal squares differ in about 0.4 % of the voxels: XLA's CPU
  square root is not correctly rounded, torch's is;
- ``boundary_mask``: bit-equal;
- ``masked_percentile``: bit-equal, negatives, +-inf, NaN and the
  int32-midpoint case included;
- the surface panel: 1e-5 relative (the ASSD sums in another order).
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import edt as TE
from medicalimageanalysis_tpu.ops import edt as JE


@pytest.fixture(autouse=True)
def torch_env():
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    set_default_device(None)


def blobs(rng, shape, p=0.99, iters=3):
    m = ndimage.binary_dilation(rng.random(shape) > p, iterations=iters)
    if not m.any():
        m[tuple(s // 2 for s in shape)] = True
    return m


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def assert_within_1_ulp(got, ref):
    """Same infinities, finite values at most one float32 ulp apart."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    ulps = np.abs(bits(got).astype(np.int64) - bits(ref).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()


EDT_CASES = {
    "aniso": ((24, 28, 20), (0.8, 1.2, 2.5)),
    "iso": ((16, 16, 16), (1.0, 1.0, 1.0)),
    "thin": ((9, 33, 7), (2.0, 0.5, 1.3)),
    "one_slice": ((1, 12, 10), (0.9, 0.9, 3.0)),
}


@pytest.mark.parametrize("case", list(EDT_CASES))
def test_squared_edt_bit_equal_to_jax(case):
    shape, spacing = EDT_CASES[case]
    m = blobs(np.random.default_rng(len(case)), shape)
    ref = np.asarray(JE.squared_edt(m, spacing))
    got = TE.squared_edt(m, spacing)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(bits(got), bits(ref))
    assert_within_1_ulp(TE.edt(m, spacing), JE.edt(m, spacing))
    assert_within_1_ulp(TE.distance_transform(~m, spacing),
                        JE.distance_transform(~m, spacing))


def test_edt_batched_full_and_empty():
    full = np.ones((6, 7, 8), bool)
    empty = np.zeros((6, 7, 8), bool)
    batch = np.stack([full, empty, blobs(np.random.default_rng(1),
                                         (6, 7, 8), p=0.95, iters=1)])
    got = TE.edt(batch, (1.0, 1.5, 2.0))
    ref = np.asarray(JE.edt(batch, (1.0, 1.5, 2.0)))
    assert got.shape == batch.shape
    assert_within_1_ulp(got, ref)
    assert float(got[0].max()) == 0.0 and torch.isinf(got[1]).all()


def test_step_budget_does_not_change_the_result(monkeypatch):
    """A budget of a few rows a step (rows split as well as outputs)
    gives the same bits as one step a pass."""
    m = blobs(np.random.default_rng(7), (12, 14, 18))
    whole = TE.squared_edt(m, (0.7, 1.1, 2.0))
    monkeypatch.setattr(TE, "_STEP_BYTES", 4 * 18 * 5)
    np.testing.assert_array_equal(bits(TE.squared_edt(m, (0.7, 1.1, 2.0))),
                                  bits(whole))


@pytest.mark.parametrize("shape", [(12, 15, 11), (8, 8, 8), (5, 6, 7)])
def test_boundary_mask_equals_jax(shape):
    m = blobs(np.random.default_rng(shape[0]), shape, p=0.97) \
        if shape != (5, 6, 7) else np.ones(shape, bool)
    got = TE.boundary_mask(m)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(JE.boundary_mask(m)))
    np.testing.assert_array_equal(got.numpy(),
                                  m & ~ndimage.binary_erosion(m))


def percentile_cases():
    rng = np.random.default_rng(11)
    vals = rng.random((4, 50)).astype(np.float32)
    valid = rng.random((4, 50)) > 0.6
    valid[0, :3] = True
    mixed = ((rng.random(300) - 0.5) * 2000.0).astype(np.float32)
    mmask = rng.random(300) > 0.4
    mixed[:4] = [np.inf, -np.inf, -0.0, 0.0]
    one = np.zeros(5, bool)
    one[2] = True
    return {
        "uniform": (vals, valid, (0.0, 37.5, 95.0, 100.0)),
        "signed": (np.array([-5.0, -1.0, 2.0, 3.0], np.float32),
                   np.ones(4, bool), (0.0, 25.0, 50.0, 90.0, 100.0)),
        "mixed_inf": (mixed, mmask, (0.0, 12.5, 50.0, 95.0, 99.9, 100.0)),
        # the int32 midpoint overflowed here before the guard
        "midpoint": (np.array([1e30, 2e32, 3e35, np.inf, 5.0], np.float32),
                     np.ones(5, bool), (0.0, 30.0, 50.0, 100.0)),
        "neg_inf": (np.array([-np.inf, -2.0, 1.0], np.float32),
                    np.ones(3, bool), (0.0, 40.0)),
        "duplicates": (np.array([1.0, 1.0, 2.0], np.float32),
                       np.ones(3, bool), (25.0, 75.0)),
        "nan_valid": (np.array([1.0, np.nan, 3.0], np.float32),
                      np.ones(3, bool), (50.0,)),
        "nan_invalid": (np.array([1.0, np.nan, 3.0], np.float32),
                        np.array([True, False, True]), (50.0,)),
        "one": (vals[0, :5], one, (95.0,)),
        "empty": (vals[0, :5], np.zeros(5, bool), (95.0,)),
    }


@pytest.mark.parametrize("case", list(percentile_cases()))
def test_masked_percentile_bit_equal_to_jax(case):
    vals, valid, qs = percentile_cases()[case]
    for q in qs:
        got = TE.masked_percentile(vals, valid, q)
        ref = np.float32(JE.masked_percentile(vals, valid, q))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert bits(got) == bits(ref), (case, q, float(got), float(ref))


PANEL_CASES = {
    "shifted": ((20, 30, 25), (0.9, 1.1, 2.0), (1, 2, -1), 2.0),
    "aniso_tol": ((14, 18, 16), (0.8, 0.8, 2.5), (0, -2, 3), 1.5),
}


@pytest.mark.parametrize("case", list(PANEL_CASES))
def test_surface_metrics_match_jax(case):
    shape, sp, shift, tol = PANEL_CASES[case]
    a = blobs(np.random.default_rng(5), shape, p=0.995, iters=4)
    b = np.roll(a, shift, axis=(0, 1, 2))
    got = TE.surface_metrics(a, b, sp, tol)
    ref = JE.surface_metrics(a, b, sp, tol)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("which", ["identical", "one_empty", "both_empty"])
def test_surface_metrics_empty_and_identical(which):
    a = blobs(np.random.default_rng(3), (10, 12, 14), p=0.98)
    empty = np.zeros_like(a)
    pair = {"identical": (a, a), "one_empty": (a, empty),
            "both_empty": (empty, empty)}[which]
    got = {k: float(v) for k, v in TE.surface_metrics(*pair).items()}
    ref = {k: float(v) for k, v in JE.surface_metrics(*pair).items()}
    for k in ref:
        assert got[k] == ref[k] or (np.isnan(got[k]) and np.isnan(ref[k])), k


def test_no_card_and_no_request_raises():
    """With no card an entry point given numpy raises unless the caller
    asks for the CPU; a CPU tensor stays on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    set_default_device(None)
    m = np.ones((3, 4, 5), bool)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.squared_edt(m)
    assert TE.squared_edt(m, device="cpu").device.type == "cpu"
    assert TE.squared_edt(torch.from_numpy(m)).device.type == "cpu"
