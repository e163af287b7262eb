"""N4 bias correction in both packages, on the CPU: the port's ops/n4.py
(``torch.fft`` sharpening, the CG B-spline fit in full float32, the
level loop with its host-read convergence gate), ``parallel.batch.
n4_batch`` and ``Image.correct_bias`` against the JAX package's, and
the JAX suite's twin test (tests/test_n4.py:307) run against the port's
``_n4_level``.

Tolerances, stated per check (those of tests/test_n4.py):
- one level against the host float64 twin: 2e-3 after one iteration,
  1.2e-2 over the full level (the f32 CG noise compounds);
- ``n4_bias_correction`` and ``Image.correct_bias`` against the JAX
  package: the fields' ratio has mean within 2e-3 of 1 and spread under
  5e-3 (the FFTs of torch and XLA differ in the last bits, and some 60
  iterations of histogram feedback amplify it), plus the recovery
  assertions of tests/test_n4.py:58-76 on the port's own output;
- ``n4_batch`` lanes against their single-volume calls: the same ratio
  rule; an empty lane untouched with a unit field;
- the smoother: 5e-3 reproduction as tests/test_n4.py; 2e-3 against its
  host float64 twin and against the JAX package's (the f32 CG's own
  noise, tests/test_n4.py's one-iteration bound); the sharpening 1e-4 /
  1e-3 of the range against the host float64 golden; the device finish
  1e-5 relative against the host float64 finish.
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import n4 as tn4
from medicalimageanalysis_torch.parallel.batch import n4_batch
from medicalimageanalysis_torch.parallel.mesh import make_mesh
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.ops import n4 as jn4
from test_n4 import _biased_volume, _host_n4_level


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    JData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    JData.clear()
    set_default_device(None)


def assert_same_field(f, ref):
    ratio = np.asarray(f, np.float64) / np.asarray(ref, np.float64)
    assert abs(ratio.mean() - 1.0) < 2e-3
    assert ratio.std() < 5e-3


def twin_case(bias_mode):
    shape = (16, 24, 24)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape],
                             indexing="ij")
    if bias_mode == "poly":
        logb = 0.3 * zz + 0.2 * yy * xx - 0.18 * xx ** 2
    else:
        logb = 0.22 * np.sin(1.3 * zz + 0.4) + 0.15 * np.cos(
            1.1 * yy) * xx
    rng = np.random.default_rng(3)
    truth = np.where(zz ** 2 + yy ** 2 + xx ** 2 < 0.55, 700.0, 250.0)
    truth = np.clip(truth + rng.normal(0, 10, shape), 1, None)
    return shape, logb, truth * np.exp(logb)


@pytest.mark.parametrize("bias_mode", ["poly", "waves"])
def test_n4_level_matches_host_f64_twin(bias_mode):
    """tests/test_n4.py's twin test against the port's level: every
    fitting level from identical inputs, one iteration then the full
    level; the port's own host twin equals the JAX suite's."""
    shape, logb, vol = twin_case(bias_mode)
    w64 = (vol > 0).astype(np.float64)
    res64 = np.where(w64 > 0, np.log(vol), 0.0)
    tot64 = np.zeros_like(res64)
    n_bins, fwhm, noise, thr, iters = 64, 0.15, 0.01, 1e-4, 6

    def lanes(a):
        return torch.as_tensor(a, dtype=torch.float32)[None]

    for sp_vox in tn4._level_spacings(shape, 3, 8.0, 1):
        mats = tn4._level_basis_mats(shape, sp_vox, "cpu")
        mats_host = [tn4._bspline_basis_matrix(n, sp_vox[ax], p)
                     for p in (1, 2) for ax, n in enumerate(shape)]
        for n_it, tol in ((1, 2e-3), (iters, 1.2e-2)):
            res_d, tot_d = tn4._n4_level(lanes(res64), lanes(tot64),
                                         lanes(w64), n_bins, fwhm, noise,
                                         thr, n_it, *mats)
            res_h, tot_h = _host_n4_level(res64, tot64, w64, n_bins, fwhm,
                                          noise, thr, n_it, mats_host)
            own = tn4._host_n4_level(res64, tot64, w64, n_bins, fwhm,
                                     noise, thr, n_it, mats_host)
            np.testing.assert_array_equal(own[0], res_h)
            np.testing.assert_array_equal(own[1], tot_h)
            np.testing.assert_allclose(tot_d[0].numpy(), tot_h, atol=tol)
            np.testing.assert_allclose(res_d[0].numpy(), res_h, atol=tol)
        res64, tot64 = res_h, tot_h
    lb = logb - logb.mean()
    tb = tot64 - tot64.mean()
    assert np.abs(tb - lb).mean() / np.abs(lb).mean() < 0.6


def test_n4_matches_jax_and_recovers_the_bias():
    vol, truth, field_true = _biased_volume()
    corr, field = tn4.n4_bias_correction(vol, shrink=2, return_field=True)
    corr_j, field_j = jn4.n4_bias_correction(vol, shrink=2,
                                             return_field=True)
    assert corr.dtype == np.float32 and corr.shape == vol.shape
    assert field.dtype == np.float32
    assert_same_field(field, field_j)
    # tests/test_n4.py:58-76 on the port's output
    assert np.allclose(vol, corr * field, rtol=2e-3)
    r = field / field_true
    r = r / r.mean()
    assert r.std() < 0.25 * (field_true.std() / field_true.mean())
    bright = truth > 500
    cv_b = vol[bright].std() / vol[bright].mean()
    cv_a = corr[bright].std() / corr[bright].mean()
    assert cv_a < 0.45 * cv_b
    # a tensor input stays on its device and gives the same result
    corr_t = tn4.n4_bias_correction(torch.as_tensor(vol), shrink=2)
    np.testing.assert_array_equal(corr_t, corr)


def test_n4_mask_nonpositive_and_degenerate_inputs():
    vol, _, _ = _biased_volume()
    vol = vol.copy()
    vol[:4] = 0.0
    vol[4] = -77.0
    mask = np.zeros(vol.shape, bool)
    mask[6:, 4:-4, 4:-4] = True
    corr = tn4.n4_bias_correction(vol, mask=mask, shrink=2)
    assert np.all(corr[:4] == 0)
    assert np.all(corr[4] == np.float32(-77.0))
    assert np.isfinite(corr).all()
    assert_same_field(corr[6:], jn4.n4_bias_correction(
        vol, mask=mask, shrink=2)[6:])
    out, field = tn4.n4_bias_correction(np.zeros((4, 8, 8)),
                                        return_field=True)
    assert np.all(out == 0) and np.all(field == 1)
    with pytest.raises(ValueError, match="expected"):
        tn4.n4_bias_correction(np.ones((8, 8)))


def test_smoother_matches_jax():
    shape = (16, 24, 24)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape],
                             indexing="ij")
    smooth = 0.1 * zz + 0.05 * yy * xx
    w = np.ones(shape, np.float32)
    wm = (xx > 0).astype(np.float32)
    noise = np.random.default_rng(1).normal(0, 0.05, shape)
    for r, weights, sp in ((smooth, w, 12), (smooth, w, 6),
                           (np.full(shape, 0.3), w, 8), (smooth, wm, 8),
                           (noise, w, 8), (smooth, w, (6, 8, 12))):
        f = tn4.bspline_smooth_field(r, weights, sp)
        assert f.dtype == np.float64 and f.shape == shape
        sv = np.broadcast_to(np.asarray(sp, np.float64), (3,))
        twin = tn4._host_wls_fit_apply(
            r, weights.astype(np.float64),
            *[tn4._bspline_basis_matrix(n, sv[ax], p)
              for p in (1, 2) for ax, n in enumerate(shape)])
        np.testing.assert_allclose(f, twin, rtol=0, atol=2e-3)
        np.testing.assert_allclose(
            f, jn4.bspline_smooth_field(r, weights, sp), rtol=0, atol=2e-3)
        if r is smooth:
            sel = weights > 0
            assert np.abs((f - smooth)[sel]).max() < 5e-3
    f = tn4.bspline_smooth_field(noise, w, 8)
    assert f.std() < 0.25 * noise.std()


def test_device_sharpen_matches_host_golden():
    rng = np.random.default_rng(5)
    n_bins = 200
    h = rng.gamma(2.0, 50.0, n_bins).astype(np.float32)
    h[:20] = 0
    vmin, vmax = 5.1, 6.9
    c_d, m_d = tn4._device_sharpen(
        torch.as_tensor(h)[None], torch.tensor([vmin], dtype=torch.float32),
        torch.tensor([vmax], dtype=torch.float32), n_bins, 0.15, 0.01)
    c_h, m_h = tn4._sharpen_from_hist(h, vmin, vmax, n_bins, 0.15, 0.01)
    scale = vmax - vmin
    assert np.abs(c_d[0].numpy() - c_h).max() < 1e-4 * scale
    assert np.abs(m_d[0].numpy() - m_h).max() < 1e-3 * scale
    c_j, m_j = jn4._sharpen_from_hist(h, vmin, vmax, n_bins, 0.15, 0.01)
    np.testing.assert_array_equal(c_h, c_j)
    np.testing.assert_array_equal(m_h, m_j)
    c_d, m_d = tn4._device_sharpen(
        torch.as_tensor(h)[None], torch.tensor([2.0]), torch.tensor([2.0]),
        n_bins, 0.15, 0.01)
    assert torch.equal(c_d, m_d)


def test_finalize_device_matches_host():
    rng = np.random.default_rng(9)
    vol = rng.normal(300, 50, (11, 14, 17))
    vol[0] = 0.0
    vol[1] = -5.0
    total = rng.normal(0, 0.1, (6, 7, 9))
    c_h, f_h = tn4._host_finalize(vol, total, 2, True)
    c_j, f_j = jn4._host_finalize(vol, total, 2, True)
    np.testing.assert_array_equal(c_h, c_j)
    np.testing.assert_array_equal(f_h, f_j)
    c_d, f_d = tn4._n4_finalize(torch.as_tensor(vol, dtype=torch.float32),
                                torch.as_tensor(total, dtype=torch.float32),
                                2)
    np.testing.assert_allclose(f_d.numpy(), f_h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c_d.numpy(), c_h, rtol=1e-4, atol=1e-4)
    assert np.all(c_d.numpy()[0] == 0)
    assert np.all(c_d.numpy()[1] == np.float32(-5.0))


def test_n4_batch_matches_single_calls():
    """Each lane follows its single-volume trajectory (the gate freezes a
    lane that converged); an empty-mask lane comes back untouched."""
    vols = [_biased_volume(shape=(16, 24, 24), seed=s)[0] for s in range(3)]
    vols.append(np.zeros((16, 24, 24)))
    batch = np.stack(vols).astype(np.float32)
    corr_b, field_b = n4_batch(batch, shrink=2, return_fields=True)
    assert corr_b.shape == batch.shape and corr_b.dtype == np.float32
    for b in range(3):
        _, field_s = tn4.n4_bias_correction(batch[b], shrink=2,
                                            return_field=True)
        assert_same_field(field_b[b], field_s)
    assert np.all(corr_b[3] == 0) and np.allclose(field_b[3], 1.0)
    assert n4_batch(batch[:2], shrink=2).shape == (2, 16, 24, 24)
    with pytest.raises(ValueError, match="masks shape"):
        n4_batch(np.ones((2, 8, 8, 8)), masks=np.ones((8, 8, 8)))
    # a 2-shard CPU mesh: two lanes a data row, each lane's trajectory
    # its single-volume one, so the fields equal mesh=None's
    corr_m, field_m = n4_batch(batch, shrink=2, return_fields=True,
                               mesh=make_mesh(2, devices=["cpu"] * 2))
    for b in range(4):
        assert_same_field(field_m[b], field_b[b])
    np.testing.assert_array_equal(corr_m[3], corr_b[3])


def test_image_correct_bias_matches_jax(tmp_path):
    """Image.correct_bias through read_dicoms: mm control spacing, an
    ROI-bounded fit, in_place."""
    vol, _, field_true = _biased_volume(shape=(12, 32, 32), seed=3)
    write_ct_series(tmp_path / "mr", np.ascontiguousarray(
        vol.astype(np.int16)), modality="MR")
    tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    jmia.read_dicoms(folder_path=str(tmp_path))
    ti = list(TData.image.values())[0]
    ji = list(JData.image.values())[0]
    corr, field = ti.correct_bias(shrink=2, control_spacing_mm=25.0,
                                  return_field=True)
    corr_j, field_j = ji.correct_bias(shrink=2, control_spacing_mm=25.0,
                                      return_field=True)
    assert corr.shape == ti.array.shape
    assert_same_field(field, field_j)
    r = field / field_true
    r = r / r.mean()
    assert r.std() < 0.5 * (field_true.std() / field_true.mean())
    mask = np.zeros(ti.array.shape, np.uint8)
    mask[2:10, 6:26, 6:26] = 1
    for img in (ti, ji):
        img.create_roi(name="Body", color=[0, 255, 0])
        img.rois["Body"].convert_mask(mask)
    out = ti.correct_bias(mask_roi="Body", shrink=2)
    ref = ji.correct_bias(mask_roi="Body", shrink=2)
    assert_same_field(out[2:10, 6:26, 6:26], ref[2:10, 6:26, 6:26])
    before = ti.array.copy()
    out = ti.correct_bias(shrink=2, in_place=True)
    assert ti.array is out and not np.array_equal(ti.array, before)
