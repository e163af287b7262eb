"""The metric arithmetic on synthetic data, and the no-JAX check."""

import types

import pytest

from harness import core, readers, roofline
from harness.tracing import Trace, kernel_of, merged


def fake_run(jobs, window, trace=None, shapes=None):
    run = core.Run("x", trace is not None)
    run.jobs = jobs
    run.window = window
    run.trace = trace
    run.launch_shapes = shapes or {}
    return run


def test_rate_is_the_whole_window_over_the_jobs():
    # three jobs of 1, 2 and 4 s in a 10 s window: the idle start and the
    # gaps count, no job's own time is averaged
    run = fake_run([(1.0, 2.0), (2.0, 4.0), (4.0, 8.0)], (0.0, 10.0))
    assert readers.seconds_per_job(run) == pytest.approx(10.0 / 3)
    assert readers.seconds_per_job(fake_run([], (0.0, 1.0))) is None


def test_p95_over_every_request():
    lat = [0.010] * 95 + [0.100] * 5
    t, jobs = 0.0, []
    for d in lat:
        jobs.append((t, t + d))
        t += d
    run = fake_run(jobs, (0.0, t))
    # linear between order statistics: the 95th of 100 lies between the
    # 95th (10 ms) and 96th (100 ms) values, at 0.05 of the way
    assert readers.job_p95_ms(run) == pytest.approx(10.0 + 0.05 * 90.0)


def test_idle_share_of_a_made_up_timeline():
    # window 0-1000 ns; activities 100-300 and 200-400 (overlap), 900-1100
    # (clipped at the window); busy 300 + 100 = 400 ns
    device = [(100, 300, "k1", 90), (200, 400, "k2", 150),
              (900, 1100, "memcpy", 850)]
    tr = Trace(device, [(0, 500, "bench.demons"),
                        (500, 1000, "bench.create_image")], (0, 1000))
    assert tr.busy_s == pytest.approx(400e-9)
    run = fake_run([(0.0, 1.0)], (0.0, 1.0), tr)
    assert readers.device_idle(run) == pytest.approx(60.0)
    # gaps: 0-100 (demons), 400-900 (middle 650: create_image)
    gaps = dict(tr.idle_gaps(min_gap_ns=50))
    assert gaps["bench.demons"] == pytest.approx(100e-9)
    assert gaps["bench.create_image"] == pytest.approx(500e-9)
    # device time launched under a span, by the launch's host time
    total, n = tr.span_device_s("bench.demons")
    assert n == 1 and total == pytest.approx(400e-9)
    assert merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def test_roofline_share_from_known_shapes():
    # one disp launch, B=4 over 128 x 512 x 512 with no gradients: bytes
    # 4 * (4 n + 3 n + 4 n) = 44 n, above the 120 n operations' time
    n = 128 * 512 * 512
    shapes = {"warp": {("warp_disp", 4, False, (128, 512, 512),
                        (128, 512, 512)): 2},
              "hist": {(1_000_000, 300): 1}}
    b_disp = 44 * n / roofline.HBM_BYTES_PER_S
    b_hist = (4 * (2_000_000 + 300) + 8 * 300) / roofline.HBM_BYTES_PER_S
    bounds = roofline.launch_bounds_s(shapes["warp"], shapes["hist"])
    assert bounds["warp_disp"] == pytest.approx(2 * b_disp)
    assert bounds["dose_hist"] == pytest.approx(b_hist)
    share = roofline.kernel_share(bounds, {"warp_disp": 4 * b_disp,
                                           "dose_hist": 2 * b_hist})
    assert share == pytest.approx(100 * (2 * b_disp + b_hist)
                                  / (4 * b_disp + 2 * b_hist))
    # a counted kernel with no device time reads nothing, not 0
    assert roofline.kernel_share(bounds, {"warp_disp": 1.0}) is None
    tr = types.SimpleNamespace(kernel_s=lambda: {"warp_disp": 4 * b_disp,
                                                 "dose_hist": 2 * b_hist})
    run = fake_run([(0, 1)], (0, 1), tr, shapes)
    assert readers.kernel_roofline(run) == pytest.approx(share)


def test_kernel_names():
    assert kernel_of("void (anonymous namespace)::warp_kernel<((anonymous "
                     "namespace)::Mode)2, false, 4, 2>(float const*") \
        == "warp_disp"
    assert kernel_of("void (anonymous namespace)::axis_kernel<1>(") \
        == "warp_affine_axis"
    assert kernel_of("dose_hist_count_kernel") == "dose_hist"
    assert kernel_of("Memcpy DtoH (Device -> Pageable)") is None


def test_no_jax_check_takes_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1,
            "medicalimageanalysis_tpu.ops": 1, "medicalimageanalysis_torch": 1,
            "medicalimageanalysis_torch.ops.warp": 1, "jaxtyping": 1,
            "numpy": 1}
    assert core.forbidden_modules(mods) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla",
        "medicalimageanalysis_tpu.ops"]
    assert core.forbidden_modules({"medicalimageanalysis_torch": 1}) == []
