"""``validate_kernels`` of the port on the CPU: with ``device="cpu"`` the
plain versions pass every check of the JAX function and the port's three;
without a card and without ``device`` it raises; and a plain version
broken on purpose fails its own checks and no other."""

import numpy as np
import pytest
import torch

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import hist, lane_interp, warp
from medicalimageanalysis_torch.validate import (_fill_polygon_host,
                                                 validate_kernels)

# the keys of medicalimageanalysis_tpu/validate.py:validate_kernels
JAX_KEYS = {"warp_dvf", "warp_disp_mode", "warp_affine_mode",
            "warp_affine_tz16", "warp_oblique_shear", "warp_disp_vjp",
            "lane_interp", "dvh_histogram", "bitpack12", "edt_exact",
            "raster_tile_xor", "voxelize_parity"}


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    yield
    TData.clear()
    set_default_device(None)


def test_cpu_passes_every_jax_check_and_the_ports_two():
    result = validate_kernels(fast=False, device="cpu")
    assert result["backend"] == "cpu"
    assert set(result["checks"]) == JAX_KEYS | {"warp_coords_grads",
                                               "warp_affine_axis",
                                               "dvh_histogram_large"}
    assert result["ok"], result["detail"]
    assert set(result["detail"]) == set(result["checks"])
    # no check claims a hand kernel ran
    for name, note in result["detail"].items():
        assert "kernel ==" not in note, (name, note)
    for name in ("warp_dvf", "lane_interp", "dvh_histogram"):
        assert "no hand kernel ran" in result["detail"][name]


def test_fast_leaves_out_only_the_large_bin():
    result = validate_kernels(device="cpu")
    assert result["ok"], result["detail"]
    assert set(result["checks"]) == JAX_KEYS | {"warp_coords_grads",
                                               "warp_affine_axis"}
    assert "the warp_affine_axis entry" in result["detail"]["warp_affine_axis"]


def test_no_card_and_no_device_raises(monkeypatch):
    set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate_kernels()


def _shifted(fn):
    """``fn`` whose tensor results are all moved by 1."""
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        if torch.is_tensor(out):
            return out + 1
        return [o + 1 for o in out]
    return broken


@pytest.mark.parametrize("module,name,fails", [
    (lane_interp, "lane_interp_plain", {"lane_interp"}),
    (hist, "_hist_plain", {"dvh_histogram"}),
    (warp, "warp_disp_plain", {"warp_disp_mode", "warp_disp_vjp"}),
    (warp, "warp_affine_plain", {"warp_affine_mode", "warp_oblique_shear",
                                 "warp_affine_axis"}),
], ids=["lane_interp", "hist", "warp_disp", "warp_affine"])
def test_a_broken_plain_version_fails_only_its_own_checks(monkeypatch,
                                                          module, name,
                                                          fails):
    monkeypatch.setattr(module, name, _shifted(getattr(module, name)))
    result = validate_kernels(device="cpu")
    assert not result["ok"]
    assert {k for k, ok in result["checks"].items() if not ok} == fails


@pytest.mark.parametrize("seed", range(4))
def test_host_fill_golden_equals_cv2(seed):
    """The raster golden the card's machine uses (it has no cv2) is the
    cv2 fill on concave stars, the validate fixture's among them."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(7 if seed == 0 else 100 + seed)
    n = 17 if seed == 0 else int(rng.integers(5, 28))
    th = np.sort(rng.uniform(0, 2 * np.pi, n))
    star = np.stack([24 + rng.uniform(3, 14, n) * np.cos(th),
                     20 + rng.uniform(3, 14, n) * np.sin(th)], axis=1)
    ref = np.zeros((40, 44), np.uint8)
    cv2.fillPoly(ref, [np.trunc(star + 1e-6).astype(np.int32)], 1)
    np.testing.assert_array_equal(_fill_polygon_host(star, 40, 44), ref)
