"""The port's polygon rasterizer (ops/rasterize, utils/convert/contour,
parallel/batch.rasterize_batch) against the JAX package's device
rasterizer and its cv2 backend, on the CPU. Every comparison is bit-equal
(tolerance 0): the masks are integers."""

import cv2
import numpy as np
import pytest
import torch

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import rasterize as traster
from medicalimageanalysis_torch.parallel import batch as tbatch
from medicalimageanalysis_torch.utils.convert import contour as tcontour
from medicalimageanalysis_torch.parallel.mesh import make_mesh
from medicalimageanalysis_tpu.ops import rasterize as jraster
from medicalimageanalysis_tpu.parallel import batch as jbatch
from medicalimageanalysis_tpu.utils.convert import contour as jcontour


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def star(r, cx, cy, n, rmin, rmax):
    th = np.sort(r.uniform(0, 2 * np.pi, n))
    rad = r.uniform(rmin, rmax, n)
    return np.stack([cx + rad * np.cos(th), cy + rad * np.sin(th)], axis=1)


@pytest.mark.parametrize("seed", range(6))
def test_concave_star_fuzz_matches_jax_and_cv2(seed):
    """Concave random stars (exact half-integer edge crossings from
    integer vertices, the cv2 tie rule) inside the canvas: the port
    equals the cv2 backend and the JAX device rasterizer."""
    dims = (6, 48, 56)
    for trial in range(5):
        r = np.random.default_rng(1000 + 10 * seed + trial)
        n = int(r.integers(5, 28))
        cx, cy = r.uniform(20, 28, 2)
        z = float(r.integers(0, 6))
        poly = np.concatenate([star(r, cx, cy, n, 2.0, 18.0),
                               np.full((n, 1), z)], axis=1)
        port = tcontour._rasterize_plane([poly], dims, "Axial")
        gold = jcontour._rasterize_plane([poly], dims, "Axial",
                                         backend="cv2")
        jdev = jcontour._rasterize_plane([poly], dims, "Axial",
                                         backend="device")
        np.testing.assert_array_equal(port, gold, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(port, jdev, err_msg=f"trial {trial}")


@pytest.mark.parametrize("seed", range(4))
def test_pooled_polygons_match_jax(seed):
    """Many polygons of every tile class (16 px up to full frame), some
    partly off the canvas, on shared slices (XOR): rasterize_polygons
    equals the JAX package's, tile anchors and all."""
    r = np.random.default_rng(seed)
    S, H, W = 5, 300, 280
    polys, slices = [], []
    for k in range(24):
        n = int(r.integers(3, 60))
        rmax = float(r.choice([6, 14, 30, 60, 120, 200]))
        cx, cy = r.uniform(-20, W + 20), r.uniform(-20, H + 20)
        polys.append(star(r, cx, cy, n, 1.0, rmax))
        slices.append(int(r.integers(0, S)))
    port = traster.rasterize_polygons(polys, slices, S, H, W)
    jax_out = jraster.rasterize_polygons(polys, slices, S, H, W)
    assert port.dtype == np.uint8 and port.shape == (S, H, W)
    np.testing.assert_array_equal(port, jax_out)


def test_xor_holes_match_cv2():
    """An outer contour with an inner contour on the same slice: the
    inner one is a hole (XOR), as in the cv2 loop; a third polygon
    overlapping both flips parity where it lands."""
    outer = np.array([[4, 4], [40, 4], [40, 36], [4, 36]], float)
    inner = np.array([[12, 12], [30, 12], [30, 26], [12, 26]], float)
    third = np.array([[25, 20], [46, 22], [35, 44]], float)
    contours = [np.concatenate([p, np.full((len(p), 1), 2.0)], axis=1)
                for p in (outer, inner, third)]
    dims = (4, 48, 50)
    port = tcontour._rasterize_plane(contours, dims, "Axial")
    gold = jcontour._rasterize_plane(contours, dims, "Axial", backend="cv2")
    np.testing.assert_array_equal(port, gold)
    assert port[2, 18, 20] == 0 and port[2, 6, 6] == 1


def test_out_of_range_and_negative_slices_are_dropped():
    sq = np.array([[4.0, 4.0], [20.0, 4.0], [20.0, 18.0], [4.0, 18.0]])
    contours = [np.concatenate([sq, np.full((4, 1), z)], axis=1)
                for z in (-3.0, -1.0, 2.0, 5.0, 9.0, 12.0)]
    dims = [8, 32, 32]
    port = tcontour._rasterize_plane(contours, dims, "Axial")
    gold = jcontour._rasterize_plane(contours, dims, "Axial", backend="cv2")
    np.testing.assert_array_equal(port, gold)
    assert port[0].sum() == 0 and port[2].sum() > 0 and port[5].sum() > 0


def test_out_of_canvas_is_exact_crop():
    """A polygon past the canvas edge keeps its unclipped geometry: the
    mask is the big-canvas cv2 fill cropped, as in the JAX package."""
    shape = np.array(
        [[42, 53], [38, 45], [36, 44], [19, 42], [24, 37], [31, 37],
         [32, 36], [37, 27], [45, 29]], float)
    poly = np.concatenate([shape, np.zeros((len(shape), 1))], axis=1)
    dims = (1, 48, 56)
    port = tcontour._rasterize_plane([poly], dims, "Axial")
    big = np.zeros((80, 80), np.uint8)
    cv2.fillPoly(big, [shape.astype(np.int32)], 1)
    np.testing.assert_array_equal(port[0], big[:48, :56])
    np.testing.assert_array_equal(port, jcontour._rasterize_plane(
        [poly], dims, "Axial", backend="device"))


@pytest.mark.parametrize("plane", ["Coronal", "Sagittal"])
def test_coronal_sagittal_match_cv2(plane):
    dims = (10, 12, 14)
    contours = []
    for s in (2, 5):
        if plane == "Coronal":
            poly = np.array([[2, s, 2], [9, s, 2], [9, s, 7], [2, s, 7]],
                            float)
        else:
            poly = np.array([[s, 2, 2], [s, 9, 2], [s, 9, 7], [s, 2, 7]],
                            float)
        contours.append(poly)
    port = tcontour._rasterize_plane(contours, dims, plane)
    gold = jcontour._rasterize_plane(contours, dims, plane, backend="cv2")
    np.testing.assert_array_equal(port, gold)
    assert port.sum() > 0


@pytest.mark.parametrize("plane", ["Axial", "Coronal"])
def test_rasterize_batch_matches_jax(plane):
    """Three ROIs pooled into one pass equal the JAX package's
    rasterize_batch and the per-ROI rasterization."""
    r = np.random.default_rng(5)
    dims = (7, 40, 44)
    sets = []
    for b in range(3):
        cs = []
        for k in range(4):
            p = star(r, r.uniform(10, 30), r.uniform(10, 30),
                     int(r.integers(4, 20)), 2.0, 12.0)
            s = float(r.integers(-1, 8))
            cs.append(np.stack([p[:, 0], np.full(len(p), s), p[:, 1]], 1)
                      if plane == "Coronal" else
                      np.concatenate([p, np.full((len(p), 1), s)], 1))
        sets.append(cs)
    port = tbatch.rasterize_batch(sets, dims, plane=plane)
    np.testing.assert_array_equal(port, jbatch.rasterize_batch(
        sets, dims, plane=plane))
    for b in range(3):
        np.testing.assert_array_equal(port[b], tcontour._rasterize_plane(
            sets[b], dims, plane))


@pytest.mark.parametrize("plane", ["Axial", "Coronal", "Sagittal"])
def test_host_returns_keep_their_dtype_layout_and_bits(plane):
    """rasterize_batch and rasterize_polygons_grouped(host=True) return
    C-contiguous, writable uint8 0/1 numpy arrays equal to the JAX
    package's in every plane; host=False leaves the same bits on the
    device."""
    r = np.random.default_rng(11)
    dims = (14, 30, 34)
    S, H, W, axis = tcontour.plane_canvas(dims, plane)
    sets = []
    for b in range(3):
        cs = []
        for k in range(3):
            u, v = star(r, r.uniform(6, W - 6), r.uniform(6, H - 6),
                        int(r.integers(4, 16)), 1.0, 5.0).T
            s = float(r.integers(0, S))
            cs.append(np.stack(
                [u, v, np.full(len(u), s)] if plane == "Axial" else
                [u, np.full(len(u), s), v] if plane == "Coronal" else
                [np.full(len(u), s), u, v], 1))
        sets.append(cs)
    port = tbatch.rasterize_batch(sets, dims, plane=plane)
    assert port.dtype == np.uint8 and port.shape == (3,) + dims
    assert port.flags.c_contiguous and port.flags.writeable
    assert set(np.unique(port)) == {0, 1}
    np.testing.assert_array_equal(port, jbatch.rasterize_batch(
        sets, dims, plane=plane))
    grouped = [tcontour._plane_split(cs, plane) for cs in sets]
    host = traster.rasterize_polygons_grouped(grouped, S, H, W)
    assert host.dtype == np.uint8 and host.shape == (3, S, H, W)
    assert host.flags.c_contiguous and host.flags.writeable
    np.testing.assert_array_equal(host, np.asarray(
        jraster.rasterize_polygons_grouped(grouped, S, H, W)))
    np.testing.assert_array_equal(np.moveaxis(host, 1, axis + 1), port)
    dev = traster.rasterize_polygons_grouped(grouped, S, H, W, host=False)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.uint8
    np.testing.assert_array_equal(dev.numpy(), host)
    empty = traster.rasterize_polygons_grouped([([], [])], S, H, W,
                                               host=False)
    assert empty.shape == (1, S, H, W) and not empty.any()


def test_no_cv2_and_no_mesh_in_the_port():
    # MaskToContour traces with the port's own tracer, not cv2
    assert tcontour.MaskToContour(np.zeros((2, 4, 4), np.uint8),
                                  [1, 1, 1], [0, 0, 0],
                                  np.eye(3)).create_contours() == ([], [])
    # a 2-shard CPU mesh rasterizes each half of the ROIs on its row,
    # equal to the pooled pass
    sets = [[np.array([[1.0, 1.0, s], [3.0, 1.0, s], [2.0, 3.0, s]])]
            for s in (0.0, 1.0)]
    np.testing.assert_array_equal(
        tbatch.rasterize_batch(sets, (2, 4, 4),
                               mesh=make_mesh(2, devices=["cpu"] * 2)),
        tbatch.rasterize_batch(sets, (2, 4, 4)))
