"""The tetrahedral mesher (utils/mesh/volume.py) in both packages on the
CPU, on tests/test_mesh_utils.py's smoothed sphere and bean, by
isosurface stuffing and by the 6-tet voxel grid; ``TetMesh``'s VTK
writer; and the polygon fills its inside test stands on
(ops/rasterize.polygon_bitmaps / fill_polygons_2d).

Tolerances, stated per check:
- tet counts, cells and the polygon fills: equal;
- tet points and volumes: 1e-9 relative (the same float64 numpy code;
  the inside test is the port's rasterizer on the same integer
  operands);
- the quality bounds of tests/test_mesh_utils.py:378 on the port's
  stuffing: volume 0.94-1.03 of the surface's (sphere), 0.90-1.05
  (bean), minimum dihedral at least 8 degrees.
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import rasterize as traster
from medicalimageanalysis_torch.utils.mesh.trimesh import TriMesh as TMesh
from medicalimageanalysis_torch.utils.mesh.volume import Volume as TVolume
from medicalimageanalysis_tpu.ops import rasterize as jraster
from medicalimageanalysis_tpu.ops.marching_cubes import marching_cubes_mask
from medicalimageanalysis_tpu.utils.mesh.surface import taubin_smooth
from medicalimageanalysis_tpu.utils.mesh.volume import Volume as JVolume


@pytest.fixture(autouse=True)
def torch_env():
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    set_default_device(None)


def surface(shape):
    n = 28
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n]
    c = n / 2 - 0.5
    mask = ((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2
            <= 100).astype(np.uint8)
    if shape == "bean":
        mask[(zz - c) ** 2 + (yy - (c + 8)) ** 2 + (xx - c) ** 2 <= 36] = 0
    return taubin_smooth(marching_cubes_mask(mask), iterations=20,
                         passband=0.1)


BOUNDS = {"sphere": (0.94, 1.03), "bean": (0.90, 1.05)}


@pytest.mark.parametrize("shape", ["sphere", "bean"])
@pytest.mark.parametrize("method", ["stuffing", "voxel"])
def test_volume_matches_jax(shape, method):
    surf = surface(shape)
    tsurf = TMesh(surf.points.copy(), surf.faces.copy())
    got = TVolume(tsurf).create(edge_length=0.05, method=method)
    want = JVolume(surf).create(edge_length=0.05, method=method)
    assert got.n_cells == want.n_cells > 100
    np.testing.assert_array_equal(got.cells, want.cells)
    np.testing.assert_allclose(got.points, want.points, rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.volume, want.volume, rtol=1e-9)
    if method == "stuffing":
        lo, hi = BOUNDS[shape]
        assert lo * surf.volume < got.volume < hi * surf.volume
        assert got.dihedral_angles().min() >= 8.0
        np.testing.assert_allclose(got.dihedral_angles(),
                                   want.dihedral_angles(), rtol=1e-9)


def test_tet_mesh_writer_matches_jax(tmp_path):
    surf = surface("sphere")
    t = TVolume(TMesh(surf.points.copy(), surf.faces.copy()))
    t.create(edge_length=0.1)
    j = JVolume(surf)
    j.create(edge_length=0.1)
    t.write(tmp_path / "t.vtk")
    j.write(tmp_path / "j.vtk")
    assert (tmp_path / "t.vtk").read_bytes() == \
        (tmp_path / "j.vtk").read_bytes()
    assert tmia.utils.Volume is TVolume


def polygons(seed, k):
    """k random star-shaped polygons (a few self-touching ones among
    them) with fractional vertices on a 40 x 48 frame."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n = int(r.integers(3, 14))
        a = np.sort(r.uniform(0, 2 * np.pi, n))
        rad = r.uniform(2.0, 15.0, n)
        c = r.uniform(5.0, 35.0, 2)
        out.append(np.stack([c[0] + rad * np.cos(a),
                             c[1] + rad * np.sin(a)], axis=1))
    out.append(np.array([[-3.5, 4.2], [60.1, 10.0], [20.0, 45.7]]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polygon_fills_match_jax(seed):
    polys = polygons(seed, 6)
    got = traster.polygon_bitmaps(polys, 40, 48, device="cpu")
    want = np.asarray(jraster.polygon_bitmaps(polys, 40, 48))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        traster.fill_polygons_2d(polys, 40, 48, device="cpu"),
        jraster.fill_polygons_2d(polys, 40, 48))
    assert traster.fill_polygons_2d([], 40, 48).shape == (40, 48)
