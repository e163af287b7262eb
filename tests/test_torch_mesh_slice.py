"""The Rigid and Deformable Displays' mesh cuts in both packages on the
CPU, on tests/test_torch_roi_mesh.py's study (a CT with a spherical PTV
and an annular ring, read by each package), in the three planes, as
polylines (``_SliceResult``) and as in-plane pixel paths.

Tolerances, stated per check:
- the Rigid Display's cut: 1e-6 mm (and pixels), the meshes carried by
  the same float64 matrices (1e-9 mm, test_torch_roi_mesh.py);
- the Deformable Display's cut of one deformed mesh: 1e-6 mm;
- the Deformable Display's cut through its own ``update_rois``: 1e-5 mm,
  the warp's bound (the field is sampled by the ``coords`` plain twin,
  within float32 rounding of the JAX package's XLA gather).
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import warp as twarp
from medicalimageanalysis_torch.structure.deformable import (
    Deformable as TDeformable)
from medicalimageanalysis_torch.utils.mesh.trimesh import TriMesh
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.structure.deformable import (
    Deformable as JDeformable)
from test_torch_roi_mesh import smooth_field, write_case

# a point inside the PTV on each plane
CUTS = (("Axial", [1.3, 2.1, -1.0]), ("Coronal", [1.3, 2.0, 0.0]),
        ("Sagittal", [1.0, 2.1, 0.0]))


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


@pytest.fixture
def case(tmp_path):
    write_case(tmp_path)
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path))
    t, j = TData.image["CT 01"], JData.image["CT 01"]
    for img in (t, j):
        for name in ("PTV", "Ring"):
            img.rois[name].create_discrete_mesh()
            img.rois[name].visible = True
    return t, j


def same_loops(t, j, atol, nonempty=True):
    if hasattr(j, "loops"):
        assert type(t).__name__ == "_SliceResult"
        t, j = t.loops, j.loops
    assert len(t) == len(j) and (len(t) > 0 or not nonempty)
    for a, b in zip(t, j):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def rigid_matrix():
    matrix = np.eye(4)
    c, s = np.cos(0.1), np.sin(0.1)
    matrix[:2, :2] = [[c, -s], [s, c]]
    matrix[:3, 3] = [1.5, -2.0, 0.75]
    return matrix


@pytest.mark.parametrize("plane,loc", CUTS)
@pytest.mark.parametrize("pixel", [False, True])
def test_rigid_display_mesh_slice_matches_jax(case, plane, loc, pixel):
    """The cut carries the ROI onto the reference first
    (``update_rois``), then slices it on the display matrix's plane; its
    pixels are on the resliced grid (``compute_reslice``)."""
    rt, rj = (mia.Rigid("CT 01", "CT 01", matrix=rigid_matrix())
              for mia in (tmia, jmia))
    if pixel:
        for rigid in (rt, rj):
            rigid.display.compute_reslice()
    for name in ("PTV", "Ring"):
        out_t = rt.display.compute_mesh_slice(
            roi_name=name, location=loc, slice_plane=plane,
            return_pixel=pixel)
        out_j = rj.display.compute_mesh_slice(
            roi_name=name, location=loc, slice_plane=plane,
            return_pixel=pixel)
        same_loops(out_t, out_j, 1e-6, nonempty=name == "PTV")
    assert rt.rois["PTV"] is not None
    # no mesh: []
    assert rt.display.compute_mesh_slice("Sparse", loc, plane) == \
        rj.display.compute_mesh_slice("Sparse", loc, plane) == []


def deformables(t):
    rigid = np.eye(4)
    rigid[:3, 3] = [0.5, -0.25, 0.0]
    kw = dict(dvf=smooth_field(), origin=np.asarray(t.origin),
              spacing=tuple(t.spacing), rigid_matrix=rigid,
              reference_name="CT 01", moving_name="CT 01")
    return TDeformable(device="cpu", **kw), JDeformable(**kw)


@pytest.mark.parametrize("plane,loc", CUTS)
@pytest.mark.parametrize("pixel", [False, True])
def test_deformable_display_mesh_slice_matches_jax(case, plane, loc, pixel):
    """Through update_rois (the coords plain twin on the CPU: no launch)
    to the warp's 1e-5 mm; then each package cuts the same deformed mesh
    to 1e-6 mm. Pixels are on the frames' grid (``compute_deformation``)."""
    dt, dj = deformables(case[0])
    if pixel:
        for d in (dt, dj):
            d.display.compute_deformation()
    before = twarp.LAUNCHES["warp_coords"]
    kw = dict(roi_name="PTV", location=loc, slice_plane=plane,
              return_pixel=pixel)
    same_loops(dt.display.compute_mesh_slice(**kw),
               dj.display.compute_mesh_slice(**kw), 1e-5)
    assert twarp.LAUNCHES["warp_coords"] == before
    assert dt.rois["PTV"] is not None
    assert {n: m is None for n, m in dt.rois.items()} == \
        {n: m is None for n, m in dj.rois.items()}
    shared = dj.rois["PTV"]
    dt.rois["PTV"] = TriMesh(shared.points.copy(), shared.faces.copy())
    same_loops(dt.display.compute_mesh_slice(**kw),
               dj.display.compute_mesh_slice(**kw), 1e-6)


def test_deformable_display_mesh_slice_without_a_moving_image():
    """No moving image: update_rois has nothing to carry, the cut is []
    in both packages."""
    dt, dj = TDeformable(device="cpu"), JDeformable()
    assert dt.display.compute_mesh_slice("PTV") == \
        dj.display.compute_mesh_slice("PTV") == []
