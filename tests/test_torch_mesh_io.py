"""Mesh IO in both packages on the CPU: STL (binary and ASCII), VTK, PLY
(binary with colours and ASCII), OBJ and 3MF files written by each
package read back equal in the other; the PLY special cases (big endian,
quads, unknown elements, float colours); the readers' ValueError on a
corrupt file; the reader classes; ``TriMesh.save``'s dispatch; 3MF
textures with and without PIL; ``read_3mf`` and ``ModelToMask``.

Tolerances, stated per check:
- a file read by the port equals the same file read by the JAX package:
  bit-equal points, faces and colours;
- against the mesh written: exact for OBJ (17 digits); float32 rounding
  for binary STL and PLY, and within it for ASCII PLY and 3MF (9
  digits); the writers' ``%g`` (6 significant digits) for ASCII STL and
  VTK;
- ``ModelToMask``'s filled mask: bit-equal to the JAX package's, which
  fills with cv2.fillPoly where the port fills with its own rasterizer.
"""

import sys
import types
import zipfile

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.read import mf3 as tmf3
from medicalimageanalysis_torch.read import obj as tobj
from medicalimageanalysis_torch.read import ply as tply
from medicalimageanalysis_torch.read import stl as tstl
from medicalimageanalysis_torch.read import vtk as tvtk
from medicalimageanalysis_torch.utils.convert.contour import (
    ModelToMask as TModelToMask)
from medicalimageanalysis_torch.utils.mesh.trimesh import TriMesh as TMesh
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.ops.marching_cubes import mask_to_mesh
from medicalimageanalysis_tpu.read import mf3 as jmf3
from medicalimageanalysis_tpu.read import obj as jobj
from medicalimageanalysis_tpu.read import ply as jply
from medicalimageanalysis_tpu.read import stl as jstl
from medicalimageanalysis_tpu.read import vtk as jvtk
from medicalimageanalysis_tpu.utils.convert.contour import (
    ModelToMask as JModelToMask)
from medicalimageanalysis_tpu.utils.mesh.trimesh import TriMesh as JMesh

F32 = 2.0 ** -23            # float32's relative rounding


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


def ellipsoid(shape=(20, 40, 40), radii=(7.0, 12.0, 9.0)):
    """A marching-cubes ellipsoid in mm (spacing 0.7 x 0.9 x 2.5, an
    off-grid origin), with per-vertex colours from a seed."""
    zz, yy, xx = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    c = [(n - 1) / 2 for n in shape]
    mask = (((zz - c[0]) / radii[0]) ** 2 + ((yy - c[1]) / radii[1]) ** 2
            + ((xx - c[2]) / radii[2]) ** 2) <= 1.0
    m = mask_to_mesh(mask.astype(np.uint8), [0.7, 0.9, 2.5],
                     [-13.37, 21.5, -40.25], np.eye(3))
    colors = np.random.default_rng(12).integers(
        0, 256, (m.points.shape[0], 3)).astype(np.uint8)
    return np.asarray(m.points, np.float64), np.asarray(m.faces), colors


def both_meshes(colored=True):
    pts, faces, colors = ellipsoid()
    out = []
    for cls in (TMesh, JMesh):
        mesh = cls(pts.copy(), faces.copy())
        if colored:
            mesh["colors"] = colors
        out.append(mesh)
    return out


# format -> (port writer, JAX writer, port reader, JAX reader, atol of
# the points against the mesh written: a float, or "f32" for float32
# rounding of each coordinate)
FORMATS = {
    "stl_binary": (tstl.write_stl, jstl.write_stl, tstl.read_stl,
                   jstl.read_stl, "f32", ".stl", {}),
    "stl_ascii": (tstl.write_stl, jstl.write_stl, tstl.read_stl,
                  jstl.read_stl, 5e-4, ".stl", {"binary": False}),
    "vtk": (tvtk.write_vtk_polydata, jvtk.write_vtk_polydata,
            tvtk.read_vtk_polydata, jvtk.read_vtk_polydata, 5e-4, ".vtk",
            {}),
    "ply_binary": (tply.write_ply, jply.write_ply, tply.read_ply,
                   jply.read_ply, "f32", ".ply", {}),
    "ply_ascii": (tply.write_ply, jply.write_ply, tply.read_ply,
                  jply.read_ply, "f32", ".ply", {"binary": False}),
    "obj": (tobj.write_obj, jobj.write_obj, tobj.read_obj, jobj.read_obj,
            0.0, ".obj", {}),
}


def triangles(mesh):
    """The mesh's triangles as rows of corner coordinates, face by face:
    a welding reader (STL) renumbers the vertices, not the faces."""
    return mesh.points[mesh.faces].reshape(len(mesh.faces), 9)


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_files_read_back_equal_in_both_packages(tmp_path, fmt, writer):
    t_write, j_write, t_read, j_read, atol, ext, kw = FORMATS[fmt]
    tmesh, jmesh = both_meshes()
    path = tmp_path / f"m{ext}"
    if writer == "torch":
        t_write(path, tmesh, **kw)
    else:
        j_write(path, jmesh, **kw)
    got, want = t_read(path), j_read(path)
    assert type(got) is TMesh
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert sorted(got.point_data) == sorted(want.point_data)
    for key in want.point_data:
        np.testing.assert_array_equal(got.point_data[key],
                                      want.point_data[key])
    if fmt.startswith(("ply", "obj")):
        np.testing.assert_array_equal(got.point_data["colors"],
                                      tmesh.point_data["colors"])
    if fmt.startswith("stl"):
        a, b = triangles(got), triangles(tmesh)
    else:
        np.testing.assert_array_equal(got.faces, tmesh.faces)
        a, b = got.points, tmesh.points
    tol = F32 * np.abs(b) if atol == "f32" else atol
    assert np.all(np.abs(a - b) <= tol), fmt


def test_text_writers_keep_the_jax_digits(tmp_path):
    """OBJ, ASCII PLY, ASCII STL and VTK: the same data lines, past the
    header comment naming the package."""
    tmesh, jmesh = both_meshes()
    for name, (t_write, j_write, *_, ext, kw) in FORMATS.items():
        if name in ("stl_binary", "ply_binary"):
            continue
        t_write(tmp_path / f"t{ext}", tmesh, **kw)
        j_write(tmp_path / f"j{ext}", jmesh, **kw)
        t_lines = (tmp_path / f"t{ext}").read_text().splitlines()
        j_lines = (tmp_path / f"j{ext}").read_text().splitlines()
        differ = [i for i, (a, b) in enumerate(zip(t_lines, j_lines))
                  if a != b]
        assert len(t_lines) == len(j_lines) and len(differ) <= 1, name
        assert all("medicalimageanalysis" in t_lines[i] for i in differ)


PLY_CASES = {
    "big_endian_extra_property": (
        ("ply\nformat binary_big_endian 1.0\nelement vertex 4\n"
         "property double x\nproperty double y\nproperty double z\n"
         "property ushort confidence\nelement face 1\n"
         "property list uchar uint vertex_indices\nend_header\n").encode()
        + b"".join(np.array(p, ">f8").tobytes()
                   + np.array([i], ">u2").tobytes()
                   for i, p in enumerate([[0, 0, 0], [1, 0, 0], [1, 1, 0],
                                          [0, 1, 0]]))
        + bytes([4]) + np.array([0, 1, 2, 3], ">u4").tobytes()),
    "ascii_quads_unknown_element": (
        "ply\nformat ascii 1.0\ncomment made by hand\nelement vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "element edge 2\nproperty int vertex1\nproperty int vertex2\n"
        "element face 1\nproperty list uchar int vertex_indices\n"
        "end_header\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n0 1\n2 3\n"
        "4 0 1 2 3\n").encode(),
    "float_colors": (
        "ply\nformat ascii 1.0\nelement vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float red\nproperty float green\nproperty float blue\n"
        "element face 1\nproperty list uchar int vertex_indices\n"
        "end_header\n0 0 0 1 0 0\n1 0 0 0 0.5 0\n0 1 0 0 0 1\n"
        "3 0 1 2\n").encode(),
}


@pytest.mark.parametrize("case", sorted(PLY_CASES))
def test_ply_special_cases_match_jax(tmp_path, case):
    path = tmp_path / "p.ply"
    path.write_bytes(PLY_CASES[case])
    got, want = tply.read_ply(path), jply.read_ply(path)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert sorted(got.point_data) == sorted(want.point_data)
    for key in want.point_data:
        np.testing.assert_array_equal(got.point_data[key],
                                      want.point_data[key])
    assert got.faces.shape[0] >= 1


def corrupt(tmp_path, fmt):
    """A corrupt file of ``fmt``: not the format at all, or (binary PLY)
    a body cut short."""
    path = tmp_path / f"bad.{fmt}"
    if fmt == "ply":
        good = tmp_path / "good.ply"
        jply.write_ply(good, both_meshes()[1])
        path.write_bytes(good.read_bytes()[:-30])
    elif fmt == "obj":
        path.write_text("v 0 0 0\nv 1 0 0\nf 1 2 9\n")
    elif fmt == "vtk":
        path.write_text("# vtk DataFile Version 3.0\nx\nASCII\n"
                        "DATASET POLYDATA\nPOINTS 3 float\n0 0 0\n1 0\n")
    else:
        path.write_bytes(b"PK\x03\x04 not a zip")
    return path


@pytest.mark.parametrize("fmt", ["ply", "obj", "vtk", "3mf"])
def test_corrupt_files_raise_value_error_naming_them(tmp_path, fmt):
    path = corrupt(tmp_path, fmt)
    readers = {"ply": (tply.read_ply, jply.read_ply),
               "obj": (tobj.read_obj, jobj.read_obj),
               "vtk": (tvtk.read_vtk_polydata, jvtk.read_vtk_polydata),
               "3mf": (lambda p: tmf3.ThreeMfReader(p, "M").load(),
                       lambda p: jmf3.ThreeMfReader(p, "M").load())}
    for read in readers[fmt]:
        with pytest.raises(ValueError, match="bad"):
            read(path)


@pytest.mark.parametrize("fmt", ["stl", "3mf", "vtk", "ply", "obj"])
def test_trimesh_save_dispatches_like_jax(tmp_path, fmt):
    tmesh, jmesh = both_meshes(colored=fmt in ("3mf", "ply", "obj"))
    tmesh.save(tmp_path / f"t.{fmt}")
    jmesh.save(str(tmp_path / f"j.{fmt}"))
    if fmt == "3mf":
        t_xml, j_xml = (zipfile.ZipFile(tmp_path / f"{n}.3mf").read(
            "3D/3dmodel.model") for n in "tj")
        assert t_xml == j_xml
    else:
        assert (tmp_path / f"t.{fmt}").read_bytes().count(b"\n") == \
            (tmp_path / f"j.{fmt}").read_bytes().count(b"\n")
    tmesh.save(tmp_path / "t.npz")
    back = np.load(tmp_path / "t.npz")
    np.testing.assert_array_equal(back["points"], tmesh.points)


@pytest.mark.parametrize("cls", ["StlReader", "VtkReader", "PlyReader",
                                 "ObjReader"])
def test_reader_classes_and_top_level_readers(tmp_path, cls):
    ext = cls[:3].lower()
    key = cls[:3]
    tmesh, _ = both_meshes(colored=False)
    path = tmp_path / f"m.{ext}"
    tmesh.save(path)
    parent = types.SimpleNamespace(files=None)
    reader = getattr(tmia, cls)(parent)
    reader.input_files([str(path)])
    reader.load()
    top = getattr(tmia, f"read_{ext}")(str(path))
    assert len(getattr(tmia, f"read_{ext}")(path)) == 1    # a PathLike
    want = getattr(jmia, f"read_{ext}")(str(path))
    assert getattr(tmia, cls) is not getattr(jmia, cls)
    assert parent.files[key] == [str(path)] and len(parent.meshes) == 1
    for got in (parent.meshes[0], top[0]):
        np.testing.assert_array_equal(got.points, want[0].points)
        np.testing.assert_array_equal(got.faces, want[0].faces)


def texture_3mf(path, tmp_path):
    """A 3MF of one tetrahedron whose colours come from a 2x2 PNG
    texture (texture2dgroup UV lookups)."""
    from PIL import Image as PilImage

    png = tmp_path / "tex.png"
    PilImage.fromarray(np.array([[[255, 0, 0], [0, 255, 0]],
                                 [[0, 0, 255], [255, 255, 0]]],
                                np.uint8)).save(png)
    ns = 'xmlns="http://schemas.microsoft.com/3dmanufacturing/core/2015/02"'
    mns = ('xmlns:m="http://schemas.microsoft.com/3dmanufacturing/'
           'material/2015/02"')
    pts = [(0, 0, 0), (40, 0, 0), (0, 40, 0), (0, 0, 40)]
    tris = [(0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2)]
    uvs = [(0, 0), (1, 0), (0, 1), (1, 1)]
    model = [f'<model unit="millimeter" {ns} {mns}><resources>',
             '<m:texture2d id="1" path="/3D/tex.png" '
             'contenttype="image/png"/>',
             '<m:texture2dgroup id="2" texid="1">']
    model += [f'<m:tex2coord u="{u}" v="{v}"/>' for u, v in uvs]
    model += ['</m:texture2dgroup><object id="3" type="model"><mesh>'
              '<vertices>']
    model += [f'<vertex x="{x}" y="{y}" z="{z}"/>' for x, y, z in pts]
    model += ['</vertices><triangles>']
    model += [f'<triangle v1="{a}" v2="{b}" v3="{c}" pid="2" p1="{a}" '
              f'p2="{b}" p3="{c}"/>' for a, b, c in tris]
    model += ['</triangles></mesh></object></resources><build>'
              '<item objectid="3"/></build></model>']
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("3D/3dmodel.model", "\n".join(model))
        z.write(png, "3D/tex.png")


def without_pil(monkeypatch):
    for name in [m for m in sys.modules if m == "PIL"
                 or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_textured_3mf_reads_like_jax_and_needs_pil(tmp_path, monkeypatch):
    path = tmp_path / "tex.3mf"
    texture_3mf(path, tmp_path)
    t = tmf3.ThreeMfReader(str(path), "Organ")
    t.load()
    j = jmf3.ThreeMfReader(str(path), "Organ")
    j.load()
    np.testing.assert_array_equal(t.mesh.point_data["colors"],
                                  j.mesh.point_data["colors"])
    assert len(np.unique(t.mesh.point_data["colors"], axis=0)) > 1
    without_pil(monkeypatch)
    with pytest.raises(ImportError, match="PIL"):
        tmf3.ThreeMfReader(str(path), "Organ").load()


def test_read_3mf_matches_jax_and_reads_without_pil(tmp_path, monkeypatch):
    """An untextured (basematerials) 3MF needs no PIL. ``read_3mf``
    registers the fake image ModelToMask sized (empty, as in the
    reference) with a mesh-only ROI, whose mask is the voxelized mesh:
    equal to the JAX package's."""
    tmesh, jmesh = both_meshes()
    path = tmp_path / "organ.3mf"
    tmf3.write_3mf(path, tmesh)
    without_pil(monkeypatch)
    t = tmia.read_3mf(str(path), roi_name="Organ")
    j = jmia.read_3mf(str(path), roi_name="Organ")
    assert TData.image_list == JData.image_list == [t.image_name]
    ti, ji = TData.image[t.image_name], JData.image[j.image_name]
    np.testing.assert_array_equal(ti.array, np.asarray(ji.array))
    for key in ("origin", "spacing", "dimensions"):
        np.testing.assert_array_equal(getattr(ti, key), getattr(ji, key))
    np.testing.assert_array_equal(t.mesh.points, j.mesh.points)
    np.testing.assert_array_equal(t.mesh.point_data["colors"],
                                  tmesh.point_data["colors"])
    roi = ti.rois["Organ"]
    assert roi.contour_pixel is None and roi.multi_color
    mask = roi.compute_mask()
    np.testing.assert_array_equal(mask, np.asarray(
        ji.rois["Organ"].compute_mask()))
    assert mask.sum() > 100


def test_model_to_mask_matches_jax():
    """The auto grid (joint bounds + 5-voxel pad) and the filled mask."""
    tmesh, jmesh = both_meshes(colored=False)
    t = TModelToMask([tmesh], empty_array=False)
    j = JModelToMask([jmesh], empty_array=False)
    assert t.spacing == j.spacing and t.bounds == j.bounds
    assert t.dims == j.dims and t.slice_locations == j.slice_locations
    for a, b in zip(t.contours[0], j.contours[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert t.mask.dtype == j.mask.dtype == np.int8
    np.testing.assert_array_equal(t.mask, j.mask)
    assert (t.mask != 0).sum() > 100
    assert TModelToMask([tmesh]).mask.sum() == 0


def test_model_to_mask_descending_slice_locations_match_jax():
    """User-supplied slice locations in descending (feet-first) order:
    the same fills as the ascending grid, reversed, in both packages."""
    tmesh, jmesh = both_meshes(colored=False)

    def manual(cls, mesh, locs):
        m = cls([mesh], convert=False, empty_array=False)
        m.spacing = [1, 1, 1]
        m.bounds = [-20, 20, 0, 60, -40, 10]
        m.origin = [-20, 0, -40]
        m.slice_locations = locs
        m.dims = [len(locs), 61, 41]
        m.compute_contours()
        m.compute_mask()
        return m.mask

    asc = list(range(-40, 10))
    t_asc, t_dsc = (manual(TModelToMask, tmesh, locs)
                    for locs in (asc, asc[::-1]))
    j_dsc = manual(JModelToMask, jmesh, asc[::-1])
    assert (t_asc != 0).sum() > 100
    np.testing.assert_array_equal(t_dsc, j_dsc)
    np.testing.assert_array_equal(t_asc, t_dsc[::-1])
