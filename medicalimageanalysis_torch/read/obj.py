"""Wavefront OBJ mesh IO + ObjReader.

Port of medicalimageanalysis_tpu/read/obj.py: the ASCII OBJ codec, host
Python. The reference's generic-mesh path (`pv.read`, reference
read/stl.py:21-36) would accept .obj but is dormant there.

Supported: v (with the common ``v x y z r g b`` vertex-color
extension), f with ``v``/``v/vt``/``v//vn``/``v/vt/vn`` forms and
negative (relative) indices; polygons are fan-triangulated. vt/vn/
usemtl/mtllib/o/g/s lines are ignored (no material resolution). The
writer emits v (+colors when ``mesh.point_data['colors']`` exists,
round-tripping losslessly as f8-exact 0..1 floats) and triangle f
lines.
"""

from __future__ import annotations

import numpy as np

from ..utils.mesh.trimesh import TriMesh

__all__ = ["read_obj", "write_obj", "ObjReader"]


def read_obj(path):
    """Read a .obj file -> TriMesh (corrupt files raise ValueError
    naming the file, matching the repo-wide reader contract)."""
    try:
        return _read_obj(path)
    except FileNotFoundError:
        raise
    except (ValueError, IndexError, KeyError, TypeError,
            OverflowError) as e:
        raise ValueError(
            f"invalid OBJ file {str(path)!r}: "
            f"{type(e).__name__}: {e}") from e


def _read_obj(path):
    verts = []
    vcols = []
    polys = []
    with open(str(path), "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                if len(parts) < 4:
                    raise ValueError(f"short vertex line {line!r}")
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
                if len(parts) >= 7:
                    vcols.append([float(parts[4]), float(parts[5]),
                                  float(parts[6])])
                else:
                    vcols.append(None)
            elif tag == "f":
                if len(parts) < 4:
                    raise ValueError(f"short face line {line!r}")
                idx = []
                for tok in parts[1:]:
                    v = int(tok.split("/")[0])
                    if v < 0:
                        v = len(verts) + v
                    else:
                        v = v - 1
                    if not 0 <= v < len(verts):
                        raise ValueError(
                            f"face index {tok} out of range in {line!r}")
                    idx.append(v)
                for k in range(1, len(idx) - 1):
                    polys.append((idx[0], idx[k], idx[k + 1]))
            # vt/vn/usemtl/mtllib/o/g/s/l/p: ignored

    if not verts:
        raise ValueError("no vertices")
    points = np.asarray(verts, dtype=np.float64)
    faces = (np.asarray(polys, dtype=np.int32) if polys
             else np.zeros((0, 3), dtype=np.int32))
    mesh = TriMesh(points, faces)
    if all(c is not None for c in vcols) and vcols:
        rgb = np.asarray(vcols, dtype=np.float64)
        mesh["colors"] = (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(
            np.uint8)
    return mesh


def write_obj(path, mesh):
    """Write a TriMesh as .obj (vertex colors from
    ``mesh.point_data['colors']`` as the x y z r g b extension;
    uint8 values round-trip exactly through the repr'd c/255 floats)."""
    p = np.asarray(mesh.points, dtype=np.float64)
    f = np.asarray(mesh.faces, dtype=np.int32).reshape(-1, 3)
    getc = getattr(mesh, "vertex_colors_uint8", lambda: None)
    colors = getc()
    if colors is not None:
        colors = colors.astype(np.float64) / 255.0

    with open(str(path), "w") as fh:
        fh.write("# medicalimageanalysis_torch\n")
        for i in range(p.shape[0]):
            line = f"v {p[i,0]:.17g} {p[i,1]:.17g} {p[i,2]:.17g}"
            if colors is not None:
                line += (f" {colors[i,0]:.17g} {colors[i,1]:.17g}"
                         f" {colors[i,2]:.17g}")
            fh.write(line + "\n")
        for i in range(f.shape[0]):
            fh.write(f"f {f[i,0]+1} {f[i,1]+1} {f[i,2]+1}\n")


class ObjReader(object):
    """Appends meshes onto a parent reader (same contract as StlReader,
    read/stl.py:79-99)."""

    def __init__(self, reader):
        self.reader = reader
        if not hasattr(self.reader, "meshes"):
            self.reader.meshes = []
        if getattr(self.reader, "files", None) is None:
            self.reader.files = {"Dicom": [], "Stl": [], "Vtk": [],
                                 "Ply": [], "Obj": []}
        self.reader.files.setdefault("Obj", [])

    def input_files(self, files):
        self.reader.files["Obj"] = files

    def load(self):
        for file_path in self.reader.files["Obj"]:
            self.read(file_path)

    def read(self, path):
        self.reader.meshes += [read_obj(path)]
