"""Legacy VTK polydata IO + VtkReader.

Port of medicalimageanalysis_tpu/read/vtk.py: the ASCII legacy-.vtk
POLYDATA codec (reference read/vtk.py:21-36), host numpy, with the JAX
package's ``%g`` digits in the writer.
"""

from __future__ import annotations

import numpy as np

from ..utils.mesh.trimesh import TriMesh

__all__ = ["read_vtk_polydata", "write_vtk_polydata", "VtkReader"]


def read_vtk_polydata(path):
    """Read an ASCII legacy .vtk POLYDATA file -> TriMesh (triangulating
    larger polygons by fanning). Corrupt files raise a clean ValueError
    naming the file."""
    try:
        return _read_vtk_polydata(path)
    except FileNotFoundError:
        raise
    except (ValueError, IndexError, KeyError, TypeError,
            OverflowError) as e:
        raise ValueError(
            f"invalid VTK file {str(path)!r}: "
            f"{type(e).__name__}: {e}") from e


def _read_vtk_polydata(path):
    with open(str(path), "r", errors="replace") as f:
        tokens = f.read().split()

    def find(word):
        for i, t in enumerate(tokens):
            if t.upper() == word:
                return i
        return -1

    pi = find("POINTS")
    if pi < 0:
        raise ValueError("not a legacy VTK POLYDATA file (no POINTS)")
    n_pts = int(tokens[pi + 1])
    coords = np.asarray(tokens[pi + 3:pi + 3 + 3 * n_pts],
                        dtype=np.float64).reshape(n_pts, 3)

    fi = find("POLYGONS")
    faces = []
    if fi >= 0:
        n_poly = int(tokens[fi + 1])
        idx = fi + 3
        # OFFSETS/CONNECTIVITY (new layout) or inline counts (old layout)
        if tokens[idx].upper() == "OFFSETS":
            # VTK 9 layout
            idx += 2
            offsets = [int(tokens[idx + k]) for k in range(n_poly)]
            idx += n_poly
            assert tokens[idx].upper() == "CONNECTIVITY"
            idx += 2
            conn_len = offsets[-1]
            conn = [int(tokens[idx + k]) for k in range(conn_len)]
            for a, b in zip(offsets[:-1], offsets[1:]):
                poly = conn[a:b]
                for k in range(1, len(poly) - 1):
                    faces.append([poly[0], poly[k], poly[k + 1]])
        else:
            for _ in range(n_poly):
                cnt = int(tokens[idx])
                poly = [int(tokens[idx + 1 + k]) for k in range(cnt)]
                idx += cnt + 1
                for k in range(1, cnt - 1):
                    faces.append([poly[0], poly[k], poly[k + 1]])
    return TriMesh(coords, np.asarray(faces, dtype=np.int32)
                   if faces else np.zeros((0, 3), np.int32))


def write_vtk_polydata(path, mesh):
    """Write a TriMesh as ASCII legacy .vtk POLYDATA."""
    with open(str(path), "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("medicalimageanalysis_torch mesh\nASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {mesh.number_of_points} float\n")
        for p in mesh.points:
            f.write(f"{p[0]:g} {p[1]:g} {p[2]:g}\n")
        nf = mesh.number_of_faces
        f.write(f"POLYGONS {nf} {nf * 4}\n")
        for face in mesh.faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


class VtkReader(object):
    """Appends meshes onto a parent reader (reference read/vtk.py:21-36)."""

    def __init__(self, reader):
        self.reader = reader
        if not hasattr(self.reader, "meshes"):
            self.reader.meshes = []
        if getattr(self.reader, "files", None) is None:
            self.reader.files = {"Dicom": [], "Stl": [], "Vtk": []}

    def input_files(self, files):
        self.reader.files["Vtk"] = files

    def load(self):
        for file_path in self.reader.files["Vtk"]:
            self.read(file_path)

    def read(self, path):
        self.reader.meshes += [read_vtk_polydata(path)]
