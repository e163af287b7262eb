"""STL mesh IO + StlReader.

Port of medicalimageanalysis_tpu/read/stl.py, host numpy and ``struct``
as there: the binary and ASCII STL codec (reference read/stl.py:21-36,
where the public wrapper is commented out at reference
reader.py:462-473). Binary files carry float32 coordinates; the ASCII
writer keeps the JAX package's ``%g`` digits, so a file written by either
package reads back equal in the other.
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils.mesh.trimesh import TriMesh

__all__ = ["read_stl", "write_stl", "StlReader"]


def read_stl(path):
    """Read binary or ASCII STL -> TriMesh (duplicate vertices welded)."""
    with open(str(path), "rb") as f:
        head = f.read(5)
        f.seek(0)
        data = f.read()

    if head == b"solid" and b"facet" in data[:1000]:
        # ASCII
        verts = []
        for line in data.decode("latin-1", errors="replace").splitlines():
            line = line.strip()
            if line.startswith("vertex"):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
        tris = np.asarray(verts, dtype=np.float64).reshape(-1, 3, 3)
    else:
        n = struct.unpack_from("<I", data, 80)[0]
        rec = np.frombuffer(data, dtype=np.uint8, count=n * 50,
                            offset=84).reshape(n, 50)
        floats = rec[:, :48].copy().view("<f4").reshape(n, 12)
        tris = floats[:, 3:12].astype(np.float64).reshape(n, 3, 3)

    points = tris.reshape(-1, 3)
    faces = np.arange(points.shape[0], dtype=np.int32).reshape(-1, 3)
    return TriMesh(points, faces).clean(tolerance=1e-9)


def write_stl(path, mesh, binary=True):
    """Write a TriMesh as STL."""
    p = mesh.points
    f = mesh.faces
    a = p[f[:, 0]]
    b = p[f[:, 1]]
    c = p[f[:, 2]]
    n = np.cross(b - a, c - a)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)

    if binary:
        with open(str(path), "wb") as fh:
            fh.write(b"\0" * 80)
            fh.write(struct.pack("<I", f.shape[0]))
            rec = np.zeros((f.shape[0], 50), dtype=np.uint8)
            floats = np.concatenate([n, a, b, c], axis=1).astype("<f4")
            rec[:, :48] = floats.view(np.uint8).reshape(f.shape[0], 48)
            fh.write(rec.tobytes())
    else:
        with open(str(path), "w") as fh:
            fh.write("solid mesh\n")
            for i in range(f.shape[0]):
                fh.write(f"facet normal {n[i,0]:g} {n[i,1]:g} {n[i,2]:g}\n")
                fh.write("  outer loop\n")
                for v in (a[i], b[i], c[i]):
                    fh.write(f"    vertex {v[0]:g} {v[1]:g} {v[2]:g}\n")
                fh.write("  endloop\nendfacet\n")
            fh.write("endsolid mesh\n")


class StlReader(object):
    """Appends meshes onto a parent reader (reference read/stl.py:21-36;
    the parent DicomReader grows a `meshes` list here, fixing the
    reference's missing-attribute bug)."""

    def __init__(self, reader):
        self.reader = reader
        if not hasattr(self.reader, "meshes"):
            self.reader.meshes = []
        if getattr(self.reader, "files", None) is None:
            self.reader.files = {"Dicom": [], "Stl": [], "Vtk": []}

    def input_files(self, files):
        self.reader.files["Stl"] = files

    def load(self):
        for file_path in self.reader.files["Stl"]:
            self.read(file_path)

    def read(self, path):
        self.reader.meshes += [read_stl(path)]
