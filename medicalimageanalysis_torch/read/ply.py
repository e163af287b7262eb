"""PLY (Stanford polygon) mesh IO + PlyReader.

Port of medicalimageanalysis_tpu/read/ply.py: the ASCII and binary
(little and big endian) PLY codec, host numpy and ``struct``. The
reference's generic-mesh path (`pv.read`, reference read/stl.py:21-36)
would accept .ply but is dormant there.

Supported: vertex x/y/z (any float/int type), optional per-vertex
red/green/blue[/alpha] colors (uchar or float 0..1), face
`property list <count> <index> vertex_ind(ex|ices)` with arbitrary
count/index integer types; polygons are fan-triangulated. Unknown
vertex properties are skipped by stride; unknown elements are skipped
whole. Writer emits binary little-endian (or ASCII) with optional
lossless uchar colors from ``mesh.point_data['colors']`` (the same
contract as the 3MF writer, read/mf3.py).
"""

from __future__ import annotations

import struct as _struct

import numpy as np

from ..utils.mesh.trimesh import TriMesh

__all__ = ["read_ply", "write_ply", "PlyReader"]

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path):
    """Read a .ply file -> TriMesh (corrupt files raise ValueError
    naming the file, matching the repo-wide reader contract)."""
    try:
        return _read_ply(path)
    except FileNotFoundError:
        raise
    except (ValueError, IndexError, KeyError, TypeError, OverflowError,
            _struct.error) as e:
        raise ValueError(
            f"invalid PLY file {str(path)!r}: "
            f"{type(e).__name__}: {e}") from e


def _parse_header(data):
    """Parse the header -> (fmt, elements, body_offset).

    elements: list of (name, count, props) where props is a list of
    ('scalar', name, dtype) or ('list', name, count_dtype, item_dtype).
    """
    end = data.find(b"end_header")
    if not data.startswith(b"ply") or end < 0:
        raise ValueError("not a PLY file (missing ply/end_header)")
    nl = data.find(b"\n", end)
    if nl < 0:
        raise ValueError("unterminated header")
    body_offset = nl + 1

    fmt = None
    elements = []
    for raw in data[:end].decode("latin-1").splitlines():
        parts = raw.strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                raise ValueError("property before any element")
            props = elements[-1][2]
            if parts[1] == "list":
                props.append(("list", parts[4],
                              _TYPES[parts[2]], _TYPES[parts[3]]))
            else:
                props.append(("scalar", parts[2], _TYPES[parts[1]]))
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format {fmt!r}")
    return fmt, elements, body_offset


def _read_ply(path):
    with open(str(path), "rb") as f:
        data = f.read()
    fmt, elements, off = _parse_header(data)

    if fmt == "ascii":
        vertex, colors, faces = _read_body_ascii(data[off:], elements)
    else:
        bo = "<" if fmt == "binary_little_endian" else ">"
        vertex, colors, faces = _read_body_binary(data, off, elements, bo)

    if vertex is None:
        raise ValueError("no vertex element")
    if faces is None:
        faces = np.zeros((0, 3), dtype=np.int32)
    if faces.size and (faces.min() < 0
                       or faces.max() >= vertex.shape[0]):
        raise ValueError("face index out of range")
    mesh = TriMesh(vertex, faces)
    if colors is not None:
        mesh["colors"] = colors
    return mesh


def _vertex_columns(props):
    """Map wanted vertex property names -> column index among scalars."""
    cols = {}
    idx = 0
    for p in props:
        if p[0] != "scalar":
            raise ValueError("list property on vertex element")
        cols[p[1]] = idx
        idx += 1
    for want in ("x", "y", "z"):
        if want not in cols:
            raise ValueError(f"vertex element missing property {want!r}")
    return cols


def _colors_from(cols, table, props):
    if not all(c in cols for c in ("red", "green", "blue")):
        return None
    rgb = np.stack([table[:, cols[c]] for c in ("red", "green", "blue")],
                   axis=1)
    dt = {p[1]: p[2] for p in props}
    if dt["red"].startswith("f"):
        rgb = np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5
    return rgb.astype(np.uint8)


def _fan(faces_list):
    out = []
    for poly in faces_list:
        if len(poly) < 3:
            continue
        for k in range(1, len(poly) - 1):
            out.append((poly[0], poly[k], poly[k + 1]))
    return (np.asarray(out, dtype=np.int32) if out
            else np.zeros((0, 3), dtype=np.int32))


def _read_body_ascii(body, elements):
    tokens = body.split()
    pos = 0
    vertex = colors = faces = None
    for name, count, props in elements:
        if name == "vertex":
            ncol = len(props)
            flat = np.array(tokens[pos:pos + count * ncol], dtype=np.float64)
            if flat.size != count * ncol:
                raise ValueError("truncated vertex data")
            table = flat.reshape(count, ncol)
            pos += count * ncol
            cols = _vertex_columns(props)
            vertex = np.stack([table[:, cols["x"]], table[:, cols["y"]],
                               table[:, cols["z"]]], axis=1)
            colors = _colors_from(cols, table, props)
        elif name == "face":
            polys = []
            for _ in range(count):
                row = []
                for p in props:
                    if p[0] == "list":
                        n = int(tokens[pos]); pos += 1
                        vals = [int(t) for t in tokens[pos:pos + n]]
                        if len(vals) != n:
                            raise ValueError("truncated face list")
                        pos += n
                        if p[1] in ("vertex_indices", "vertex_index"):
                            row = vals
                    else:
                        pos += 1
                polys.append(row)
            faces = _fan(polys)
        else:
            # skip unknown element (ascii: one token per scalar,
            # lists need per-row reads)
            for _ in range(count):
                for p in props:
                    if p[0] == "list":
                        n = int(tokens[pos]); pos += 1 + n
                    else:
                        pos += 1
    return vertex, colors, faces


def _read_body_binary(data, off, elements, bo):
    vertex = colors = faces = None
    for name, count, props in elements:
        all_scalar = all(p[0] == "scalar" for p in props)
        if all_scalar:
            dt = np.dtype([(f"c{i}", bo + p[2])
                           for i, p in enumerate(props)])
            table_rec = np.frombuffer(data, dtype=dt, count=count,
                                      offset=off)
            if table_rec.shape[0] != count:
                raise ValueError(f"truncated element {name!r}")
            off += dt.itemsize * count
            if name == "vertex":
                table = np.stack(
                    [table_rec[f"c{i}"].astype(np.float64)
                     for i in range(len(props))], axis=1)
                cols = _vertex_columns(props)
                vertex = np.stack([table[:, cols["x"]],
                                   table[:, cols["y"]],
                                   table[:, cols["z"]]], axis=1)
                colors = _colors_from(cols, table, props)
            continue

        # element with list properties — walk rows
        polys = []
        uniform = None  # (n, row_bytes) fast path for single-list rows
        if (name == "face" and len(props) == 1 and props[0][0] == "list"
                and count > 0):
            cdt = np.dtype(bo + props[0][2])
            n0 = int(np.frombuffer(data, cdt, 1, off)[0])
            idt = np.dtype(bo + props[0][3])
            row = cdt.itemsize + n0 * idt.itemsize
            if off + row * count <= len(data):
                counts = np.frombuffer(
                    np.ascontiguousarray(
                        np.frombuffer(data, np.uint8, row * count, off)
                        .reshape(count, row)[:, :cdt.itemsize]),
                    dtype=cdt)
                if np.all(counts == n0):
                    uniform = (n0, row, cdt, idt)
        if uniform is not None:
            n0, row, cdt, idt = uniform
            body = np.frombuffer(data, np.uint8, row * count,
                                 off).reshape(count, row)
            idx = np.ascontiguousarray(
                body[:, cdt.itemsize:]).view(idt).reshape(count, n0)
            idx = idx.astype(np.int64)
            off += row * count
            if n0 == 3:
                faces = idx.astype(np.int32)
            else:
                faces = _fan([list(r) for r in idx])
            continue

        for _ in range(count):
            rowvals = []
            for p in props:
                if p[0] == "scalar":
                    off += np.dtype(p[2]).itemsize
                else:
                    cdt = np.dtype(bo + p[2])
                    n = int(np.frombuffer(data, cdt, 1, off)[0])
                    off += cdt.itemsize
                    idt = np.dtype(bo + p[3])
                    vals = np.frombuffer(data, idt, n, off)
                    if vals.shape[0] != n:
                        raise ValueError("truncated face list")
                    off += idt.itemsize * n
                    if p[1] in ("vertex_indices", "vertex_index"):
                        rowvals = [int(v) for v in vals]
            polys.append(rowvals)
        if name == "face":
            faces = _fan(polys)
    return vertex, colors, faces


def write_ply(path, mesh, binary=True):
    """Write a TriMesh as .ply; per-vertex colors from
    ``mesh.point_data['colors']`` (N,3) uint8 survive losslessly."""
    p = np.asarray(mesh.points, dtype=np.float64)
    f = np.asarray(mesh.faces, dtype=np.int32).reshape(-1, 3)
    getc = getattr(mesh, "vertex_colors_uint8", lambda: None)
    colors = getc()

    head = ["ply",
            "format binary_little_endian 1.0" if binary
            else "format ascii 1.0",
            "comment medicalimageanalysis_torch",
            f"element vertex {p.shape[0]}",
            "property float x", "property float y", "property float z"]
    if colors is not None:
        head += ["property uchar red", "property uchar green",
                 "property uchar blue"]
    head += [f"element face {f.shape[0]}",
             "property list uchar int vertex_indices", "end_header"]

    if binary:
        with open(str(path), "wb") as fh:
            fh.write(("\n".join(head) + "\n").encode("ascii"))
            if colors is not None:
                vdt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
                rec = np.empty(p.shape[0], dtype=vdt)
                rec["xyz"] = p.astype("<f4")
                rec["rgb"] = colors
            else:
                rec = p.astype("<f4")
            fh.write(rec.tobytes())
            fdt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
            frec = np.empty(f.shape[0], dtype=fdt)
            frec["n"] = 3
            frec["idx"] = f
            fh.write(frec.tobytes())
    else:
        with open(str(path), "w") as fh:
            fh.write("\n".join(head) + "\n")
            for i in range(p.shape[0]):
                # .9g round-trips float32 exactly — same fidelity as
                # the binary path's f4 records
                line = f"{p[i,0]:.9g} {p[i,1]:.9g} {p[i,2]:.9g}"
                if colors is not None:
                    line += f" {colors[i,0]} {colors[i,1]} {colors[i,2]}"
                fh.write(line + "\n")
            for i in range(f.shape[0]):
                fh.write(f"3 {f[i,0]} {f[i,1]} {f[i,2]}\n")


class PlyReader(object):
    """Appends meshes onto a parent reader (same contract as StlReader,
    read/stl.py:79-99)."""

    def __init__(self, reader):
        self.reader = reader
        if not hasattr(self.reader, "meshes"):
            self.reader.meshes = []
        if getattr(self.reader, "files", None) is None:
            self.reader.files = {"Dicom": [], "Stl": [], "Vtk": [],
                                 "Ply": [], "Obj": []}
        self.reader.files.setdefault("Ply", [])

    def input_files(self, files):
        self.reader.files["Ply"] = files

    def load(self):
        for file_path in self.reader.files["Ply"]:
            self.read(file_path)

    def read(self, path):
        self.reader.meshes += [read_ply(path)]
