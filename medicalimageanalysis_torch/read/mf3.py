"""3MF (3D Manufacturing Format) reader and writer.

Port of medicalimageanalysis_tpu/read/mf3.py (reference read/mf3.py:
56-245), host Python: unzip the archive, parse the XML model (vertices
and triangles), resolve vertex colors from texture2dgroup UV lookups or
basematerials hex colors, decimate to ~50k points (reference mf3.py:215),
build the fake image through ModelToMask, and register an Image with a
mesh-only ROI, whose mask is the mesh voxelized on the card
(``Roi.compute_mask``). Texture colors need PIL; without it a textured
file raises an ImportError naming PIL, and every other file reads.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
import zipfile

import numpy as np

from ..config import config
from ..data import Data
from ..structure.image import Image
from ..utils.convert.contour import ModelToMask
from ..utils.creation import CreateImageFromMask
from ..utils.mesh.trimesh import TriMesh

__all__ = ["ThreeMfReader", "write_3mf"]


def write_3mf(path, mesh, vertex_colors=None, name="mesh",
              unit="millimeter"):
    """Write a TriMesh (or (points, faces)) as a 3MF archive (the
    reference only reads; 3D-printing hand-off needs the export).
    Vertex colors (N, 3) uint8 become a deduplicated basematerials
    palette with per-vertex p1/p2/p3 indices — exactly the layout
    ThreeMfReader resolves, so color round trips are lossless.
    ``mesh['colors']`` is used when ``vertex_colors`` is None."""
    if unit not in ("micron", "millimeter", "centimeter", "inch",
                    "foot", "meter"):
        raise ValueError(f"write_3mf: invalid unit {unit!r} (3MF core "
                         "spec enum)")
    if hasattr(mesh, "points"):
        points, faces = mesh.points, mesh.faces
        if vertex_colors is None:
            vertex_colors = mesh.point_data.get("colors")
    else:
        points, faces = mesh
    points = np.asarray(points, np.float64).reshape(-1, 3)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    if faces.size and (faces.min() < 0 or faces.max() >= len(points)):
        raise ValueError("write_3mf: face index out of range")

    parts = ['<?xml version="1.0" encoding="UTF-8"?>\n'
             f'<model unit="{unit}" xml:lang="en-US" '
             'xmlns="http://schemas.microsoft.com/3dmanufacturing/'
             'core/2015/02">\n <resources>\n']
    tri_props = [""] * len(faces)
    obj_props = ""
    if vertex_colors is not None:
        colors = np.asarray(vertex_colors, np.uint8).reshape(-1, 3)
        if len(colors) != len(points):
            raise ValueError("write_3mf: vertex_colors must pair with "
                             f"points, got {len(colors)} vs "
                             f"{len(points)}")
        palette, inverse = np.unique(colors, axis=0,
                                     return_inverse=True)
        parts.append('  <basematerials id="1">\n')
        for r, g, b in palette:
            parts.append(f'   <base name="c" displaycolor='
                         f'"#{r:02X}{g:02X}{b:02X}"/>\n')
        parts.append('  </basematerials>\n')
        p = inverse[faces]  # (T, 3) palette index per corner
        tri_props = [f' pid="1" p1="{a}" p2="{b}" p3="{c}"'
                     for a, b, c in p]
        obj_props = ' pid="1" pindex="0"'

    from xml.sax.saxutils import quoteattr
    parts.append(f'  <object id="2" name={quoteattr(str(name))} '
                 f'type="model"{obj_props}>\n   <mesh>\n'
                 '    <vertices>\n')
    parts.extend(f'     <vertex x="{x:.9g}" y="{y:.9g}" z="{z:.9g}"/>\n'
                 for x, y, z in points)
    parts.append('    </vertices>\n    <triangles>\n')
    parts.extend(
        f'     <triangle v1="{f[0]}" v2="{f[1]}" v3="{f[2]}"{tp}/>\n'
        for f, tp in zip(faces, tri_props))
    parts.append('    </triangles>\n   </mesh>\n  </object>\n'
                 ' </resources>\n <build>\n  <item objectid="2"/>\n'
                 ' </build>\n</model>\n')
    model_xml = "".join(parts).encode()

    content_types = (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
        'content-types">\n'
        ' <Default Extension="rels" ContentType="application/vnd.'
        'openxmlformats-package.relationships+xml"/>\n'
        ' <Default Extension="model" ContentType="application/vnd.'
        'ms-package.3dmanufacturing-3dmodel+xml"/>\n</Types>\n')
    rels = (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<Relationships xmlns="http://schemas.openxmlformats.org/'
        'package/2006/relationships">\n'
        ' <Relationship Target="/3D/3dmodel.model" Id="rel-1" '
        'Type="http://schemas.microsoft.com/3dmanufacturing/2013/01/'
        '3dmodel"/>\n</Relationships>\n')

    with zipfile.ZipFile(str(path), "w",
                         compression=zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", content_types)
        z.writestr("_rels/.rels", rels)
        z.writestr("3D/3dmodel.model", model_xml)

_NS = {
    "3mf": "http://schemas.microsoft.com/3dmanufacturing/core/2015/02",
    "m": "http://schemas.microsoft.com/3dmanufacturing/material/2015/02",
}


def _hex_to_rgb(hex_color):
    h = hex_color.lstrip("#")
    return np.array([int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16)],
                    dtype=np.uint8)


class ThreeMfReader(object):
    def __init__(self, file, roi_name=None):
        self.file = file
        self.roi_name = roi_name

    def load(self):
        """Corrupt archives raise a clean ValueError naming the file
        (not BadZipFile/KeyError/ET.ParseError); a textured file without
        PIL raises ImportError."""
        try:
            return self._load()
        except (FileNotFoundError, ImportError):
            raise
        except Exception as e:
            raise ValueError(
                f"invalid 3MF file {str(self.file)!r}: "
                f"{type(e).__name__}: {e}") from e

    def _load(self):
        archive = zipfile.ZipFile(self.file, "r")
        root = ET.parse(archive.open("3D/3dmodel.model"))

        obj = root.findall("./3mf:resources/3mf:object", _NS)[0]

        vertex_list = np.array([
            [float(v.get("x")), float(v.get("y")), float(v.get("z"))]
            for v in obj.findall(".//3mf:vertex", _NS)], dtype=float)

        triangles = obj.findall(".//3mf:triangle", _NS)
        n_tris = len(triangles)
        faces = np.empty((n_tris, 3), dtype=np.int32)
        vertex_colors = np.full((len(vertex_list), 3), 200, dtype=np.uint8)
        vertex_hit = np.zeros(len(vertex_list), dtype=bool)

        tex_group = root.find(".//m:texture2dgroup", _NS)
        # basematerials lives in the CORE namespace per the 3MF spec;
        # some producers emit it in the material-extension namespace —
        # accept both (explicit None checks: ET elements are falsy
        # when childless)
        basematerials = root.find(".//m:basematerials", _NS)
        if basematerials is None:
            basematerials = root.find(".//3mf:basematerials", _NS)

        if tex_group is not None:
            color_mode = "texture"
            group_id = tex_group.get("id")
            tex_el = root.find(".//m:texture2d", _NS)
            tex_path = tex_el.get("path").lstrip("/")
            try:
                from PIL import Image as PilImage
            except ImportError as e:
                raise ImportError(
                    f"{self.file!r} has texture colors, which need PIL "
                    "(Pillow) to decode; PIL is not installed") from e
            texture_img = PilImage.open(
                archive.open(tex_path)).convert("RGB")
            tex_w, tex_h = texture_img.size
            tex_pixels = np.array(texture_img)
            uv_list = [(float(tc.get("u")), float(tc.get("v")))
                       for tc in tex_group.findall("m:tex2coord", _NS)]

            def get_color(tri, vi, pkey):
                pindex = tri.get(pkey)
                if pindex is None:
                    return None
                u, v = uv_list[int(pindex)]
                px = int(np.clip(u, 0, 1) * (tex_w - 1))
                py = int(np.clip(1.0 - v, 0, 1) * (tex_h - 1))
                return tex_pixels[py, px]

        elif basematerials is not None:
            color_mode = "basematerials"
            color_map = {}
            for ns in ("m", "3mf"):
                for bm in root.findall(f".//{ns}:basematerials", _NS):
                    gid = bm.get("id")
                    for idx, base in enumerate(
                            bm.findall(f"{ns}:base", _NS)):
                        hex_color = base.get("displaycolor", "#C8C8C8")
                        color_map[(gid, idx)] = _hex_to_rgb(hex_color)

            # object-level pid/pindex is the spec-mandated default
            # (3MF core 4.1); mesh-level attrs kept as a producer
            # fallback
            mesh_el = obj.find(".//3mf:mesh", _NS)
            default_pid = obj.get("pid")
            default_pindex = int(obj.get("pindex", "0"))
            if default_pid is None and mesh_el is not None:
                default_pid = mesh_el.get("pid")
                default_pindex = int(mesh_el.get("pindex",
                                                 str(default_pindex)))

            def get_color(tri, vi, pkey):
                pid = tri.get("pid", default_pid)
                if pid is None:
                    return None
                pindex = int(tri.get(pkey, default_pindex))
                return color_map.get((pid, pindex))

        else:
            color_mode = None
            group_id = None

        for ii, tri in enumerate(triangles):
            v1, v2, v3 = (int(tri.get("v1")), int(tri.get("v2")),
                          int(tri.get("v3")))
            faces[ii] = [v1, v2, v3]
            if color_mode is None:
                continue
            if color_mode == "texture" and tri.get("pid") != group_id:
                continue
            for vi, pkey in zip([v1, v2, v3], ["p1", "p2", "p3"]):
                if not vertex_hit[vi]:
                    rgb = get_color(tri, vi, pkey)
                    if rgb is not None:
                        vertex_colors[vi] = rgb
                        vertex_hit[vi] = True

        mesh = TriMesh(vertex_list, faces)
        mesh["colors"] = vertex_colors

        target = config.mesh_decimate_target_points
        if mesh.number_of_points > target:
            decimate_mesh = mesh.decimate(1 - target / mesh.number_of_points)
        else:
            decimate_mesh = mesh

        image_name = f"CT {len(Data.image_list) + 1:02d}"

        model_to_mask = ModelToMask([decimate_mesh])
        mask = model_to_mask.mask

        new_image = CreateImageFromMask(mask, model_to_mask.origin,
                                        model_to_mask.spacing, image_name)
        Data.image[image_name] = Image(new_image)
        Data.image_list.append(image_name)

        Data.image[image_name].create_roi(name=self.roi_name,
                                          visible=False,
                                          filepath=self.file)
        Data.image[image_name].rois[self.roi_name].add_mesh(decimate_mesh)
        Data.image[image_name].rois[self.roi_name].color = [128, 128, 128]
        Data.image[image_name].rois[self.roi_name].multi_color = True

        Data.match_rois()
        self.mesh = decimate_mesh
        self.image_name = image_name
