"""Isosurface extraction (marching tetrahedra) on the device.

Port of medicalimageanalysis_tpu/ops/marching_cubes.py. Each cube of the
lattice splits into six tetrahedra around its main diagonal; a crossing
lies on a tetrahedron edge, linearly interpolated.

- 0/1 masks at iso 0.5 (every ROI call) take the table path on the
  mask's device: every crossing is an exact edge midpoint, so a cube's
  triangles are a function of its 8-bit corner pattern alone. The
  pattern comes from eight shifted slices, the active cubes from
  ``torch.nonzero``, the triangles from a gather of the half-unit table
  (``repeat_interleave`` over the per-pattern counts), and the weld from
  ``torch.unique`` over packed int64 keys ``x | y << 16 | z << 32`` in
  doubled units: integer work in ``np.unique``'s sorted-key order, so
  points and faces are bit-equal to the JAX package's host table path
  and to its native twin.
- Other volumes and isovalues take the float path: the active cubes,
  :func:`_emit_triangles` on them, then a weld by ``TriMesh.clean``.

The table is generated once by running :func:`_emit_triangles` on a
volume holding each of the 256 patterns in its own cube, as the JAX
package does, so the two paths agree by construction.
:func:`marching_cubes_host` is the host table path on the port's native
library (the JAX package's C++ twin), the reference the device path is
held to on the card. The JAX package's choice between host and device
from a measured transfer rate (``_prefer_device_mc``) is not carried
over: on the card the mask is already on the device.
"""

from __future__ import annotations

from functools import cache

import numpy as np
import torch
import torch.nn.functional as F

from ..device import default_device
from ..utils.mesh.trimesh import TriMesh
from . import geometry as geo

__all__ = ["marching_cubes_host", "marching_cubes_mask", "mask_to_mesh"]

# cube corners (x, y, z) offsets
_CUBE_OFFSETS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], dtype=np.int64)

# 6-tetrahedra decomposition sharing the main diagonal c0-c6
_TET_CORNERS = np.array([
    [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
    [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6],
], dtype=np.int64)

# tet edges by local corner pairs
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                      dtype=np.int64)

# case -> up to 2 triangles of edge ids (-1 = unused)
_TET_TRI_TABLE = np.array([
    [[-1, -1, -1], [-1, -1, -1]],   # 0000
    [[0, 1, 2], [-1, -1, -1]],      # 0001 inside {0}
    [[0, 3, 4], [-1, -1, -1]],      # 0010 inside {1}
    [[1, 3, 4], [1, 4, 2]],         # 0011 inside {0,1}
    [[1, 3, 5], [-1, -1, -1]],      # 0100 inside {2}
    [[0, 3, 5], [0, 5, 2]],         # 0101 inside {0,2}
    [[0, 1, 5], [0, 5, 4]],         # 0110 inside {1,2}
    [[2, 4, 5], [-1, -1, -1]],      # 0111 inside {0,1,2}
    [[2, 4, 5], [-1, -1, -1]],      # 1000 inside {3}
    [[0, 4, 5], [0, 5, 1]],         # 1001 inside {0,3}
    [[0, 2, 5], [0, 5, 3]],         # 1010 inside {1,3}
    [[1, 3, 5], [-1, -1, -1]],      # 1011 inside {0,1,3}
    [[1, 2, 4], [1, 4, 3]],         # 1100 inside {2,3}
    [[0, 3, 4], [-1, -1, -1]],      # 1101 inside {0,2,3}
    [[0, 1, 2], [-1, -1, -1]],      # 1110 inside {1,2,3}
    [[-1, -1, -1], [-1, -1, -1]],   # 1111
], dtype=np.int64)


def _empty():
    return TriMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int32))


def _corners(vol):
    """The eight corner views of every cube of ``vol`` (Z, Y, X), in
    ``_CUBE_OFFSETS`` order."""
    Z, Y, X = vol.shape
    return [vol[dz:dz + Z - 1, dy:dy + Y - 1, dx:dx + X - 1]
            for dx, dy, dz in _CUBE_OFFSETS]


def _active_cubes(vol, iso):
    """(Z-1, Y-1, X-1) bool: cubes whose corners lie on both sides of
    ``iso``."""
    corners = _corners(vol > iso)
    acc_any = corners[0].clone()
    acc_all = corners[0].clone()
    for c in corners[1:]:
        acc_any |= c
        acc_all &= c
    return acc_any & ~acc_all


def _emit_triangles(vol, cube_zyx, iso):
    """cube_zyx: (K, 3) int64 cube origins (z, y, x). Returns (K, 12, 3,
    3) float32 vertex positions in pixel (x, y, z) coordinates and the
    (K, 12) validity of each triangle slot (6 tetrahedra x 2)."""
    dev = vol.device
    K = cube_zyx.shape[0]
    cz, cy, cx = cube_zyx[:, 0], cube_zyx[:, 1], cube_zyx[:, 2]
    vals8 = torch.stack([vol[cz + int(dz), cy + int(dy), cx + int(dx)]
                         for dx, dy, dz in _CUBE_OFFSETS], dim=1)  # (K, 8)
    pos8 = torch.stack([torch.stack([cx + int(dx), cy + int(dy),
                                     cz + int(dz)], dim=-1)
                        for dx, dy, dz in _CUBE_OFFSETS],
                       dim=1).to(torch.float32)                  # (K, 8, 3)
    tri_table = torch.as_tensor(_TET_TRI_TABLE, device=dev)
    ea = torch.as_tensor(_TET_EDGES[:, 0], device=dev)
    eb = torch.as_tensor(_TET_EDGES[:, 1], device=dev)
    rows = torch.arange(K, device=dev)[:, None, None]
    all_tris, all_valid = [], []
    for t in range(6):
        corners = torch.as_tensor(_TET_CORNERS[t], device=dev)
        v4 = vals8[:, corners]                                   # (K, 4)
        p4 = pos8[:, corners]                                    # (K, 4, 3)
        bits = (v4 > iso).to(torch.int64)
        case = bits[:, 0] + 2 * bits[:, 1] + 4 * bits[:, 2] + 8 * bits[:, 3]

        # edge crossing positions for all 6 tet edges
        va = v4[:, ea]                                           # (K, 6)
        vb = v4[:, eb]
        denom = torch.where(vb - va != 0, vb - va, 1.0)
        tt = torch.clamp((iso - va) / denom, 0.0, 1.0)[..., None]
        pa = p4[:, ea]                                           # (K, 6, 3)
        pb = p4[:, eb]
        epos = pa + tt * (pb - pa)

        tris = tri_table[case]                                   # (K, 2, 3)
        valid = tris[:, :, 0] >= 0
        tri_pos = epos[rows, tris.clamp(min=0)]                  # (K, 2, 3, 3)

        # orient consistently: normals point away from the inside corners
        w = bits.to(torch.float32)
        inside_centroid = (w[:, :, None] * p4).sum(dim=1) \
            / torch.clamp(w.sum(dim=1), min=1.0)[:, None]        # (K, 3)
        v0, v1, v2 = tri_pos[:, :, 0], tri_pos[:, :, 1], tri_pos[:, :, 2]
        nrm = torch.linalg.cross(v1 - v0, v2 - v0)
        tri_center = (v0 + v1 + v2) / 3.0
        outward = (nrm * (tri_center - inside_centroid[:, None, :])).sum(-1)
        flip = outward < 0
        tri_pos = torch.where(flip[:, :, None, None], tri_pos[:, :, [0, 2, 1]],
                              tri_pos)
        all_tris.append(tri_pos)
        all_valid.append(valid)
    return torch.cat(all_tris, dim=1), torch.cat(all_valid, dim=1)


@cache
def _binary_tables():
    """(flat_tris (T, 3, 3) int16, starts (256,) int64, ntris (256,)
    int64): every pattern's triangles relative to the cube origin in
    doubled (half-unit) coordinates, from :func:`_emit_triangles` on a
    volume holding each of the 256 patterns in its own 2 x 2 x 2 block."""
    vol = np.zeros((2, 2, 4 * 256), np.float32)
    for p in range(256):
        for ci, (dx, dy, dz) in enumerate(_CUBE_OFFSETS):
            vol[dz, dy, 4 * p + dx] = (p >> ci) & 1
    cube = np.stack([np.zeros(256, np.int64), np.zeros(256, np.int64),
                     np.arange(256, dtype=np.int64) * 4], axis=1)
    tris, valid = _emit_triangles(torch.from_numpy(vol),
                                  torch.from_numpy(cube), 0.5)
    tris = tris.numpy().copy()                 # (256, 12, 3, 3) (x, y, z)
    valid = valid.numpy()
    tris[..., 0] -= (np.arange(256) * 4)[:, None, None]
    flat = np.round(tris[valid] * 2).astype(np.int16)
    ntris = valid.sum(axis=1).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(ntris)])[:256]
    return flat, starts, ntris


@cache
def _device_tables(device):
    flat, starts, ntris = _binary_tables()
    return (torch.as_tensor(flat, device=device),
            torch.as_tensor(starts, device=device),
            torch.as_tensor(ntris, device=device))


def _binary_mc_device(u8, pad):
    """The table path on ``u8``'s device: (Z, Y, X) uint8 0/1 tensor ->
    TriMesh in pixel coordinates."""
    flat_tab, starts, ntris_tab = _device_tables(u8.device)
    v = F.pad(u8, (1, 1, 1, 1, 1, 1)) if pad else u8
    if min(v.shape) < 2:
        return _empty()
    pat = torch.zeros([s - 1 for s in v.shape], dtype=torch.uint8,
                      device=v.device)
    for ci, corner in enumerate(_corners(v)):
        pat |= corner << ci
    pat = pat.reshape(-1)
    lin = torch.nonzero((pat != 0) & (pat != 255)).squeeze(1)  # C order
    if lin.numel() == 0:
        return _empty()
    p = pat[lin].to(torch.int64)
    tn = ntris_tab[p]
    cum = torch.cumsum(tn, 0)
    M = int(cum[-1])
    if M == 0:
        return _empty()
    cube_idx = torch.repeat_interleave(tn, output_size=M)
    within = torch.arange(M, device=v.device) - (cum - tn)[cube_idx]
    tri = flat_tab[starts[p][cube_idx] + within].to(torch.int64)  # (M, 3, 3)
    Y1, X1 = v.shape[1] - 1, v.shape[2] - 1
    base2 = torch.stack([lin % X1, (lin // X1) % Y1, lin // (X1 * Y1)],
                        dim=1) * 2                       # doubled (x, y, z)
    q = tri + base2[cube_idx][:, None, :]
    keys = q[..., 0] | (q[..., 1] << 16) | (q[..., 2] << 32)
    uniq, inverse = torch.unique(keys.reshape(-1), sorted=True,
                                 return_inverse=True)
    points = torch.stack([uniq & 0xFFFF, (uniq >> 16) & 0xFFFF, uniq >> 32],
                         dim=1).to(torch.float32) * 0.5
    faces = inverse.reshape(-1, 3).to(torch.int32)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    if pad:
        points = points - 1.0
    return TriMesh(points.cpu().numpy(), faces[good].cpu().numpy())


def _float_mc(vol, iso, pad):
    """The float path: (Z, Y, X) float32 tensor -> welded TriMesh."""
    if pad:
        vol = F.pad(vol, (1, 1, 1, 1, 1, 1))
    if min(vol.shape) < 2:
        return _empty()
    coords = torch.nonzero(_active_cubes(vol, iso))
    if coords.shape[0] == 0:
        return _empty()
    tris, valid = _emit_triangles(vol, coords, iso)
    flat = tris[valid]
    if flat.shape[0] == 0:
        return _empty()
    if pad:
        flat = flat - 1.0
    points = flat.reshape(-1, 3).cpu().numpy()
    faces = np.arange(points.shape[0], dtype=np.int32).reshape(-1, 3)
    return TriMesh(points, faces).clean(tolerance=1e-7)


def _is_binary(t):
    if t.dtype.is_floating_point or t.dtype.is_complex or t.numel() == 0:
        return False
    return bool(t.min() >= 0) and bool(t.max() <= 1)


def marching_cubes_mask(mask, iso=0.5, pad=True, device=None):
    """Mask or volume (Z, Y, X) -> TriMesh in *pixel* coordinates.

    With pad=True the volume is zero-padded by one voxel so surfaces
    close at the borders; coordinates are shifted back. A bool or integer
    0/1 mask at iso 0.5 takes the table path, anything else the float
    path (float32 values). Runs on ``device`` (default: a tensor's own
    device, else ``default_device()``)."""
    if not isinstance(mask, torch.Tensor):
        mask = torch.as_tensor(np.asarray(mask),
                               device=device or default_device())
    t = mask if device is None else mask.to(device)
    padded = tuple(int(s) + (2 if pad else 0) for s in t.shape)
    if iso == 0.5 and max(padded) < 16000 and _is_binary(t):
        return _binary_mc_device(t.to(torch.uint8).contiguous(), pad)
    return _float_mc(t.to(torch.float32), float(iso), pad)


def marching_cubes_host(mask, pad=True):
    """The table path on the host: 0/1 mask (Z, Y, X) -> TriMesh, by the
    port's native library (a copy of the JAX package's C++ twin) on the
    same table. Raises when the library is unavailable."""
    from ..native import marching_cubes_native

    flat, starts, ntris = _binary_tables()
    res = marching_cubes_native(np.ascontiguousarray(mask, dtype=np.uint8),
                                flat, starts, ntris, pad=pad)
    if res is None:
        raise RuntimeError("marching_cubes_host: the native library "
                           "(native/dicomscan.cpp) is not available")
    points, faces = res
    if pad:
        points -= 1.0
    return TriMesh(points, faces)


def mask_to_mesh(mask, spacing, origin, matrix, iso=0.5, device=None):
    """Mask -> physical-space surface mesh using the image geometry."""
    mesh = marching_cubes_mask(mask, iso=iso, device=device)
    p2p = geo.pixel_to_position_matrix(matrix, spacing, origin)
    return mesh.transform(p2p, inplace=True)
