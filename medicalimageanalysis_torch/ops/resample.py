"""Affine volume resampling.

Port of medicalimageanalysis_tpu/ops/resample.py, the whole module:

- :func:`_trilinear` — the plain trilinear gather (the warp kernel's twin);
- :func:`trilinear_gather`, :func:`map_coordinates_trilinear`,
  :func:`make_trilinear_sampler` — trilinear samples at points, over the
  warp kernel's ``coords`` mode (the sampler with its coordinate VJP);
- :func:`affine_resample` — one 4x4 pixel matrix maps output voxel ->
  input voxel, run by the CUDA warp kernel in ``affine`` mode on the card;
- :func:`compose_pixel_matrix`, :func:`_interp_matrix` — numpy builders;
- :func:`separable_resample` — axis-aligned trilinear resample as three
  full-float32 matrix contractions (the demons pyramid);
- :func:`reslice_transform` — the vtkImageReslice(AutoCrop) equivalent
  behind ``Rigid.create_image``, with the opt-in shear-warp lane
  (``config.use_shear_warp``: :func:`affine_resample_shear`, three passes
  of the lane_interp kernel); :func:`reslice_tensor`, the same reslice
  left on the device (the Rigid view's overlay);
- :func:`reslice_rotation` — the off-axis display reslice
  (``Image.update_rotation``);
- :func:`_axis_align_input` — the signed axis permutation of a large
  rotation, for the oblique entry ops/warp.affine_warp_oblique.

``affine_resample`` keeps the one-pass ``affine`` mode for every matrix:
the TPU's tz=16 / axis-align / oblique dispatch existed for its slab
windows, and on the card the oblique route pays a sheared copy of the
volume on top of the same sample (PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config
from ..device import default_device, full_float32
from ..telemetry import trace
from . import geometry as geo
from .lane_interp import shear_x
from .warp import affine_warp_fused, make_warp_sampler, warp_coords_plain

__all__ = ["affine_resample", "affine_resample_shear", "compose_pixel_matrix",
           "make_trilinear_sampler", "map_coordinates_trilinear",
           "reslice_rotation", "reslice_tensor", "reslice_transform",
           "separable_resample", "trilinear_gather"]


def _trilinear(vol, coords_xyz, background):
    """vol: (Z, Y, X) f32 tensor; coords_xyz: (..., 3) in pixel (x, y, z)
    order -> (...) samples, background outside."""
    return warp_coords_plain(vol[None], coords_xyz[..., 2],
                             coords_xyz[..., 1], coords_xyz[..., 0],
                             background)[0][0]


def _points(coords):
    """(..., 3) f32 tensor -> its (x, y, z) columns as (1, 1, N) tensors
    (the ``coords`` operator's 3-d layout)."""
    flat = coords.reshape(1, 1, -1, 3)
    return flat[..., 0], flat[..., 1], flat[..., 2]


def trilinear_gather(volume, coords_xyz, background=None):
    """Trilinear sample of ``volume`` (Z, Y, X) at fractional pixel
    coordinates ``coords_xyz`` (..., 3) in (x, y, z) order -> (...)
    float32, ``background`` (default the config fill, -3001) outside.
    A tensor volume stays on its device; anything else goes to
    ``default_device()``. One ``coords`` launch on the card."""
    if background is None:
        background = config.background_fill
    device = volume.device if isinstance(volume, torch.Tensor) \
        else default_device()
    vol = torch.as_tensor(volume, device=device).to(torch.float32)
    coords = torch.as_tensor(coords_xyz, dtype=torch.float32,
                             device=device)
    cx, cy, cz = (c.contiguous() for c in _points(coords))
    out = torch.ops.mia_torch.warp_coords(vol.contiguous()[None], cz, cy,
                                          cx, float(background), False)[0]
    return out.reshape(coords.shape[:-1])


def map_coordinates_trilinear(volume, coords_zyx, background=0.0):
    """scipy.ndimage.map_coordinates(order=1) equivalent: ``coords_zyx``
    (3, ...) in (z, y, x) order -> (...) float32 (DVF mesh warping)."""
    c = torch.as_tensor(coords_zyx, dtype=torch.float32)
    return trilinear_gather(volume, torch.stack([c[2], c[1], c[0]], -1),
                            background)


def make_trilinear_sampler(vol, background=0.0):
    """Differentiable sampler ``sample(coords) -> out`` over ``vol``
    (Z, Y, X), coords (..., 3) in (x, y, z) order, with the analytic
    coordinate VJP the ``coords`` launch computes in the forward pass
    (ops/warp.make_warp_sampler)."""
    if not isinstance(vol, torch.Tensor):
        vol = torch.as_tensor(vol, device=default_device())
    sample_zyx = make_warp_sampler(vol, background)

    def sample(coords):
        cx, cy, cz = _points(coords)
        return sample_zyx(cz, cy, cx).reshape(coords.shape[:-1])

    return sample


def affine_resample(volume, pixel_matrix, out_shape, background=None,
                    device=None):
    """Resample through a single 4x4 *pixel-to-pixel* matrix.

    ``pixel_matrix`` maps output pixel (x, y, z, 1) -> input pixel
    (x, y, z); compose it with :func:`compose_pixel_matrix`. ``volume``
    (Z, Y, X) moves to ``device`` (default: where it already is) as
    float32; returns the (Zo, Yo, Xo) float32 tensor there.
    """
    if background is None:
        background = config.background_fill
    vol = torch.as_tensor(volume)
    if device is not None:
        vol = vol.to(device)
    return affine_warp_fused(vol, np.asarray(pixel_matrix, np.float32),
                             float(background), out_shape)


def compose_pixel_matrix(in_matrix, in_spacing, in_origin,
                         out_matrix, out_spacing, out_origin,
                         phys_transform=None):
    """Build the output-pixel -> input-pixel 4x4.

    A = P2Pix_in @ T_phys @ Pix2P_out, where T_phys maps output physical
    points into input physical space (identity when both grids live in
    the same frame of reference).
    """
    pix2p_out = geo.pixel_to_position_matrix(out_matrix, out_spacing,
                                             out_origin).astype(np.float64)
    p2pix_in = geo.position_to_pixel_matrix(in_matrix, in_spacing,
                                            in_origin).astype(np.float64)
    if phys_transform is None:
        return (p2pix_in @ pix2p_out).astype(np.float32)
    return (p2pix_in @ np.asarray(phys_transform, dtype=np.float64)
            @ pix2p_out).astype(np.float32)


def _interp_matrix(n_out, n_in, scale, offset=0.0, dtype=np.float32):
    """(n_out, n_in) row-stochastic linear interpolation matrix.

    Row i has weight (1-f) at floor(i*scale+offset) and f at +1 — a dense
    matmul replaces the gather for axis-aligned resampling.
    """
    src = np.arange(n_out, dtype=np.float64) * scale + offset
    src = np.clip(src, 0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (src - lo).astype(np.float64)
    m = np.zeros((n_out, n_in), dtype=np.float64)
    m[np.arange(n_out), lo] += 1 - f
    m[np.arange(n_out), hi] += f
    return m.astype(dtype)


@full_float32()
def _separable_apply(vol, mz, my, mx):
    out = torch.einsum("ij,jyx->iyx", mz, vol)
    out = torch.einsum("kj,zjx->zkx", my, out)
    return torch.einsum("lj,zyj->zyl", mx, out)


def separable_resample(volume, out_shape):
    """Axis-aligned trilinear resample as three matrix contractions, at
    the shape ratios (the JAX package's optional spacing ratios have no
    caller yet). volume (Z, Y, X) array or tensor -> float32 tensor on
    its device (the CPU for an array).
    """
    vol = torch.as_tensor(volume).to(torch.float32)
    mz, my, mx = (torch.as_tensor(_interp_matrix(int(o), i, i / int(o)),
                                  device=vol.device)
                  for o, i in zip(out_shape, vol.shape))
    return _separable_apply(vol, mz, my, mx)


def reslice_grid(vol_shape, vol_matrix, vol_spacing, vol_origin,
                 phys_transform, out_spacing):
    """Output grid of :func:`reslice_transform`: (pixel matrix A,
    out_shape (Z, Y, X), origin lo, dims (x, y, z))."""
    Z, Y, X = vol_shape
    T = np.asarray(phys_transform, dtype=np.float64)
    out_spacing = np.asarray(out_spacing, dtype=np.float64)
    pix2p = geo.pixel_to_position_matrix(vol_matrix, vol_spacing,
                                         vol_origin)
    corners_pix = np.array([[x, y, z] for z in (0, Z - 1)
                            for y in (0, Y - 1) for x in (0, X - 1)],
                           dtype=np.float64)
    corners_phys = geo.apply_homogeneous(corners_pix, pix2p)
    out_corners = geo.apply_homogeneous(corners_phys, np.linalg.inv(T))
    lo = out_corners.min(axis=0)
    hi = out_corners.max(axis=0)
    out_dims = np.maximum(
        np.round((hi - lo) / out_spacing).astype(int) + 1, 1)
    A = compose_pixel_matrix(vol_matrix, vol_spacing, vol_origin,
                             np.eye(3), out_spacing, lo,
                             phys_transform=T)
    out_shape = (int(out_dims[2]), int(out_dims[1]), int(out_dims[0]))
    return A, out_shape, lo, out_dims


def reslice_tensor(volume, vol_matrix, vol_spacing, vol_origin,
                   phys_transform, out_spacing, background=None,
                   device=None):
    """:func:`reslice_transform` with the array left where the warp wrote
    it: dict(array (Z,Y,X) float32 tensor on ``device``, origin, spacing,
    dimensions). The Rigid view keeps its overlay this way and brings
    down only the planes it shows."""
    if background is None:
        background = config.background_fill
    volume = np.asarray(volume)
    A, out_shape, lo, out_dims = reslice_grid(
        volume.shape, vol_matrix, vol_spacing, vol_origin, phys_transform,
        out_spacing)
    device = default_device() if device is None else device
    warp = affine_resample_shear if config.use_shear_warp \
        else affine_resample
    with trace("mia.resample.warp"):
        arr = warp(volume, A, out_shape, background, device=device)
    return {"array": arr, "origin": lo,
            "spacing": np.asarray(out_spacing, dtype=np.float64),
            "dimensions": np.asarray(out_dims)}


def reslice_transform(volume, vol_matrix, vol_spacing, vol_origin,
                      phys_transform, out_spacing, background=None,
                      device=None):
    """vtkImageReslice(AutoCrop) behavioral equivalent with an arbitrary
    physical reslice transform: the output grid has identity direction and
    ``out_spacing``; output point p samples the input volume at
    ``phys_transform @ p``; the output extent covers the
    inverse-transformed input bounding box. The sample runs on
    ``device`` (default: the card when present): the exact one-pass
    ``affine`` warp, or with ``config.use_shear_warp`` the three-pass
    shear-warp lane (:func:`affine_resample_shear`).

    Returns dict(array (Z,Y,X) float32 numpy, origin, spacing, dimensions).
    """
    out = reslice_tensor(volume, vol_matrix, vol_spacing, vol_origin,
                         phys_transform, out_spacing, background, device)
    with trace("mia.resample.out"):
        out["array"] = out["array"].cpu().numpy()
    return out


def rotation_grid(vol_shape, volume_matrix, spacing, origin,
                  display_matrix):
    """Output grid of :func:`reslice_rotation`: (pixel matrix A,
    out_shape (Z, Y, X), new_origin)."""
    spacing = np.asarray(spacing, dtype=np.float64)
    origin = np.asarray(origin, dtype=np.float64)
    vol_mat = np.asarray(volume_matrix, dtype=np.float64)
    R = np.asarray(display_matrix, dtype=np.float64)[:3, :3]
    # physical corners of the input volume (index space x, y, z extents)
    Z, Y, X = vol_shape
    pix2p = geo.pixel_to_position_matrix(vol_mat, spacing, origin)
    corners_pix = np.array([[x, y, z] for z in (0, Z - 1)
                            for y in (0, Y - 1) for x in (0, X - 1)],
                           dtype=np.float64)
    corners_phys = geo.apply_homogeneous(corners_pix, pix2p)
    # vtkImageReslice applies the *inverse* of the display rotation to
    # output points; equivalently output frame = R @ input physical
    rotated = corners_phys @ R.T
    lo = rotated.min(axis=0)
    hi = rotated.max(axis=0)
    out_dims = np.maximum(np.round((hi - lo) / spacing).astype(int) + 1, 1)
    # output grid: identity direction, spacing, origin at the bbox min (in
    # the rotated frame); output point p_out maps to input physical
    # R^-1 p_out
    T_phys = np.eye(4)
    T_phys[:3, :3] = R.T          # R^-1 for a pure rotation
    A = compose_pixel_matrix(vol_mat, spacing, origin, np.eye(3), spacing,
                             lo, phys_transform=T_phys)
    out_shape = (int(out_dims[2]), int(out_dims[1]), int(out_dims[0]))
    return A, out_shape, R.T @ lo


def reslice_rotation(volume, volume_matrix, spacing, origin, display_matrix,
                     background=None, device=None):
    """Behavioral equivalent of the reference's off-axis vtkImageReslice
    pipeline (reference structure/image.py:160-215): rotate the
    (direction-matrix'd) volume into an identity-direction output grid
    with the same spacing, auto-cropped to the rotated bounding box,
    linear interpolation, background fill. The sample runs on ``device``
    (default: the card when present), the ``affine`` warp.

    Returns (resliced array (Z, Y, X) float32 numpy, new_origin (3,): the
    bounding-box minimum in the *rotated* frame mapped back through the
    rotation, as the reference's ``transform.TransformPoint(new_origin)``).
    """
    if background is None:
        background = config.background_fill
    volume = np.asarray(volume)
    A, out_shape, new_origin = rotation_grid(
        volume.shape, volume_matrix, spacing, origin, display_matrix)
    device = default_device() if device is None else device
    out = affine_resample(volume, A, out_shape, background, device=device)
    return out.cpu().numpy(), new_origin


def _axis_align_input(A, vol_shape_zyx):
    """Signed input-axis permutation factor of a large rotation.

    Factor A = F o A2 where F is an exact transpose/flip of the INPUT
    volume (index relabeling, no resampling) and A2 = F^-1 o A. Returns
    (array_perm, flip_axes, A2) with ``resample(vol, A) ==
    resample(flip(transpose(vol, array_perm), flip_axes), A2)`` exactly,
    or None when the dominant entries do not form a permutation (fully
    oblique maps) or the factor is identity. The oblique entry
    (ops/warp.affine_warp_oblique) takes its relayout from it.
    """
    A = np.asarray(A, np.float64)
    R = A[:3, :3]
    rp = np.argmax(np.abs(R), axis=0)        # old input row per new axis
    if len(set(int(r) for r in rp)) != 3:
        return None
    s = np.sign(R[rp, np.arange(3)])
    s[s == 0] = 1.0
    if np.array_equal(rp, [0, 1, 2]) and np.all(s > 0):
        return None                           # already aligned
    A2 = np.eye(4)
    for ip in range(3):
        n_axis = vol_shape_zyx[2 - int(rp[ip])]
        A2[ip, :] = s[ip] * A[int(rp[ip]), :]
        if s[ip] < 0:
            A2[ip, 3] += n_axis - 1
    array_perm = tuple(2 - int(rp[2 - a]) for a in range(3))
    flip_axes = tuple(2 - ip for ip in range(3) if s[ip] < 0)
    return array_perm, flip_axes, A2


# ---------------------------------------------------------------------------
# the shear-warp lane (config.use_shear_warp)
# ---------------------------------------------------------------------------
def _permuted_shear_decompose(volume, A):
    """Factor through the BEST input-axis permutation (identity
    included): permute the volume (a device relayout) and reorder A's
    coordinate rows so the permuted map factorizes with the healthiest
    pivots. Returns (permuted volume, permuted A, decomposition) or
    (volume, A, None). ``volume`` a tensor (permuted on its device)."""
    from itertools import permutations

    best = None
    for perm in permutations(range(3)):        # new zyx <- old zyx axes
        # A rows are input (x, y, z) coords = old vol axes (2, 1, 0);
        # new axis j carries old axis perm[j], so new row for x' is the
        # old row of axis perm[2], etc.
        rows = [2 - perm[2], 2 - perm[1], 2 - perm[0]]
        AP = np.eye(4)
        AP[:3] = A[rows, :]
        dec = _shear_decompose(AP)
        if dec is not None:
            pivots = np.abs([dec[0][0][0], dec[0][1][0], dec[0][2][0]])
            score = pivots.min()
            if best is None or score > best[0]:
                best = (score, perm, AP, dec)
    if best is None:
        return volume, A, None
    _, perm, AP, dec = best
    if perm == (0, 1, 2):
        return volume, AP, dec
    return volume.permute(*perm), AP, dec


def _shear_decompose(pixel_matrix):
    """Factor the output->input pixel map into three axis passes.

    Returns per-pass coefficient triples solving (z, y, x ordering)
        z_in = a3*oz + b3*oy + c3*ox + d3
        y_in = a2*oy + b2*ox + c2*z_in + d2
        x_in = a1*ox + b1*y_in + c1*z_in + d1
    as (coef (3, 4) float32 rows (a1, b1, c1, d1), (a2, ...), (a3, ...);
    M (3, 3) float32, the map in (z, y, x) order; t (3,) float32), or None
    when the pivots are too small (rotations beyond ~60 degrees need an
    axis permutation first)."""
    A = np.asarray(pixel_matrix, np.float64)
    # A maps (x,y,z,1); reorder rows/cols to (z,y,x)
    M = np.array([[A[2, 2], A[2, 1], A[2, 0]],
                  [A[1, 2], A[1, 1], A[1, 0]],
                  [A[0, 2], A[0, 1], A[0, 0]]])
    t = np.array([A[2, 3], A[1, 3], A[0, 3]])

    if abs(M[0, 0]) < 0.15:
        return None
    a3, b3, c3, d3 = M[0, 0], M[0, 1], M[0, 2], t[0]
    c2 = M[1, 0] / M[0, 0]
    a2 = M[1, 1] - c2 * M[0, 1]
    b2 = M[1, 2] - c2 * M[0, 2]
    d2 = t[1] - c2 * t[0]
    if abs(a2) < 0.15:
        return None
    K = np.array([[M[0, 0], M[1, 0]], [M[0, 1], M[1, 1]]])
    if abs(np.linalg.det(K)) < 0.02:
        return None
    c1, b1 = np.linalg.solve(K, [M[2, 0], M[2, 1]])
    a1 = M[2, 2] - c1 * M[0, 2] - b1 * M[1, 2]
    d1 = t[2] - c1 * t[0] - b1 * t[1]
    if abs(a1) < 0.15:
        return None
    coef = np.array([[a1, b1, c1, d1], [a2, b2, c2, d2],
                     [a3, b3, c3, d3]], np.float32)
    return coef, M.astype(np.float32), t.astype(np.float32)


def _shear_warp(vol, coef, M, t, background, out_shape):
    """The three passes of the shear-decomposed resample (the body of the
    JAX package's ``_shear_warp_jit``): along x on the input grid, along
    y (y transposed into the rows' last axis), along z; then the analytic
    in-bounds mask of the composed map. vol (Zi, Yi, Xi) float32 tensor;
    coef the (3, 4) rows of :func:`_shear_decompose` as floats; M, t its
    (z, y, x) map -> (Zo, Yo, Xo) float32 on vol's device."""
    Zi, Yi, Xi = vol.shape
    Zo, Yo, Xo = out_shape
    (a1, b1, c1, d1), (a2, b2, c2, d2), (a3, b3, c3, d3) = coef

    def ax(n):
        return torch.arange(n, dtype=torch.float32, device=vol.device)

    # pass 1: along x on the (Zi, Yi) input grid
    pos1 = (a1 * ax(Xo)[None, None, :] + b1 * ax(Yi)[None, :, None]
            + c1 * ax(Zi)[:, None, None] + d1)
    t1 = shear_x(vol, pos1)                                  # (Zi, Yi, Xo)
    # pass 2: along y (y transposed into the rows)
    pos2 = (a2 * ax(Yo)[None, None, :] + b2 * ax(Xo)[None, :, None]
            + c2 * ax(Zi)[:, None, None] + d2)
    t2 = shear_x(t1.transpose(1, 2), pos2).transpose(1, 2)   # (Zi, Yo, Xo)
    del t1
    # pass 3: along z
    pos3 = (a3 * ax(Zo)[None, None, :] + b3 * ax(Yo)[:, None, None]
            + c3 * ax(Xo)[None, :, None] + d3)
    out = shear_x(t2.permute(1, 2, 0), pos3).permute(2, 0, 1)  # (Zo, Yo, Xo)
    del t2
    # analytic in-bounds mask of the composed map cin = M o + t, in
    # elementwise float32 (no contraction a TF32 setting could reach)
    zz, yy, xx = ax(Zo)[:, None, None], ax(Yo)[None, :, None], \
        ax(Xo)[None, None, :]
    valid = torch.ones(out.shape, dtype=torch.bool, device=vol.device)
    for i, n in enumerate((Zi, Yi, Xi)):
        cin = (float(M[i, 0]) * zz + float(M[i, 1]) * yy
               + float(M[i, 2]) * xx + float(t[i]))
        valid &= (cin > -0.5) & (cin < n - 0.5)
    return torch.where(valid, out, torch.tensor(
        background, dtype=torch.float32, device=vol.device)).contiguous()


def affine_resample_shear(volume, pixel_matrix, out_shape, background=None,
                          device=None):
    """Shear-decomposed affine resample: three passes of the lane_interp
    kernel on the card instead of one 8-tap gather. The input-axis
    permutation (identity included) with the healthiest pivots is chosen
    first (a device relayout of the volume); a map no permutation
    factorizes goes to :func:`affine_resample`. Interiors match
    affine_resample at smooth-volume shear-warp accuracy with a 1-voxel
    artifact band along the rotated input edges, so this lane stays
    opt-in (``config.use_shear_warp``). ``volume`` (Z, Y, X) moves to
    ``device`` (default: where it already is, the card for an array);
    returns the (Zo, Yo, Xo) float32 tensor there."""
    if background is None:
        background = config.background_fill
    if device is None:
        device = volume.device if isinstance(volume, torch.Tensor) \
            else default_device()
    vol = torch.as_tensor(volume, device=device).to(torch.float32)
    A = np.asarray(pixel_matrix, np.float64)
    volP, _, dec = _permuted_shear_decompose(vol, A)
    if dec is None:
        return affine_resample(vol, pixel_matrix, out_shape, background)
    coef, M, t = dec
    return _shear_warp(volP.contiguous(), coef.tolist(), M, t,
                       float(background), tuple(int(s) for s in out_shape))
