"""Exact trilinear warp: a hand-written CUDA kernel and its plain twin.

Port of medicalimageanalysis_tpu/ops/pallas_warp.py. The TPU kernel
(``_warp_kernel``) becomes csrc/warp.cu in its four modes:

- ``coords``: sample B volumes at absolute (cz, cy, cx) voxel coordinates,
  optionally with the exact coordinate gradients from the same taps
  (rigid registration);
- ``affine``: the coordinates come from 12 coefficients over the output
  index, inside the kernel (reslice);
- ``disp``: the coordinates are the output index plus a planar
  (3, Zo, Yo, Xo) voxel displacement, rows (x, y, z), optionally with
  the coordinate gradients (demons, DVF inversion and composition, the
  B-spline fit, the deformed reslice);
- ``affine_shear``: the ``affine`` sample, taps and fractions over the
  logical volume, read from its staircase-sheared copy V2 (the oblique
  entry :func:`affine_warp_oblique`, whose V2 one ``coords`` launch
  builds).

Each is registered as a PyTorch operator, ``torch.ops.mia_torch.
warp_coords`` / ``warp_affine`` / ``warp_disp`` / ``warp_affine_shear``.
The dispatcher picks the implementation by the tensors' device and
nothing else: a CPU tensor runs the plain PyTorch twin
(``warp_coords_plain`` / ``warp_affine_plain`` / ``warp_disp_plain`` /
``warp_affine_shear_plain``), a CUDA tensor launches the kernel or raises.

Semantics (those of ops/resample._trilinear in the JAX package): taps
clamp to the volume edge, samples outside ``[0, dim-1]`` take
``background``, gradients are 0 there. The twin rounds every operation
in the kernel's order, so the two are bit-equal on the card.

The TPU kernel's slab/window machinery (``_pick_config``,
``fits_warp_caps``, ``fits_x_window``, ``required_window``,
``window_slab_bytes``, ``predicted_spread``, the overflow counter, the
``window`` / ``interpret`` arguments and ``oblique_plan``'s VMEM gates)
has no counterpart: the CUDA kernel reads global memory directly and
serves every coordinate map. The JAX module's entry names
(``field_warp_xla``, ``warp_jit``, ``warp_disp_jit``, ``field_warp_disp``,
``affine_warp``) are kept with their signatures less those arguments.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch import Tensor

__all__ = ["LAUNCHES", "LAUNCH_SHAPES", "MAX_B", "affine_coords",
           "affine_warp", "affine_warp_fused", "batch_chunks",
           "check_index_range", "affine_warp_oblique", "field_warp",
           "field_warp_disp", "field_warp_xla", "make_disp_sampler",
           "make_warp_sampler", "oblique_plan", "oblique_v2",
           "warp_affine_plain", "warp_affine_shear_plain",
           "warp_coords_plain", "warp_disp", "warp_disp_jit",
           "warp_disp_plain", "warp_jit"]

# Kernel launches per operator; a run reads them to show that its main
# path went through the kernels. Only the CUDA implementations add to them.
LAUNCHES = {"warp_coords": 0, "warp_affine": 0, "warp_disp": 0,
            "warp_affine_shear": 0}
# The same launches by (operator, volumes B, gradients, output (Zo, Yo,
# Xo)): a run weighs each shape's kernel time against its bound with them.
LAUNCH_SHAPES = {}

MAX_B = 4                 # volumes per launch (csrc/warp.cu kMaxB)


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------
def _sample_plain(vol, cz, cy, cx, background, want_grad, shear=None):
    """vol (B, Z, Y, X) f32; coordinates (any shape S) f32 ->
    out (B, *S) [, gz, gy, gx (B, *S)], in the kernel's operation order.

    With ``shear`` = (Z, Y, ky, kz, oy, oz), ``vol`` is the sheared copy
    V2 (B, Z2, Y2, X) of volumes of logical dims (Z, Y, X), read as the
    ``affine_shear`` kernel reads it (:func:`_stair_row`)."""
    B, Z, Y, X = vol.shape
    if shear is not None:
        Z2, Y2 = Z, Y
        Z, Y, ky, kz, oy, oz = shear
    inside = ((cx >= 0) & (cx <= X - 1) & (cy >= 0) & (cy <= Y - 1)
              & (cz >= 0) & (cz <= Z - 1))
    x0f, y0f, z0f = torch.floor(cx), torch.floor(cy), torch.floor(cz)
    fx, fy, fz = cx - x0f, cy - y0f, cz - z0f
    gfx, gfy, gfz = 1 - fx, 1 - fy, 1 - fz

    def taps(f, hi):
        # clamp in float before the cast: NaN -> 0, +-inf/1e30 -> edge
        t0 = torch.nan_to_num(f, nan=0.0).clamp(0, hi).to(torch.int64)
        return t0, torch.clamp(t0 + 1, max=hi)

    x0, x1 = taps(x0f, X - 1)
    y0, y1 = taps(y0f, Y - 1)
    z0, z1 = taps(z0f, Z - 1)
    flat = vol.reshape(B, -1)

    def take(zi, yi, xi):
        if shear is None:
            idx = (zi * Y + yi) * X + xi
        else:
            idx = (_stair_row(zi, oz, kz, xi, Z2) * Y2
                   + _stair_row(yi, oy, ky, xi, Y2)) * X + xi
        return flat.index_select(1, idx.reshape(-1)).reshape(
            (B,) + tuple(cx.shape))

    c000, c001 = take(z0, y0, x0), take(z0, y0, x1)
    c010, c011 = take(z0, y1, x0), take(z0, y1, x1)
    c100, c101 = take(z1, y0, x0), take(z1, y0, x1)
    c110, c111 = take(z1, y1, x0), take(z1, y1, x1)
    c00 = c000 * gfx + c001 * fx
    c01 = c010 * gfx + c011 * fx
    c10 = c100 * gfx + c101 * fx
    c11 = c110 * gfx + c111 * fx
    c0 = c00 * gfy + c01 * fy
    c1 = c10 * gfy + c11 * fy
    bg = torch.tensor(background, dtype=torch.float32, device=vol.device)
    out = torch.where(inside, c0 * gfz + c1 * fz, bg)
    if not want_grad:
        return [out]
    zero = torch.zeros((), dtype=torch.float32, device=vol.device)
    gx = ((c001 - c000) * gfy + (c011 - c010) * fy) * gfz \
        + ((c101 - c100) * gfy + (c111 - c110) * fy) * fz
    gy = (c01 - c00) * gfz + (c11 - c10) * fz
    gz = c1 - c0
    return [out, torch.where(inside, gz, zero), torch.where(inside, gy, zero),
            torch.where(inside, gx, zero)]


def warp_coords_plain(vol, cz, cy, cx, background=0.0, want_grad=False):
    """Plain PyTorch ``coords`` mode: vol (B, Z, Y, X) f32, coordinates
    (Zo, Yo, Xo) f32 -> [out] or [out, gz, gy, gx], each (B, Zo, Yo, Xo)."""
    return _sample_plain(vol, cz, cy, cx, float(background), want_grad)


def warp_affine_plain(vol, coef, out_shape, background=0.0):
    """Plain PyTorch ``affine`` mode: vol (B, Z, Y, X) f32, 12 row-major
    coefficients of the output (x, y, z, 1) -> input (x, y, z) pixel map
    -> (B, Zo, Yo, Xo)."""
    A = torch.tensor(coef, dtype=torch.float32, device=vol.device)
    cz, cy, cx = affine_coords(A.reshape(3, 4), out_shape)
    return _sample_plain(vol, cz, cy, cx, float(background), False)[0]


def warp_affine_shear_plain(v2, coef16, logical_dims, out_shape,
                            background=0.0):
    """Plain PyTorch ``affine_shear`` mode: v2 (B, Z2, Y2, X) f32, the
    staircase-sheared copy of volumes of ``logical_dims`` (Z, Y, X);
    ``coef16`` the 12 affine coefficients of :func:`warp_affine_plain`,
    then ky, kz, oy, oz -> (B, Zo, Yo, Xo)."""
    c = torch.tensor(coef16, dtype=torch.float32, device=v2.device)
    cz, cy, cx = affine_coords(c[:12].reshape(3, 4), out_shape)
    Z, Y, _ = (int(v) for v in logical_dims)
    return _sample_plain(v2, cz, cy, cx, float(background), False,
                         shear=(Z, Y, c[12], c[13], c[14], c[15]))[0]


def _base_grid(shape_zyx, device):
    """Broadcastable (zz, yy, xx) f32 output-grid base coordinates: the
    twin of the kernel's index arithmetic in ``disp`` and ``affine``."""
    Zo, Yo, Xo = (int(s) for s in shape_zyx)
    opts = dict(dtype=torch.float32, device=device)
    return (torch.arange(Zo, **opts)[:, None, None],
            torch.arange(Yo, **opts)[None, :, None],
            torch.arange(Xo, **opts)[None, None, :])


def warp_disp_plain(vol, disp, background=0.0, want_grad=False):
    """Plain PyTorch ``disp`` mode: vol (B, Z, Y, X) f32, disp
    (3, Zo, Yo, Xo) f32 voxel displacements with rows (x, y, z) ->
    [out] or [out, gz, gy, gx], each (B, Zo, Yo, Xo); out(p) =
    vol(p + disp(p))."""
    zz, yy, xx = _base_grid(disp.shape[1:], disp.device)
    return _sample_plain(vol, zz + disp[2], yy + disp[1], xx + disp[0],
                         float(background), want_grad)


# ---------------------------------------------------------------------------
# operators: plain twin on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------
@torch.library.custom_op("mia_torch::warp_coords", mutates_args=(),
                         device_types="cpu")
def _warp_coords_op(vol: Tensor, cz: Tensor, cy: Tensor, cx: Tensor,
                    background: float, want_grad: bool) -> list[Tensor]:
    return warp_coords_plain(vol, cz, cy, cx, background, want_grad)


@torch.library.custom_op("mia_torch::warp_affine", mutates_args=(),
                         device_types="cpu")
def _warp_affine_op(vol: Tensor, coef: list[float], out_shape: list[int],
                    background: float) -> Tensor:
    return warp_affine_plain(vol, coef, out_shape, background)


@torch.library.custom_op("mia_torch::warp_disp", mutates_args=(),
                         device_types="cpu")
def _warp_disp_op(vol: Tensor, disp: Tensor, background: float,
                  want_grad: bool) -> list[Tensor]:
    return warp_disp_plain(vol, disp, background, want_grad)


@torch.library.custom_op("mia_torch::warp_affine_shear", mutates_args=(),
                         device_types="cpu")
def _warp_affine_shear_op(v2: Tensor, coef16: list[float],
                          logical_dims: list[int], out_shape: list[int],
                          background: float) -> Tensor:
    return warp_affine_shear_plain(v2, coef16, logical_dims, out_shape,
                                   background)


def _check_f32_cuda(name, t, device):
    if t.device != device or t.dtype != torch.float32 \
            or not t.is_contiguous():
        raise ValueError(f"warp kernel: {name} must be a contiguous float32 "
                         f"tensor on {device}, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def batch_chunks(B):
    """(first volume, count) of each launch for B volumes: the kernel
    takes at most MAX_B volumes a launch."""
    return [(b0, min(MAX_B, B - b0)) for b0 in range(0, int(B), MAX_B)]


def check_index_range(what, *shapes):
    """Raise unless every (.., Z, Y, X) shape has fewer than 2^31 voxels
    per volume: the kernel's offsets inside a volume are int32."""
    for shape in shapes:
        voxels = math.prod(int(s) for s in shape[-3:])
        if voxels >= 2 ** 31:
            raise ValueError(f"{what}: a volume of {tuple(shape[-3:])} has "
                             f"{voxels} >= 2^31 voxels, beyond the kernel's "
                             "int32 offsets")


def _launch(kernel, vol, outs, want_grad, call):
    """``call(vol_ptr, nb, out_ptrs)`` once for each chunk of at most
    MAX_B volumes of ``vol`` (B, ...) and the matching rows of ``outs``
    (each (B, Zo, Yo, Xo)); counts each launch and its shape."""
    shape = tuple(outs[0].shape[1:])
    vstep = 4 * math.prod(vol.shape[1:])
    ostep = 4 * math.prod(shape)
    for b0, nb in batch_chunks(vol.shape[0]):
        ptr = [o.data_ptr() + b0 * ostep for o in outs] \
            + [None] * (4 - len(outs))
        _raise_on(call(vol.data_ptr() + b0 * vstep, nb, ptr), kernel)
        LAUNCHES[kernel] += 1
        key = (kernel, nb, bool(want_grad), shape)
        LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1


@_warp_coords_op.register_kernel("cuda")
def _warp_coords_cuda(vol, cz, cy, cx, background, want_grad):
    from ._build import load_warp_library

    dev = vol.device
    for name, t in (("vol", vol), ("cz", cz), ("cy", cy), ("cx", cx)):
        _check_f32_cuda(name, t, dev)
    if vol.dim() != 4 or cz.dim() != 3 or cy.shape != cz.shape \
            or cx.shape != cz.shape:
        raise ValueError("warp_coords: vol (B, Z, Y, X) and three equal "
                         f"(Zo, Yo, Xo) coordinate tensors, got "
                         f"{tuple(vol.shape)}, {tuple(cz.shape)}, "
                         f"{tuple(cy.shape)}, {tuple(cx.shape)}")
    check_index_range("warp_coords", vol.shape, cz.shape)
    lib = load_warp_library()
    B, Z, Y, X = vol.shape
    Zo, Yo, Xo = cz.shape
    outs = [torch.empty((B, Zo, Yo, Xo), dtype=torch.float32, device=dev)
            for _ in range(4 if want_grad else 1)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _launch("warp_coords", vol, outs, want_grad,
                lambda v, nb, ptr: lib.mia_warp_coords(
                    v, nb, Z, Y, X, cz.data_ptr(), cy.data_ptr(),
                    cx.data_ptr(), Zo, Yo, Xo, float(background), ptr[0],
                    ptr[1], ptr[2], ptr[3], int(bool(want_grad)), stream))
    return outs


@_warp_affine_op.register_kernel("cuda")
def _warp_affine_cuda(vol, coef, out_shape, background):
    from ._build import load_warp_library

    dev = vol.device
    _check_f32_cuda("vol", vol, dev)
    if vol.dim() != 4 or len(coef) != 12 or len(out_shape) != 3:
        raise ValueError("warp_affine: vol (B, Z, Y, X), 12 coefficients and "
                         "a 3-d out_shape")
    check_index_range("warp_affine", vol.shape, out_shape)
    lib = load_warp_library()
    B, Z, Y, X = vol.shape
    Zo, Yo, Xo = (int(s) for s in out_shape)
    out = torch.empty((B, Zo, Yo, Xo), dtype=torch.float32, device=dev)
    c12 = (ctypes.c_float * 12)(*[float(v) for v in coef])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _launch("warp_affine", vol, [out], False,
                lambda v, nb, ptr: lib.mia_warp_affine(
                    v, nb, Z, Y, X, c12, Zo, Yo, Xo, float(background),
                    ptr[0], stream))
    return out


@_warp_disp_op.register_kernel("cuda")
def _warp_disp_cuda(vol, disp, background, want_grad):
    from ._build import load_warp_library

    dev = vol.device
    _check_f32_cuda("vol", vol, dev)
    _check_f32_cuda("disp", disp, dev)
    if vol.dim() != 4 or disp.dim() != 4 or disp.shape[0] != 3:
        raise ValueError("warp_disp: vol (B, Z, Y, X) and disp "
                         f"(3, Zo, Yo, Xo), got {tuple(vol.shape)}, "
                         f"{tuple(disp.shape)}")
    check_index_range("warp_disp", vol.shape, disp.shape)
    lib = load_warp_library()
    B, Z, Y, X = vol.shape
    _, Zo, Yo, Xo = disp.shape
    outs = [torch.empty((B, Zo, Yo, Xo), dtype=torch.float32, device=dev)
            for _ in range(4 if want_grad else 1)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _launch("warp_disp", vol, outs, want_grad,
                lambda v, nb, ptr: lib.mia_warp_disp(
                    v, nb, Z, Y, X, disp.data_ptr(), Zo, Yo, Xo,
                    float(background), ptr[0], ptr[1], ptr[2], ptr[3],
                    int(bool(want_grad)), stream))
    return outs


@_warp_affine_shear_op.register_kernel("cuda")
def _warp_affine_shear_cuda(v2, coef16, logical_dims, out_shape, background):
    from ._build import load_warp_library

    dev = v2.device
    _check_f32_cuda("v2", v2, dev)
    if v2.dim() != 4 or len(coef16) != 16 or len(logical_dims) != 3 \
            or len(out_shape) != 3 or int(logical_dims[2]) != v2.shape[3]:
        raise ValueError("warp_affine_shear: v2 (B, Z2, Y2, X), 16 "
                         "coefficients, logical dims (Z, Y, X) and a 3-d "
                         f"out_shape, got {tuple(v2.shape)}, {len(coef16)}, "
                         f"{list(logical_dims)}, {list(out_shape)}")
    check_index_range("warp_affine_shear", v2.shape, out_shape)
    lib = load_warp_library()
    B, Z2, Y2, X = v2.shape
    Z, Y = int(logical_dims[0]), int(logical_dims[1])
    Zo, Yo, Xo = (int(s) for s in out_shape)
    out = torch.empty((B, Zo, Yo, Xo), dtype=torch.float32, device=dev)
    c16 = (ctypes.c_float * 16)(*[float(v) for v in coef16])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _launch("warp_affine_shear", v2, [out], False,
                lambda v, nb, ptr: lib.mia_warp_affine_shear(
                    v, nb, Z2, Y2, X, Z, Y, c16, Zo, Yo, Xo,
                    float(background), ptr[0], stream))
    return out


# ---------------------------------------------------------------------------
# public surface (names of the JAX module)
# ---------------------------------------------------------------------------
def _as_batch(vol):
    vol = torch.as_tensor(vol).to(torch.float32)
    squeeze = vol.dim() == 3
    return (vol[None] if squeeze else vol).contiguous(), squeeze


def field_warp(vol, cz, cy, cx, background=0.0, want_grad=False):
    """Trilinear-sample ``vol`` at absolute voxel coords (cz, cy, cx).

    vol : (Z, Y, X) or (B, Z, Y, X) tensor (any real dtype)
    cz, cy, cx : (Zo, Yo, Xo) sample coordinates in voxel units
    Returns ``out`` or ``(out, (gz, gy, gx))``.
    """
    volb, squeeze = _as_batch(vol)
    cz, cy, cx = (torch.as_tensor(c, dtype=torch.float32,
                                  device=volb.device).contiguous()
                  for c in (cz, cy, cx))
    res = torch.ops.mia_torch.warp_coords(volb, cz, cy, cx,
                                          float(background), want_grad)
    if squeeze:
        res = [r[0] for r in res]
    if want_grad:
        return res[0], tuple(res[1:])
    return res[0]


class _WarpSample(torch.autograd.Function):
    """Exact trilinear sample whose coordinate gradient comes from the
    forward kernel pass (no re-gather in the backward). Not
    differentiable with respect to the volume."""

    @staticmethod
    def forward(ctx, volb, background, cz, cy, cx):
        want = any(ctx.needs_input_grad[2:])
        res = torch.ops.mia_torch.warp_coords(
            volb, cz.contiguous(), cy.contiguous(), cx.contiguous(),
            background, want)
        if want:
            ctx.save_for_backward(*res[1:])
        return res[0]

    @staticmethod
    def backward(ctx, g):
        gz, gy, gx = ctx.saved_tensors
        # coordinates are shared by the B volumes: the VJP sums over B
        return (None, None, (g * gz).sum(0), (g * gy).sum(0),
                (g * gx).sum(0))


def make_warp_sampler(vol, background=0.0):
    """Differentiable sampler ``sample(cz, cy, cx) -> out`` with the exact
    analytic coordinate VJP computed by the warp kernel in the forward
    pass. vol (Z, Y, X) gives (Zo, Yo, Xo) samples, (B, Z, Y, X) gives
    (B, Zo, Yo, Xo)."""
    volb, squeeze = _as_batch(vol)
    bg = float(background)

    def sample(cz, cy, cx):
        out = _WarpSample.apply(volb, bg, cz, cy, cx)
        return out[0] if squeeze else out

    return sample


def affine_coords(pixel_matrix, out_shape):
    """(cz, cy, cx) for an (x,y,z)-ordered pixel matrix (its first three
    rows) mapping output pixel (x, y, z, 1) -> input pixel, in the affine
    kernel's f32 operation order ((c0*x + c1*y) + c2*z) + c3, each a
    contiguous (Zo, Yo, Xo) tensor. Differentiable in the matrix."""
    A = pixel_matrix
    Zo, Yo, Xo = (int(s) for s in out_shape)
    opts = dict(dtype=torch.float32, device=A.device)
    zz = torch.arange(Zo, **opts)[:, None, None]
    yy = torch.arange(Yo, **opts)[None, :, None]
    xx = torch.arange(Xo, **opts)[None, None, :]
    cx = A[0, 0] * xx + A[0, 1] * yy + A[0, 2] * zz + A[0, 3]
    cy = A[1, 0] * xx + A[1, 1] * yy + A[1, 2] * zz + A[1, 3]
    cz = A[2, 0] * xx + A[2, 1] * yy + A[2, 2] * zz + A[2, 3]
    return cz, cy, cx


def affine_warp(volume, pixel_matrix, out_shape, background=0.0):
    """Exact affine resample: one ``affine`` launch whose coordinates come
    from the 12 row-major coefficients of ``pixel_matrix`` (4x4, f32
    values), mapping output pixel (x, y, z, 1) -> input pixel. volume
    (Z, Y, X) -> (Zo, Yo, Xo), or (B, Z, Y, X) -> (B, Zo, Yo, Xo); the
    contract of ``ops.resample.affine_resample``. The JAX function's
    ``window`` / ``interpret`` / ``check_overflow`` belong to the TPU slab
    window and have no counterpart."""
    volb, squeeze = _as_batch(volume)
    A = torch.as_tensor(pixel_matrix, dtype=torch.float32).cpu()
    coef = [float(v) for v in A[:3, :].reshape(12)]
    out = torch.ops.mia_torch.warp_affine(
        volb, coef, [int(s) for s in out_shape], float(background))
    return out[0] if squeeze else out


def affine_warp_fused(volume, pixel_matrix, background, out_shape):
    """One-launch affine resample (:func:`affine_warp` in the JAX
    module's argument order): volume (Z, Y, X) -> (Zo, Yo, Xo). No
    overflow count: the kernel has no slab."""
    return affine_warp(volume, pixel_matrix, out_shape, background)


def warp_disp(vols, disp, background=0.0):
    """Displacement warp: out(p) = vols(p + disp(p)).

    vols (Z, Y, X) or (B, Z, Y, X); disp the (3, Zo, Yo, Xo) planar voxel
    field with rows (x, y, z), on the volumes' device. One ``disp``
    launch on the card; no coordinate volume is materialised there."""
    volb, squeeze = _as_batch(vols)
    disp = torch.as_tensor(disp, dtype=torch.float32,
                           device=volb.device).contiguous()
    out = torch.ops.mia_torch.warp_disp(volb, disp, float(background),
                                        False)[0]
    return out[0] if squeeze else out


def field_warp_disp(vols, disp, background=0.0):
    """Eager exact displacement warp, :func:`warp_disp`. The JAX function
    sizes the TPU kernel's slab window from the field and falls back to
    the gather on overflow; the CUDA kernel has no slab, so every field
    takes the one launch."""
    return warp_disp(vols, disp, background)


def warp_disp_jit(vols, disp, background=0.0, with_overflow=False):
    """:func:`warp_disp` under the JAX module's name. ``with_overflow``
    also returns the slab-overflow count, a float32 zero on the volumes'
    device: the CUDA kernel has no slab to overflow. The JAX function's
    ``window`` / ``interpret`` have no counterpart."""
    out = warp_disp(vols, disp, background)
    if not with_overflow:
        return out
    return out, torch.zeros((), dtype=torch.float32, device=out.device)


def warp_jit(vols, cz, cy, cx, background=0.0):
    """:func:`field_warp` without gradients, under the JAX module's name:
    vols (B, Z, Y, X) or (Z, Y, X), coordinates (Zo, Yo, Xo) in voxels.
    The JAX function's ``window`` has no counterpart."""
    return field_warp(vols, cz, cy, cx, background)


def field_warp_xla(vol, cz, cy, cx, background=0.0):
    """The plain PyTorch sample (the JAX module's XLA twin) on the
    tensors' device, whatever it is: vol (Z, Y, X) or (B, Z, Y, X),
    coordinates (Zo, Yo, Xo). The golden the kernel is held to."""
    volb, squeeze = _as_batch(vol)
    cz, cy, cx = (torch.as_tensor(c, dtype=torch.float32, device=volb.device)
                  for c in (cz, cy, cx))
    out = warp_coords_plain(volb, cz, cy, cx, background)[0]
    return out[0] if squeeze else out


class _DispSample(torch.autograd.Function):
    """Displacement sample whose VJP comes from the forward kernel pass:
    the coordinate gradients (z, y, x order from the kernel) restacked as
    the planar (x, y, z) field layout and summed over the B volumes. Not
    differentiable with respect to the volume."""

    @staticmethod
    def forward(ctx, volb, background, disp):
        want = ctx.needs_input_grad[2]
        res = torch.ops.mia_torch.warp_disp(volb, disp.contiguous(),
                                            background, want)
        if want:
            ctx.save_for_backward(*res[1:])
        return res[0]

    @staticmethod
    def backward(ctx, g):
        gz, gy, gx = ctx.saved_tensors
        return None, None, torch.stack([(g * gx).sum(0), (g * gy).sum(0),
                                        (g * gz).sum(0)])


def make_disp_sampler(vol, background=0.0):
    """Differentiable displacement sampler ``sample(disp) -> out`` with
    the exact analytic VJP fused into the forward kernel pass. disp is
    the planar (3, Zo, Yo, Xo) voxel field, rows (x, y, z); vol
    (Z, Y, X) gives (Zo, Yo, Xo), (B, Z, Y, X) gives (B, Zo, Yo, Xo)."""
    volb, squeeze = _as_batch(vol)
    bg = float(background)

    def sample(disp):
        out = _DispSample.apply(volb, bg, disp)
        return out[0] if squeeze else out

    return sample


# ---------------------------------------------------------------------------
# Oblique affine resample: the staircase-shear factorization
#
#   warp(V, A) == warp_shear(shear(V, ky, kz), A, ky, kz)
#
# where shear is an exact integer row permutation
#   V2[z + oz - stair(kz, x), y + oy - stair(ky, x), x] = V[z, y, x],
#   stair(k, x) = floor(k*x + 0.5),  ky = A10/A00, kz = A20/A00,
# built by one ``coords`` launch in the transposed (z, x, y) layout with
# integer coordinates (an exact copy), then sampled by the
# ``affine_shear`` kernel. On the TPU it kept each output tile's rows in a
# VMEM slab window; on the card the direct ``affine`` mode serves every
# map, and this route pays V2's build on top (PERF.md).
# ---------------------------------------------------------------------------
def _round_up(v, m):
    return -(-int(v) // m) * m


def _stair(k, x):
    """The staircase shift floor(f32(k) * f32(x) + 0.5) in float32: ONE
    formula for the planner, the V2 builder, the plain twin and (in
    csrc/warp.cu) the kernel, so all four round identically. ``x`` a
    tensor (the result stays on its device) or a number (a float)."""
    if isinstance(x, torch.Tensor):
        k = torch.as_tensor(k, dtype=torch.float32, device=x.device)
        return torch.floor(k * x.to(torch.float32) + 0.5)
    return float(np.floor(np.float32(k) * np.float32(x) + np.float32(0.5)))


def _stair_row(r, o, k, x, n):
    """Row of V2 holding row ``r`` (z or y, int64) of the volume at column
    ``x`` (int64): r + o - stair(k, x) in float32, clamped to [0, n-1]
    before the cast, as the kernel computes it."""
    row = (r.to(torch.float32) + o) - _stair(k, x)
    return row.clamp(0, n - 1).to(torch.int64)


def oblique_plan(pixel_matrix, vol_shape_zyx):
    """The staircase-shear plan of an (x, y, z) pixel matrix over a
    (Z, Y, X) volume: dict(ky, kz, oy, oz, Z2, Y2) for
    :func:`affine_warp_oblique`, or None where the factorization does not
    apply (the x column too weak, |A00| < 0.35, or a slope steeper than
    1.05). The fields are computed as the JAX package computes them; its
    VMEM gates and residual ``window`` have no counterpart."""
    A = np.asarray(pixel_matrix, np.float64)
    R = A[:3, :3]
    a00 = R[0, 0]
    if abs(a00) < 0.35:
        return None
    ky = R[1, 0] / a00
    kz = R[2, 0] / a00
    if abs(ky) > 1.05 or abs(kz) > 1.05:
        return None
    Z, Y, X = (int(v) for v in vol_shape_zyx)
    # sheared dims: the staircases are monotone, extremes at x endpoints
    ez = int(_stair(kz, X - 1))
    ey = int(_stair(ky, X - 1))
    return dict(ky=float(ky), kz=float(kz), oy=int(max(0, ey)),
                oz=int(max(0, ez)), Z2=int(_round_up(Z + abs(ez), 16)),
                Y2=int(_round_up(Y + abs(ey), 16)))


def oblique_v2(vol, plan):
    """The staircase-sheared copy V2 (Z2, Y2, X) of ``vol`` (Z, Y, X)
    float32: one ``coords`` launch in the (z, x, y) layout, where the
    per-column row shift is an integer coordinate (the taps degenerate to
    an exact copy; rows outside the volume take 0)."""
    Z, Y, X = vol.shape
    Z2, Y2 = plan["Z2"], plan["Y2"]
    kap = torch.tensor([plan["ky"], plan["kz"], plan["oy"], plan["oz"]],
                       dtype=torch.float32, device=vol.device)
    vt = vol.transpose(1, 2).contiguous()                  # (Z, X, Y)
    opts = dict(dtype=torch.float32, device=vol.device)
    z2 = torch.arange(Z2, **opts)[:, None, None]
    xc = torch.arange(X, **opts)[None, :, None]
    y2 = torch.arange(Y2, **opts)[None, None, :]
    sh = (Z2, X, Y2)
    cz = (z2 - kap[3] + _stair(kap[1], xc)).expand(sh).contiguous()
    cy = xc.expand(sh).contiguous()
    cx = (y2 - kap[2] + _stair(kap[0], xc)).expand(sh).contiguous()
    v2t = torch.ops.mia_torch.warp_coords(vt[None], cz, cy, cx, 0.0,
                                          False)[0][0]
    return v2t.transpose(1, 2).contiguous()                # (Z2, Y2, X)


def affine_warp_oblique(volume, pixel_matrix, background, out_shape, plan,
                        perm=None, flips=None):
    """Affine resample through the staircase-shear factorization: the
    optional input relayout (``perm`` / ``flips``, as
    ``resample._axis_align_input`` gives them), V2 (:func:`oblique_v2`),
    then one ``affine_shear`` launch. ``plan`` comes from
    :func:`oblique_plan` for the relayouted matrix and volume. volume
    (Z, Y, X) -> (Zo, Yo, Xo) float32 on its device, bit-equal to
    :func:`affine_warp_fused` of the relayouted volume wherever V2 is an
    exact copy (finite volumes). No overflow count: the kernel has no
    slab."""
    vol = torch.as_tensor(volume).to(torch.float32)
    if perm is not None:
        vol = vol.permute(*perm)
    if flips:
        vol = vol.flip(tuple(flips))
    vol = vol.contiguous()
    v2 = oblique_v2(vol, plan)
    A = torch.as_tensor(pixel_matrix, dtype=torch.float32).cpu()
    coef = [float(v) for v in A[:3, :].reshape(12)] + [
        float(np.float32(plan[k])) for k in ("ky", "kz", "oy", "oz")]
    out = torch.ops.mia_torch.warp_affine_shear(
        v2[None], coef, list(vol.shape), [int(s) for s in out_shape],
        float(background))
    return out[0]
