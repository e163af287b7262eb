"""Kernel validation as a library call: ``validate_kernels``.

Port of medicalimageanalysis_tpu/validate.py. The JAX function runs each
Pallas kernel, lowered for the chip, against its XLA twin or a host
golden, so a bench can record the verdict with its numbers
(``kernels_validated``). Here each check runs on the card, where the
hand-written CUDA kernel (csrc/warp.cu, csrc/hist.cu, csrc/lane_interp.cu)
is held both against its plain PyTorch version on the same tensors,
bit-equal as chip_smoke.py holds it, and against a host golden with the
JAX check's tolerance. A kernel that fails to build or to launch raises:
it is not recorded as a failed check, and nothing falls back to the plain
version.

The fixtures are the JAX function's, drawn in its order from
``np.random.default_rng(0)`` (and ``(7)`` for the raster star): the same
shapes, backgrounds and tolerances. Four keys differ in what they pin:

- ``warp_affine_tz16``: the JAX key pins a TPU tile height the CUDA
  kernel does not have. Here it pins the kernel's one-float-at-a-time
  path (odd Xo, and coordinate rows that start off an 8-byte boundary)
  at the affine fixture's coordinates;
- ``warp_coords_grads`` (the port's own): the ``coords`` mode with the
  fused coordinate gradients;
- ``warp_affine_axis`` (the port's own): the ``affine`` mode at a x3
  upsampling with zero off-diagonal coefficients, the kernel's separable
  path (``ops/warp.affine_path``);
- ``dvh_histogram_large`` (the port's own, ``fast=False`` only): a bin
  past 2^24 voxels, exact in the port's int64 counts where the JAX
  histogram counts in float32.

With ``device="cpu"`` the plain versions are held against the same
goldens: the result's ``backend`` is ``"cpu"``, and its ``detail`` says
that no hand kernel ran.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["validate_kernels"]

_WARP_TOL = 1e-5           # trilinear samples: float32 against float64
_AFFINE_TOL = 5e-3         # the JAX check's bound for the affine modes
_GRAD_TOL = 1e-4           # coordinate gradients: float32 against float64
_VJP_TOL = 1e-2            # the disp sampler's VJP against autograd
_EDT_TOL = 1e-3            # mm, against scipy
_LARGE_BIN = (1 << 24) + 4099   # voxels in dvh_histogram_large's bin


def _trilinear_host(vol, cz, cy, cx, background, want_grad=False):
    """Float64 golden of the warp kernel's sample, on the host: vol
    (Z, Y, X), coordinates (any shape, float32 values); taps clamp to the
    edge, samples outside [0, dim - 1] take ``background`` and gradients
    0 there. Returns out, or (out, gz, gy, gx) with ``want_grad``."""
    vol = np.asarray(vol, np.float64)
    dims = vol.shape
    coords = [np.asarray(c, np.float64) for c in (cz, cy, cx)]
    inside = np.ones(coords[0].shape, bool)
    taps, fracs = [], []
    for c, n in zip(coords, dims):
        inside &= (c >= 0) & (c <= n - 1)
        f0 = np.floor(c)
        i0 = np.clip(f0, 0, n - 1).astype(np.int64)
        taps.append((i0, np.minimum(i0 + 1, n - 1)))
        fracs.append(c - f0)
    out = np.zeros(coords[0].shape)
    grads = [np.zeros(coords[0].shape) for _ in range(3)]
    for corner in range(8):
        bits = [(corner >> 2) & 1, (corner >> 1) & 1, corner & 1]
        value = vol[taps[0][bits[0]], taps[1][bits[1]], taps[2][bits[2]]]
        weights = [f if b else 1.0 - f for f, b in zip(fracs, bits)]
        out += value * weights[0] * weights[1] * weights[2]
        for axis in range(3):
            slope = value * (1.0 if bits[axis] else -1.0)
            for other in range(3):
                if other != axis:
                    slope = slope * weights[other]
            grads[axis] += slope
    out = np.where(inside, out, background)
    if not want_grad:
        return out
    return (out,) + tuple(np.where(inside, g, 0.0) for g in grads)


def _lane_interp_host(data, pos):
    """Host golden of lane_interp in float32, in the kernel's operation
    order (numpy rounds each operation and fuses none): bit-equal."""
    data = np.asarray(data, np.float32)
    pos = np.asarray(pos, np.float32)
    Xs = data.shape[1]
    x0f = np.clip(np.nan_to_num(np.floor(pos), nan=0.0), 0,
                  max(Xs - 2, 0)).astype(np.float32)
    x0 = x0f.astype(np.int64)
    x1 = np.minimum(x0 + 1, Xs - 1)
    f = pos - x0f
    rows = np.arange(data.shape[0])[:, None]
    out = data[rows, x0] * (np.float32(1) - f) + data[rows, x1] * f
    valid = (pos > -0.5) & (pos < Xs - 0.5)
    return np.where(valid, out, np.float32(0))


def _fill_polygon_host(poly, H, W):
    """Host golden of one polygon's cv2.fillPoly (the rasterizer's rule,
    float64): vertices truncated to int (``trunc(v + 1e-6)``), the
    interior by even-odd crossings of each pixel row, and the 8-connected
    boundary of every edge, each pixel taken where the edge passes
    (rounding half down, 1e-3 off the ties)."""
    p = np.trunc(np.asarray(poly, np.float64)[:, :2] + 1e-6)
    img = np.zeros((H, W), np.uint8)
    edges = list(zip(p, np.roll(p, -1, axis=0)))
    px = np.arange(W)
    for py in range(H):
        crossings = np.zeros(W, np.int64)
        for (x1, y1), (x2, y2) in edges:
            if (y1 > py) != (y2 > py):
                x_int = x1 + (py - y1) * (x2 - x1) / (y2 - y1)
                crossings += px < x_int
        img[py] = crossings & 1
    for (x1, y1), (x2, y2) in edges:
        dx, dy = x2 - x1, y2 - y1
        if abs(dx) >= abs(dy):
            for x in range(int(min(x1, x2)), int(max(x1, x2)) + 1):
                y = y1 if dy == 0 else np.floor(
                    y1 + (x - 1e-3 - x1) * dy / dx + 0.5)
                if 0 <= x < W and 0 <= y < H:
                    img[int(y), x] = 1
        else:
            for y in range(int(min(y1, y2)), int(max(y1, y2)) + 1):
                x = np.floor(x1 + (y - y1) * dx / dy + 0.5 - 1e-3)
                if 0 <= x < W and 0 <= y < H:
                    img[y, int(x)] = 1
    return img


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past an
    8-byte boundary: the warp kernel must take its rows one float at a
    time."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    start = 1 if buf.data_ptr() % 8 == 0 else 0
    out = buf[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def validate_kernels(fast=True, device=None):
    """Run the kernel exactness checks on ``device`` (default: the card;
    with no card and no ``device`` it raises).

    Returns ``{"backend": str, "ok": bool, "checks": {name: bool},
    "detail": {name: str}}``: the JAX function's twelve keys and the
    port's three (``warp_coords_grads``, ``warp_affine_axis``;
    ``dvh_histogram_large`` with ``fast=False``). ``fast=True`` keeps the
    shapes small (about a second on the card); ``fast=False`` adds the
    larger warp grid and the large histogram bin. On the card each hand
    kernel is held bit-equal to its plain version and to the golden
    within the JAX tolerance; a kernel that does not build or launch
    raises. With ``device="cpu"``
    the plain versions are held to the goldens and no hand kernel runs.
    """
    from scipy import ndimage
    from scipy.spatial.transform import Rotation

    from .device import default_device
    from .ops import bitpack, edt, hist, lane_interp, rasterize, warp
    from .ops import marching_cubes, voxelize
    from .utils.convert import voxelize as host_voxelize

    dev = default_device() if device is None else torch.device(device)
    on_card = dev.type == "cuda"
    checks, detail = {}, {}
    rng = np.random.default_rng(0)

    def record(name, ok, note):
        checks[name] = bool(ok)
        detail[name] = note

    def diff(a, b):
        a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
        return float(np.max(np.abs(a.astype(np.float64) - b))) \
            if a.size else 0.0

    def kernel_check(name, kernel, plain, golden, tol, note=""):
        """``kernel()`` and ``plain()`` give a tensor or a list of them;
        ``golden`` the numpy arrays they are held to within ``tol``."""
        golden = golden if isinstance(golden, (list, tuple)) else [golden]
        p = plain()
        p = list(p) if isinstance(p, (list, tuple)) else [p]
        if on_card:
            k = kernel()
            k = list(k) if isinstance(k, (list, tuple)) else [k]
            torch.cuda.synchronize(dev)
            equal = all(torch.equal(a, b) for a, b in zip(k, p))
            d = max(diff(a, g) for a, g in zip(k, golden))
            record(name, equal and d <= tol,
                   f"kernel {'==' if equal else '!='} plain (bit-equal); "
                   f"max|kernel - golden|={d:.2e} (tol {tol:g}){note}")
        else:
            d = max(diff(a, g) for a, g in zip(p, golden))
            record(name, d <= tol,
                   f"plain version on {dev.type}, no hand kernel ran: "
                   f"max|plain - golden|={d:.2e} (tol {tol:g}){note}")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    # coords mode on a smooth field (sin / cos), with and without grads
    N = 64 if fast else 192
    vol = rng.normal(size=(N, N, N)).astype(np.float32)
    zz, yy, xx = np.mgrid[0:N, 0:N, 0:N].astype(np.float32)
    cz = zz + 3.0 * np.sin(xx / 40)
    cy = yy - 2.5 * np.cos(zz / 30)
    cx = xx + 2.0 * np.sin(yy / 50)
    del zz, yy, xx
    vt, czt, cyt, cxt = t(vol), t(cz), t(cy), t(cx)
    kernel_check(
        "warp_dvf", lambda: warp.field_warp(vt, czt, cyt, cxt, 0.0),
        lambda: warp.field_warp_xla(vt, czt, cyt, cxt, 0.0),
        _trilinear_host(vol, cz, cy, cx, 0.0), _WARP_TOL)
    kernel_check(
        "warp_coords_grads",
        lambda: torch.ops.mia_torch.warp_coords(vt[None], czt, cyt, cxt,
                                                0.0, True),
        lambda: warp.warp_coords_plain(vt[None], czt, cyt, cxt, 0.0, True),
        [g[None] for g in _trilinear_host(vol, cz, cy, cx, 0.0, True)],
        _GRAD_TOL, "; out, gz, gy, gx")
    del vol, cz, cy, cx, vt, czt, cyt, cxt

    # the fused modes: disp, then affine
    volm = rng.normal(size=(21, 29, 71)).astype(np.float32)
    disp = rng.normal(scale=2.0, size=(3, 18, 27, 66)).astype(np.float32)
    bz, by, bx = np.meshgrid(*(np.arange(n, dtype=np.float32)
                               for n in disp.shape[1:]), indexing="ij")
    volm_t, disp_t = t(volm), t(disp)

    kernel_check(
        "warp_disp_mode", lambda: warp.warp_disp_jit(volm_t, disp_t, 0.25),
        lambda: warp.warp_disp_plain(volm_t[None], disp_t, 0.25)[0][0],
        _trilinear_host(volm, bz + disp[2], by + disp[1], bx + disp[0],
                        0.25), _WARP_TOL)

    A = np.eye(4, dtype=np.float32)
    A[:3, :3] += rng.normal(scale=0.05, size=(3, 3)).astype(np.float32)
    A[:3, 3] = [2.5, -1.0, 0.5]
    out_shape = (17, 30, 70)
    coef = [float(v) for v in A[:3].reshape(-1)]
    ca, cb, cc = (c.cpu().numpy() for c in warp.affine_coords(
        torch.as_tensor(A), out_shape))
    golden_a = _trilinear_host(volm, ca, cb, cc, -3001.0)
    kernel_check(
        "warp_affine_mode",
        lambda: warp.affine_warp_fused(volm_t, A, -3001.0, out_shape),
        lambda: warp.warp_affine_plain(volm_t[None], coef, out_shape,
                                       -3001.0)[0],
        golden_a, _AFFINE_TOL)

    # the separable path: a x3 upsampling, off-diagonals 0 (no draw from
    # rng, so the JAX fixtures that follow keep their values)
    A3 = np.diag([1 / 3, 1 / 3, 1 / 3, 1]).astype(np.float32)
    A3[:3, 3] = [-0.5, 0.25, -0.25]
    up_shape = tuple(3 * n - 2 for n in volm.shape)
    coef3 = [float(v) for v in A3[:3].reshape(-1)]
    c3 = [c.cpu().numpy() for c in warp.affine_coords(torch.as_tensor(A3),
                                                      up_shape)]
    kernel_check(
        "warp_affine_axis",
        lambda: warp.affine_warp_fused(volm_t, A3, -3001.0, up_shape),
        lambda: warp.warp_affine_plain(volm_t[None], coef3, up_shape,
                                       -3001.0)[0],
        _trilinear_host(volm, *c3, -3001.0), _AFFINE_TOL,
        f"; a x3 upsampling to {up_shape}, on the "
        f"{warp.affine_path(coef3)} entry")
    del c3

    # the one-float-at-a-time path at the affine fixture's coordinates:
    # odd Xo, and rows off an 8-byte boundary
    cat, cbt, cct = t(ca), t(cb), t(cc)
    odd = [c[..., :69].contiguous() for c in (cat, cbt, cct)]
    shifted = [_misaligned(c) for c in (cat, cbt, cct)]
    kernel_check(
        "warp_affine_tz16",
        lambda: [warp.field_warp(volm_t, *odd, -3001.0),
                 warp.field_warp(volm_t, *shifted, -3001.0)],
        lambda: [warp.field_warp_xla(volm_t, *odd, -3001.0),
                 warp.field_warp_xla(volm_t, *shifted, -3001.0)],
        [golden_a[..., :69], golden_a], _AFFINE_TOL,
        "; the JAX key pins the TPU's 16-row tile, which the CUDA kernel "
        "lacks: here the coords mode's scalar path (Xo = 69, and rows "
        "4 bytes off an 8-byte boundary) at the affine fixture")
    del cat, cbt, cct, odd, shifted

    # the oblique entry: 45 degrees about z, V2 + affine_shear
    R = Rotation.from_euler("z", 45, degrees=True).as_matrix()
    Ao = np.eye(4)
    Ao[:3, :3] = R
    c = np.array([volm.shape[2] / 2, volm.shape[1] / 2, volm.shape[0] / 2])
    Ao[:3, 3] = c - R @ c
    plan = warp.oblique_plan(Ao, volm.shape)
    if plan is None:
        record("warp_oblique_shear", False, "plan unexpectedly None")
    else:
        Ao32 = Ao.astype(np.float32)
        co = [x.cpu().numpy() for x in warp.affine_coords(
            torch.as_tensor(Ao32), volm.shape)]
        kernel_check(
            "warp_oblique_shear",
            lambda: warp.affine_warp_oblique(volm_t, Ao32, -3001.0,
                                             volm.shape, plan),
            lambda: warp.warp_affine_plain(
                volm_t[None], [float(v) for v in Ao32[:3].reshape(-1)],
                volm.shape, -3001.0)[0],
            _trilinear_host(volm, *co, -3001.0), _AFFINE_TOL,
            "; the plain version is the direct affine sample")

    # the disp sampler's VJP: fused gradients against autograd
    sub = volm_t[:12, :16, :40].contiguous()
    disp_s = t(0.8 * rng.normal(size=(3, 12, 16, 40)).astype(np.float32))

    def sampler_vjp():
        d = disp_s.clone().requires_grad_(True)
        (warp.make_disp_sampler(sub, 0.0)(d) ** 2).sum().backward()
        return d.grad

    def plain_vjp():
        out, gz, gy, gx = warp.warp_disp_plain(sub[None], disp_s, 0.0, True)
        g = 2.0 * out
        return torch.stack([(g * gx).sum(0), (g * gy).sum(0),
                            (g * gz).sum(0)])

    d = disp_s.clone().requires_grad_(True)
    (warp.warp_disp_plain(sub[None], d, 0.0)[0] ** 2).sum().backward()
    kernel_check("warp_disp_vjp", sampler_vjp, plain_vjp,
                 d.grad.cpu().numpy(), _VJP_TOL,
                 "; the golden: torch.autograd through warp_disp_plain")
    del volm_t, disp_t, sub, disp_s, d

    # lane_interp, bit-equal to the host golden
    data = rng.normal(size=(37, 90)).astype(np.float32)
    pos = rng.uniform(-2, 92, size=(37, 104)).astype(np.float32)
    kernel_check("lane_interp",
                 lambda: lane_interp.lane_interp(t(data), t(pos)),
                 lambda: lane_interp.lane_interp_plain(t(data), t(pos)),
                 _lane_interp_host(data, pos), 0.0)

    # the DVH histogram, equal to the numpy count
    dose = rng.uniform(0, 70, size=20_000).astype(np.float32)
    valid = (rng.random(20_000) > 0.3).astype(np.float32)
    thr = np.linspace(0, 70, 64).astype(np.float32)
    kernel_check(
        "dvh_histogram",
        lambda: hist.dose_below_histogram(t(dose), t(valid), t(thr)),
        lambda: hist._hist_plain(t(dose), t(valid), t(thr)),
        np.asarray([np.sum((dose < x) & (valid > 0)) for x in thr]), 0.0)

    # 12-bit packing: host pack, unpack on the device
    arr = rng.integers(-1000, 3000, size=(3, 9, 40)).astype(np.int16)
    words, lo, tail = bitpack.pack12(arr)
    got = bitpack.unpack12_device(words, lo, tail, dtype=torch.int32,
                                  device=dev).cpu().numpy()
    record("bitpack12", np.array_equal(got, arr.astype(np.int32)),
           f"unpack12_device on {dev.type} (plain PyTorch)")

    # the exact EDT against scipy
    m = ndimage.binary_dilation(rng.random((18, 22, 16)) > 0.97,
                                iterations=2)
    m[9, 11, 8] = True                          # never empty
    sp = (0.9, 1.1, 2.4)
    golden = ndimage.distance_transform_edt(~m,
                                            sampling=(sp[2], sp[1], sp[0]))
    dd = diff(edt.edt(m, sp, device=dev), golden)
    record("edt_exact", dd < _EDT_TOL,
           f"ops.edt on {dev.type} (plain PyTorch) against scipy: "
           f"max|diff|={dd:.2e}")

    # the rasterizer against the host fill (and cv2 where it imports)
    r2 = np.random.default_rng(7)
    th = np.sort(r2.uniform(0, 2 * np.pi, 17))
    star = np.stack([24 + r2.uniform(3, 14, 17) * np.cos(th),
                     20 + r2.uniform(3, 14, 17) * np.sin(th)], axis=1)
    got_r = rasterize.rasterize_polygons([star], [1], 3, 40, 44, device=dev)
    goldens = {"the host fill": _fill_polygon_host(star, 40, 44)}
    try:
        import cv2
    except ImportError:                # the card's machine has no cv2
        cv2 = None
    if cv2 is not None:
        goldens["cv2.fillPoly"] = np.zeros((40, 44), np.uint8)
        cv2.fillPoly(goldens["cv2.fillPoly"],
                     [np.trunc(star + 1e-6).astype(np.int32)], 1)
    record("raster_tile_xor",
           all(np.array_equal(got_r[1], g) for g in goldens.values())
           and got_r[0].sum() == 0 and got_r[2].sum() == 0,
           f"rasterize_polygons on {dev.type} (plain PyTorch) against "
           + " and ".join(goldens))

    # the device voxelizer against the host float64 twin
    zz, yy, xx = np.mgrid[0:10, 0:14, 0:12].astype(np.float64)
    blob = (((zz - 5) / 3.5) ** 2 + ((yy - 7) / 5) ** 2
            + ((xx - 6) / 4) ** 2) <= 1.0
    vmesh = marching_cubes.mask_to_mesh(blob.astype(np.uint8), [1, 1, 1],
                                        [0, 0, 0], np.eye(3), device=dev)
    pts = np.asarray(vmesh.points, np.float64)
    vdims = (10, 14, 12)
    vg = host_voxelize.voxelize_mesh(pts, vmesh.faces, vdims,
                                     backend="host")
    vd = voxelize.voxelize_mesh_device(pts, vmesh.faces, vdims, device=dev)
    record("voxelize_parity", np.array_equal(vd, vg) and vg.sum() > 50,
           f"voxelize_mesh_device on {dev.type} (plain PyTorch) against "
           f"the host float64 twin: {int(vg.sum())} voxels")

    if not fast:
        # one bin past 2^24 voxels: exact in int64
        n = _LARGE_BIN
        big_dose = torch.full((n,), 1.0, device=dev)
        big_valid = torch.ones(n, device=dev)
        big_thr = torch.tensor([0.5, 2.0], device=dev)
        kernel_check(
            "dvh_histogram_large",
            lambda: hist.dose_below_histogram(big_dose, big_valid, big_thr),
            lambda: hist._hist_plain(big_dose, big_valid, big_thr),
            np.asarray([0, n]), 0.0,
            f"; {n} voxels in one bin (> 2^24, where float32 counts lose "
            "units)")
        del big_dose, big_valid

    return {"backend": dev.type, "ok": all(checks.values()),
            "checks": checks, "detail": detail}
