"""Volume filters: Gaussian, morphology, windowing, components, intensity
standardisation and edge-preserving smoothing.

Port of medicalimageanalysis_tpu/ops/filters.py, the whole module:

- ``gauss_taps``, ``_gauss_kernel_matrix``, ``gaussian_filter``: the blur
  as three dense matrix contractions in full float32
  (``resample._separable_apply``, cuBLAS on the card);
- ``binary_erode`` / ``dilate`` / ``open`` / ``close``: min / max pools
  with the XLA ``SAME`` padding, (Z, Y, X) or batched (B, Z, Y, X);
- ``window_level``;
- ``largest_component`` and ``fill_holes_2d``: scipy on the host, as in
  the JAX package;
- ``_label_prop_largest`` / ``largest_component_batch``: 26-connected
  label propagation on the device, an exact int32 3x3x3 min filter
  repeated until a fixed point; the JAX ``lax.while_loop`` becomes a loop
  that reads one device flag per sweep;
- ``histogram_match`` (quantile tables on the host, the mapping by
  :func:`interp` on the device), ``anisotropic_diffusion`` and
  ``curvature_flow`` (stencil loops on the device).

Arrays go to ``default_device()``; a tensor stays on its device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import default_device
from .resample import _separable_apply


__all__ = ["gaussian_filter", "binary_erode", "binary_dilate",
           "binary_open", "binary_close", "window_level",
           "largest_component", "largest_component_batch",
           "fill_holes_2d", "histogram_match", "anisotropic_diffusion",
           "curvature_flow", "interp"]


def gauss_taps(sigma_vox, dtype=np.float32):
    """Normalized 1-D Gaussian taps truncated at 4 sigma ->
    (taps (2r+1,), radius)."""
    radius = max(1, int(np.ceil(4 * sigma_vox)))
    offsets = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (offsets / sigma_vox) ** 2)
    return (k / k.sum()).astype(dtype), radius


def _gauss_kernel_matrix(n, sigma_vox, dtype=np.float32):
    """(n, n) Toeplitz Gaussian matrix: out = G @ x along one axis;
    edge-replicated, truncated at 4 sigma."""
    k64, radius = gauss_taps(sigma_vox, dtype=np.float64)
    offsets = np.arange(-radius, radius + 1)
    m = np.zeros((n, n), dtype=np.float64)
    idx = np.arange(n)
    for off, w in zip(offsets, k64):
        src = np.clip(idx + off, 0, n - 1)  # edge-replicate
        np.add.at(m, (idx, src), w)
    return m.astype(dtype)


def gaussian_filter(volume, sigma_mm, spacing_xyz=(1.0, 1.0, 1.0)):
    """Separable Gaussian blur; sigma in mm, converted per axis to voxels
    (sitk SmoothingRecursiveGaussian semantics). volume (Z, Y, X) array
    or tensor -> float32 tensor on the tensor's device (the CPU for an
    array)."""
    vol = torch.as_tensor(volume).to(torch.float32)
    if np.isscalar(sigma_mm):
        sigma_mm = [sigma_mm] * 3
    sig = (sigma_mm[2] / spacing_xyz[2], sigma_mm[1] / spacing_xyz[1],
           sigma_mm[0] / spacing_xyz[0])
    mz, my, mx = (torch.as_tensor(_gauss_kernel_matrix(n, max(sv, 1e-3)),
                                  device=vol.device)
                  for n, sv in zip(vol.shape, sig))
    return _separable_apply(vol, mz, my, mx)


def _on_device(a, dtype):
    """``a`` as a ``dtype`` tensor: a tensor stays on its device, anything
    else goes to ``default_device()``."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype)
    return torch.as_tensor(np.asarray(a), device=default_device()).to(dtype)


def _pool(vol, size, fn, fill):
    """3-D ``size``-cube pool over the last three axes with XLA's 'SAME'
    padding (low (size-1)//2, high the rest) of ``fill``."""
    lo = (size - 1) // 2
    hi = size - 1 - lo
    x = vol.reshape((-1, 1) + tuple(vol.shape[-3:]))
    x = F.pad(x, (lo, hi, lo, hi, lo, hi), value=fill)
    return fn(x, size, stride=1).reshape(vol.shape)


def _minpool(vol, size):
    return -_pool(-vol, size, F.max_pool3d, -float("inf"))


def _maxpool(vol, size):
    return _pool(vol, size, F.max_pool3d, -float("inf"))


def binary_erode(mask, size=3, iterations=1):
    """Erosion as a min-pool; (Z, Y, X) or batched (B, Z, Y, X) -> uint8
    numpy array."""
    out = _on_device(mask, torch.float32)
    for _ in range(iterations):
        out = _minpool(out, size)
    return (out > 0.5).to(torch.uint8).cpu().numpy()


def binary_dilate(mask, size=3, iterations=1):
    """Dilation as a max-pool; (Z, Y, X) or batched (B, Z, Y, X) -> uint8
    numpy array."""
    out = _on_device(mask, torch.float32)
    for _ in range(iterations):
        out = _maxpool(out, size)
    return (out > 0.5).to(torch.uint8).cpu().numpy()


def binary_open(mask, size=3):
    return binary_dilate(binary_erode(mask, size), size)


def binary_close(mask, size=3):
    return binary_erode(binary_dilate(mask, size), size)


def window_level(volume, window):
    """Normalise to [0, 1] within the [lower, upper] display window; a
    float32 tensor on the device."""
    vol = _on_device(volume, torch.float32)
    lower = torch.tensor(np.float32(window[0]), device=vol.device)
    upper = torch.tensor(np.float32(window[1]), device=vol.device)
    return torch.clamp((vol - lower) / (upper - lower), 0.0, 1.0)


def largest_component(binary, connectivity_full=True):
    """Largest connected component (host scipy labelling; the reference's
    skimage.measure.label defaults to full connectivity). Returns (mask,
    its bounding slices or None)."""
    from scipy import ndimage

    binary = np.asarray(binary) > 0
    structure = np.ones((3,) * binary.ndim) if connectivity_full else None
    labels, n = ndimage.label(binary, structure=structure)
    if n == 0:
        return np.zeros_like(binary, dtype=bool), None
    counts = np.bincount(labels.ravel())
    counts[0] = 0
    biggest = int(np.argmax(counts))
    mask = labels == biggest
    slices = ndimage.find_objects((labels == biggest).astype(np.int8))
    return mask, slices[0] if slices else None


def fill_holes_2d(mask2d):
    from scipy import ndimage
    return ndimage.binary_fill_holes(mask2d)


def _min3(lab):
    """Exact 3x3x3 box minimum over the last three axes of an int32
    tensor, nothing outside: three separable 3-tap passes."""
    for ax in (-3, -2, -1):
        n = lab.shape[ax]
        out = lab.clone()
        if n > 1:
            lo = lab.narrow(ax, 0, n - 1)
            hi = lab.narrow(ax, 1, n - 1)
            out.narrow(ax, 1, n - 1).copy_(torch.minimum(
                out.narrow(ax, 1, n - 1), lo))
            out.narrow(ax, 0, n - 1).copy_(torch.minimum(
                out.narrow(ax, 0, n - 1), hi))
        lab = out
    return lab


def _label_prop_largest(mask):
    """Largest 26-connected component of each (Z, Y, X) bool mask of the
    batch ``mask`` (B, Z, Y, X) by label propagation (JAX
    ops/filters.py:206-247): every masked voxel starts at its flat index
    and takes the minimum over its 3x3x3 neighbourhood until no label
    changes, one device flag read a sweep (a finished mask stays fixed
    while the others sweep). Returns (bool masks (B, Z, Y, X), the
    component sizes (B,))."""
    B, Z, Y, X = mask.shape
    n = Z * Y * X
    big = torch.tensor(n, dtype=torch.int32, device=mask.device)
    idx = torch.arange(n, dtype=torch.int32,
                       device=mask.device).reshape(1, Z, Y, X)
    lab = torch.where(mask, idx, big)

    def sweep(lab):
        return torch.where(mask, torch.minimum(lab, _min3(lab)), big)

    lab = sweep(lab)
    while True:
        new = sweep(lab)
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            break
    outs, sizes = [], []
    for b in range(B):
        counts = torch.bincount(lab[b][mask[b]].reshape(-1).to(torch.int64),
                                minlength=n)
        best = int(torch.argmax(counts))
        outs.append((lab[b] == best) & mask[b])
        sizes.append(int(counts[best]))
    return torch.stack(outs), sizes


def largest_component_batch(masks):
    """Device largest 26-connected component of a binary mask (Z, Y, X)
    or of each of a batch (B, Z, Y, X), the cohort counterpart of
    :func:`largest_component`. Returns a bool numpy array."""
    m = masks > 0 if isinstance(masks, torch.Tensor) \
        else _on_device(np.asarray(masks) > 0, torch.bool)
    if m.dim() == 3:
        return _label_prop_largest(m[None])[0][0].cpu().numpy()
    return _label_prop_largest(m)[0].cpu().numpy()


def interp(x, xp, fp):
    """``jnp.interp`` on tensors: piecewise-linear ``fp`` over sorted
    knots ``xp`` at ``x``, constant beyond the ends, in its operation
    order. ``xp`` / ``fp`` (K,) with any ``x``, or (B, K) with ``x``
    (B, ...), each row its own table."""
    batched = xp.dim() == 2
    xs = x.reshape(x.shape[0], -1) if batched else x.reshape(-1)
    K = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp, xs.contiguous(), right=True),
                    1, K - 1)
    xp0, xp1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    fp0, fp1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    df = fp1 - fp0
    dx = xp1 - xp0
    delta = xs - xp0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp0, fp0 + (delta / torch.where(
        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(xs < xp[..., :1], fp[..., :1], f)
    f = torch.where(xs > xp[..., -1:], fp[..., -1:], f)
    return f.reshape(x.shape)


def histogram_match(moving, reference, n_quantiles=256,
                    exclude_below=None, max_samples=1 << 20):
    """Quantile-mapping intensity standardisation (JAX
    ops/filters.py:276-337): ``moving``'s intensity distribution mapped
    onto ``reference``'s. The two quantile tables are estimated on the
    host from up to ``max_samples`` strided samples; the per-voxel
    piecewise-linear mapping runs on the device (:func:`interp`).
    ``exclude_below`` drops background from both tables while still
    mapping every voxel. Returns a float32 tensor shaped like
    ``moving``."""
    mov_np = np.asarray(moving, np.float32)
    ref_np = np.asarray(reference, np.float32)

    def table(a):
        flat = a.reshape(-1)
        if exclude_below is not None:
            flat = flat[flat >= exclude_below]
            if flat.size == 0:
                raise ValueError(
                    "histogram_match: exclude_below removed every voxel")
        if flat.size > max_samples:
            flat = flat[:: flat.size // max_samples + 1]
        q = np.linspace(0.0, 1.0, int(n_quantiles), dtype=np.float64)
        return np.quantile(flat, q).astype(np.float32)

    mov_q = table(mov_np)
    ref_q = table(ref_np)
    # a strictly increasing source table for a well-defined inverse CDF:
    # spread in float64, then enforce strictness knot by knot in float32
    # with nextafter (a range-scaled epsilon alone falls below float32
    # resolution at large magnitudes and re-collapses flat runs)
    eps = np.maximum(1e-6, 1e-6 * float(mov_q[-1] - mov_q[0]))
    mov_q = np.maximum.accumulate(mov_q.astype(np.float64))
    mov_q = (mov_q + np.arange(len(mov_q)) * eps).astype(np.float32)
    for i in range(1, len(mov_q)):
        if mov_q[i] <= mov_q[i - 1]:
            mov_q[i] = np.nextafter(mov_q[i - 1], np.float32(np.inf),
                                    dtype=np.float32)

    dev = moving.device if isinstance(moving, torch.Tensor) \
        else default_device()
    return interp(torch.as_tensor(mov_np, device=dev),
                  torch.as_tensor(mov_q, device=dev),
                  torch.as_tensor(ref_q, device=dev))


def _check_3d(name, vol):
    if vol.dim() != 3:
        raise ValueError(f"{name}: expected (Z, Y, X), got "
                         f"{tuple(vol.shape)}")


@torch.no_grad()
def anisotropic_diffusion(volume, iterations=5, kappa=20.0,
                          time_step=None, spacing_xyz=(1.0, 1.0, 1.0),
                          conductance="exp"):
    """Perona-Malik edge-preserving smoothing (JAX ops/filters.py:
    340-404, ITK's GradientAnisotropicDiffusionImageFilter): per
    iteration each axis' forward-difference flux is gated by a
    conductance of the physical gradient df/h ('exp' or 'reciprocal').
    ``kappa`` is in intensity per mm; ``time_step`` defaults to the 3-D
    stability bound 1 / (2 sum 1/sp^2). Returns a float32 tensor."""
    vol = _on_device(volume, torch.float32)
    _check_3d("anisotropic_diffusion", vol)
    if conductance not in ("exp", "reciprocal"):
        raise ValueError(f"anisotropic_diffusion: unknown conductance "
                         f"{conductance!r}")
    sp = np.asarray(spacing_xyz, np.float64)
    sp2_inv = torch.as_tensor((1.0 / sp ** 2).astype(np.float32),
                              device=vol.device)
    sp_inv = torch.sqrt(sp2_inv)
    if time_step is None:
        time_step = 1.0 / (2.0 * float((1.0 / sp ** 2).sum()))
    kappa = torch.tensor(np.float32(kappa), device=vol.device)
    time_step = torch.tensor(np.float32(time_step), device=vol.device)

    v = vol
    for _ in range(int(iterations)):
        upd = torch.zeros_like(v)
        for axis, k in ((0, 2), (1, 1), (2, 0)):
            n = v.shape[axis]
            # forward difference, zero flux past the last face (Neumann)
            df = torch.zeros_like(v)
            df.narrow(axis, 0, n - 1).copy_(torch.diff(v, dim=axis))
            grad = df * sp_inv[k]
            if conductance == "exp":
                c = torch.exp(-(grad / kappa) ** 2)
            else:
                c = 1.0 / (1.0 + (grad / kappa) ** 2)
            fl = c * df
            fb = torch.zeros_like(v)
            fb.narrow(axis, 1, n - 1).copy_(fl.narrow(axis, 0, n - 1))
            upd = upd + (fl - fb) * sp2_inv[k]
        v = v + time_step * upd
    return v


@torch.no_grad()
def curvature_flow(volume, iterations=5, time_step=0.05,
                   spacing_xyz=(1.0, 1.0, 1.0)):
    """Level-set curvature flow denoising (JAX ops/filters.py:407-451,
    ITK's CurvatureFlowImageFilter): each iso-surface moves with its
    mean curvature, dI/dt = kappa |grad I|, by central-difference
    stencils. Returns a float32 tensor."""
    vol = _on_device(volume, torch.float32)
    _check_3d("curvature_flow", vol)
    sp = torch.as_tensor(np.asarray(spacing_xyz, np.float32),
                         device=vol.device)
    time_step = torch.tensor(np.float32(time_step), device=vol.device)
    eps = 1e-8

    def g(v, axis):
        return torch.gradient(v, dim=axis)[0] / sp[2 - axis]

    v = vol
    for _ in range(int(iterations)):
        ix = g(v, 2)
        iy = g(v, 1)
        iz = g(v, 0)
        ixx = g(ix, 2)
        iyy = g(iy, 1)
        izz = g(iz, 0)
        ixy = g(ix, 1)
        ixz = g(ix, 0)
        iyz = g(iy, 0)
        g2 = ix * ix + iy * iy + iz * iz
        num = (ixx * (iy * iy + iz * iz)
               + iyy * (ix * ix + iz * iz)
               + izz * (ix * ix + iy * iy)
               - 2.0 * (ix * iy * ixy + ix * iz * ixz + iy * iz * iyz))
        v = v + time_step * num / (g2 + eps)
    return v
