"""N4-style MR bias field correction.

Port of medicalimageanalysis_tpu/ops/n4.py (Tustison et al., IEEE TMI
2010). Each iteration of a fitting level sharpens the masked
log-intensity histogram (Wiener deconvolution of a Gaussian bias kernel,
``torch.fft``), maps every voxel to its expected true intensity E[u|v],
fits the residual with the exact weighted least-squares cubic B-spline
(Jacobi-preconditioned conjugate gradients whose normal operator is six
separable contractions, run in full float32), and subtracts; the control
spacing halves per level. The JAX package's ``lax.while_loop`` over a
level becomes a loop that reads one device flag per iteration, and the
CG a loop that reads one every ``_CG_CHECK`` steps; both keep the JAX
package's ``active`` gates, so a lane (a volume of ``n4_batch``'s batch)
that has converged stays frozen while the others iterate, and extra
gated steps change nothing.

Every device function takes a leading batch axis (B, Z, Y, X): one
volume is a batch of one. The state stays on the device between
iterations; the finish (separable trilinear upsample of the shrunk log
field, exponentiate, divide) runs on the volume's device. The host
float64 twins (``_sharpen_from_hist``, ``_host_wls_fit_apply``,
``_host_n4_level``, ``_host_upsample``, ``_host_finalize``) are the plain
references the tests and ``chip_smoke.py`` hold the device path to.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import default_device, full_float32
from .filters import interp

__all__ = ["n4_bias_correction", "bspline_smooth_field"]

_EPS = 1e-12
_CG_STEPS = 150
_CG_CHECK = 10           # CG steps between reads of the device flag


def _bspline_basis_matrix(length, spacing_vox, power=1):
    """Dense (length, n_ctrl) cubic B-spline evaluation matrix for a
    uniform control grid of ``spacing_vox`` voxels (one border control
    each side); ``power`` raises the entries elementwise."""
    u = np.arange(length, dtype=np.float64) / float(spacing_vox)
    i = np.floor(u).astype(int)
    t = u - i
    b0 = (1 - t) ** 3 / 6.0
    b1 = (3 * t ** 3 - 6 * t ** 2 + 4) / 6.0
    b2 = (-3 * t ** 3 + 3 * t ** 2 + 3 * t + 1) / 6.0
    b3 = t ** 3 / 6.0
    # +4: the last partial cell still references controls i..i+3
    n_ctrl = int(np.floor((length - 1) / spacing_vox)) + 4
    m = np.zeros((length, n_ctrl), np.float64)
    for k, bk in enumerate((b0, b1, b2, b3)):
        cols = np.clip(i + k, 0, n_ctrl - 1)
        np.add.at(m, (np.arange(length), cols), bk)
    return m ** power


def _bspline_eval(phi, bz, by, bx):
    f = torch.einsum("bcde,zc->bzde", phi, bz)
    f = torch.einsum("bzde,yd->bzye", f, by)
    return torch.einsum("bzye,xe->bzyx", f, bx)


def _bspline_adjoint(vol, bz, by, bx):
    g = torch.einsum("bzyx,zc->bcyx", vol, bz)
    g = torch.einsum("bcyx,yd->bcdx", g, by)
    return torch.einsum("bcdx,xe->bcde", g, bx)


def _lane_sum(t):
    return t.sum(dim=(1, 2, 3))


def _lanes(v):
    """(B,) -> (B, 1, 1, 1) for broadcasting over a lane's volume."""
    return v[:, None, None, None]


@full_float32()
def _wls_fit_apply(vol_r, w, bz, by, bx, bz2, by2, bx2):
    """Exact weighted least-squares cubic B-spline fit of each lane of
    ``vol_r`` (B, Z, Y, X) under the weights ``w``, evaluated back on the
    voxel grid (JAX ops/n4.py:89-137): Jacobi-preconditioned CG on the
    normal operator A phi = B^T W (B phi) + lam phi, to a 1e-10 relative
    preconditioned residual or 150 steps, each lane's update gated on
    its own carried rz."""
    b = _bspline_adjoint(w * vol_r, bz, by, bx)
    diag = _bspline_adjoint(w, bz2, by2, bx2)
    lam = 1e-5 * torch.clamp(diag.amax(dim=(1, 2, 3)), min=_EPS)
    diag = diag + _lanes(lam)

    def a_op(phi):
        return _bspline_adjoint(w * _bspline_eval(phi, bz, by, bx),
                                bz, by, bx) + _lanes(lam) * phi

    x = torch.zeros_like(b)
    r = b
    z = r / diag
    p = z
    rz = _lane_sum(r * z)
    stop = 1e-10 * rz
    for i in range(_CG_STEPS):
        active = rz > stop
        if i % _CG_CHECK == 0 and not bool(active.any()):
            break
        ap = a_op(p)
        denom = _lane_sum(p * ap)
        alpha = torch.where(denom > 0, rz / torch.clamp(denom, min=_EPS),
                            torch.zeros_like(rz))
        x_n = x + _lanes(alpha) * p
        r_n = r - _lanes(alpha) * ap
        z = r_n / diag
        rz_n = _lane_sum(r_n * z)
        beta = torch.where(rz > 0, rz_n / torch.clamp(rz, min=_EPS),
                           torch.zeros_like(rz))
        p_n = z + _lanes(beta) * p
        a4 = _lanes(active)
        x = torch.where(a4, x_n, x)
        r = torch.where(a4, r_n, r)
        p = torch.where(a4, p_n, p)
        rz = torch.where(active, rz_n, rz)
    return _bspline_eval(x, bz, by, bx)


def bspline_smooth_field(residual, weights, spacing_vox, passes=None,
                         device=None):
    """Smooth a (masked) residual volume onto a cubic B-spline field with
    control spacing ``spacing_vox`` (scalar or per-axis voxels): the
    exact least-squares projection onto the spline space under the voxel
    weights, on ``device`` (default: ``default_device()``). ``passes`` is
    accepted and ignored (CG solves to convergence). Returns float64
    numpy."""
    del passes
    device = default_device() if device is None else torch.device(device)
    r = torch.as_tensor(np.asarray(residual, np.float32), device=device)
    w = torch.as_tensor(np.asarray(weights, np.float32), device=device)
    sv = np.broadcast_to(np.asarray(spacing_vox, np.float64), (3,))
    mats = _level_basis_mats(tuple(r.shape), sv, device)
    out = _wls_fit_apply(r[None], w[None], *mats)[0]
    return out.cpu().numpy().astype(np.float64)


def _masked_hist(res, w, n_bins):
    """Weighted histogram of each lane's masked residual over its own
    data range, the bin index ((res - vmin) / width) cast to int32 in the
    JAX package's order (JAX ops/n4.py:155-166). Returns (hist (B,
    n_bins), vmin (B,), vmax (B,))."""
    B = res.shape[0]
    big = torch.tensor(3.4e38, dtype=torch.float32, device=res.device)
    on = w > 0
    vmin = torch.where(on, res, big).amin(dim=(1, 2, 3))
    vmax = torch.where(on, res, -big).amax(dim=(1, 2, 3))
    width = torch.clamp(vmax - vmin, min=1e-9) / n_bins
    idx = torch.clamp(((res - _lanes(vmin)) / _lanes(width))
                      .to(torch.int32), 0, n_bins - 1).to(torch.int64)
    idx = idx + torch.arange(B, device=res.device)[:, None, None, None] \
        * n_bins
    hist = torch.zeros(B * n_bins, dtype=torch.float32, device=res.device)
    hist.index_add_(0, idx.reshape(-1), w.reshape(-1))
    return hist.reshape(B, n_bins), vmin, vmax


def _fft_size(n_bins):
    n_pad = 1
    while n_pad < 2 * n_bins:
        n_pad <<= 1
    return n_pad


def _device_sharpen(h, vmin, vmax, n_bins, fwhm, noise):
    """Wiener deconvolution of each lane's histogram (B, n_bins) by the
    Gaussian bias kernel and the E[u|v] table over the bin centres
    (JAX ops/n4.py:169-200), by ``torch.fft`` over the padded bin axis.
    Returns (centers, mapping), each (B, n_bins)."""
    dev = h.device
    binw = torch.clamp(vmax - vmin, min=1e-9) / n_bins
    centers = vmin[:, None] + (torch.arange(
        n_bins, dtype=torch.float32, device=dev) + 0.5) * binw[:, None]
    n_pad = _fft_size(n_bins)
    sigma = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    d = torch.arange(n_pad, dtype=torch.float32, device=dev)
    d = torch.minimum(d, n_pad - d) * binw[:, None]
    g = torch.exp(-0.5 * (d / np.float32(sigma)) ** 2)
    g = g / g.sum(dim=1, keepdim=True)
    gf = torch.fft.fft(g)
    hf = torch.fft.fft(h, n_pad)
    wiener = torch.conj(gf) / (torch.abs(gf) ** 2 + noise ** 2)
    u_hist = torch.clamp(torch.fft.ifft(hf * wiener).real[:, :n_bins],
                         min=0.0)
    uf = torch.fft.fft(u_hist, n_pad)
    uuf = torch.fft.fft(u_hist * centers, n_pad)
    den = torch.fft.ifft(uf * gf).real[:, :n_bins]
    num = torch.fft.ifft(uuf * gf).real[:, :n_bins]
    mapping = torch.where(den > _EPS, num / torch.clamp(den, min=_EPS),
                          centers)
    # a flat residual range or an empty sharpened histogram falls back to
    # the identity mapping
    degenerate = ((vmax - vmin < 1e-9) | (u_hist.sum(dim=1) <= 0))
    return centers, torch.where(degenerate[:, None], centers, mapping)


@torch.no_grad()
def _n4_level(res, total, w, n_bins, fwhm, noise, conv_threshold,
              max_iter, *mats):
    """One N4 fitting level over the lanes of res / total / w (B, Z, Y,
    X) (JAX ops/n4.py:203-243): sharpen -> E[u|v] -> WLS smooth ->
    subtract until the field update's coefficient of variation falls
    below ``conv_threshold`` or ``max_iter``. One device flag read per
    iteration; each lane's update is gated on its own carried CV, so a
    lane that converged keeps its state while the others iterate."""
    n = torch.clamp(_lane_sum(w), min=1.0)
    cv_prev = torch.full((res.shape[0],), 1e9, dtype=torch.float32,
                         device=res.device)
    for _ in range(int(max_iter)):
        active = cv_prev >= conv_threshold
        if not bool(active.any()):
            break
        h, vmin, vmax = _masked_hist(res, w, n_bins)
        centers, mapping = _device_sharpen(h, vmin, vmax, n_bins, fwhm,
                                           noise)
        euv = interp(res, centers, mapping)
        r = torch.where(w > 0, res - euv, torch.zeros_like(res))
        f = _wls_fit_apply(r, w, *mats)
        # the bias is defined up to a global scale
        f = f - _lanes(_lane_sum(f * w) / n)
        ef = torch.exp(f)
        mu = _lane_sum(ef * w) / n
        var = _lane_sum(w * (ef - _lanes(mu)) ** 2) / n
        cv = torch.sqrt(torch.clamp(var, min=0.0)) \
            / torch.clamp(mu, min=_EPS)
        a4 = _lanes(active)
        res = torch.where(a4, res - f, res)
        total = torch.where(a4, total + f, total)
        cv_prev = torch.where(active, cv, cv_prev)
    return res, total


def _level_spacings(shape3, levels, min_control_spacing, shrink):
    """The control-spacing schedule (one (3,) vector per level):
    whole-extent at level 0, halved per level, floored before the mesh
    can resolve anatomy, deduplicated once the floor engages."""
    max_extent = max(shape3)
    floor_sp = np.maximum(
        np.broadcast_to(np.asarray(min_control_spacing, np.float64),
                        (3,)) / shrink, 4.0)
    out = []
    for level in range(levels):
        sp_vox = np.maximum(max_extent / (2.0 ** level), floor_sp)
        if out and np.array_equal(sp_vox, out[-1]):
            break
        out.append(sp_vox)
    return out


def _level_basis_mats(shape3, sp_vox, device):
    """The six (grid, control) basis matrices of one fitting level (B and
    B^2 per axis), float32 on ``device``, in ``_wls_fit_apply`` order."""
    return tuple(torch.as_tensor(_bspline_basis_matrix(n, sp_vox[ax], p),
                                 dtype=torch.float32, device=device)
                 for p in (1, 2) for ax, n in enumerate(shape3))


def _shrunk_log(vol, m_full, shrink):
    """The fit's inputs on the host, in float64 as the JAX package makes
    them: the ``shrink``-subsampled mask and the log of its voxels."""
    sv = vol[::shrink, ::shrink, ::shrink]
    sm = m_full[::shrink, ::shrink, ::shrink]
    logv = np.zeros(sv.shape, np.float64)
    logv[sm] = np.log(sv[sm])
    return logv, sm


def _run_levels(res, w, levels, max_iterations, n_bins, fwhm, noise,
                conv_threshold, min_control_spacing, shrink):
    """Every fitting level over the lanes (B, z, y, x); returns the
    accumulated log field."""
    total = torch.zeros_like(res)
    shape3 = tuple(res.shape[1:])
    for sp_vox in _level_spacings(shape3, levels, min_control_spacing,
                                  shrink):
        mats = _level_basis_mats(shape3, sp_vox, res.device)
        res, total = _n4_level(res, total, w, n_bins, float(fwhm),
                               float(noise), float(conv_threshold),
                               int(max_iterations), *mats)
    return total


def n4_bias_correction(volume, mask=None, shrink=4, n_bins=200,
                       fwhm=0.15, noise=0.01, levels=4,
                       max_iterations=50, conv_threshold=1e-3,
                       min_control_spacing=32.0, return_field=False,
                       device=None):
    """Correct a smooth multiplicative bias field (MR shading).

    volume: (Z, Y, X) positive intensities (non-positive voxels are left
    out of the fit and pass through untouched); mask: optional fit
    region (default: volume > 0); shrink: integer subsampling for the
    fit; levels / max_iterations: fitting levels with the control
    spacing halved per level, iterations gated by ``conv_threshold`` on
    the field update's coefficient of variation; ``min_control_spacing``
    (full-resolution voxels, scalar or per-axis (z, y, x)) floors the
    control mesh. Runs on ``device`` (default: a tensor's own device,
    else ``default_device()``).

    Returns the corrected volume (float32 numpy, same shape), or
    (corrected, field) with the full-resolution multiplicative field
    when ``return_field``: input == corrected * field.
    """
    if isinstance(volume, torch.Tensor):
        device = volume.device if device is None else device
        volume = volume.cpu().numpy()
    device = default_device() if device is None else torch.device(device)
    vol = np.asarray(volume, np.float64)
    if vol.ndim != 3:
        raise ValueError(f"n4_bias_correction: expected (Z, Y, X), "
                         f"got {vol.shape}")
    m_full = (np.ones(vol.shape, bool) if mask is None
              else np.asarray(mask) > 0)
    m_full = m_full & (vol > 0)
    shrink = max(1, int(shrink))
    if not m_full[::shrink, ::shrink, ::shrink].any():
        out = vol.astype(np.float32)
        return (out, np.ones_like(out)) if return_field else out
    corrected, field = _n4_lanes(vol[None], m_full[None], shrink, device,
                                 levels, max_iterations, n_bins, fwhm,
                                 noise, conv_threshold, min_control_spacing)
    if return_field:
        return corrected[0].cpu().numpy(), field[0].cpu().numpy()
    return corrected[0].cpu().numpy()


def _n4_lanes(vols, masks, shrink, device, levels, max_iterations, n_bins,
              fwhm, noise, conv_threshold, min_control_spacing):
    """N4 of B volumes (B, Z, Y, X) numpy under their fit masks (already
    limited to positive voxels): each lane's shrunk log in float64 on the
    host, every level as one batched loop on ``device``, the finish on
    the device. Returns (corrected, field), (B, Z, Y, X) float32 tensors
    on ``device``."""
    lanes = [_shrunk_log(np.asarray(v, np.float64), m, shrink)
             for v, m in zip(vols, masks)]
    res = torch.as_tensor(np.stack([lv for lv, _ in lanes])
                          .astype(np.float32), device=device)
    w = torch.as_tensor(np.stack([sm for _, sm in lanes])
                        .astype(np.float32), device=device)
    total = _run_levels(res, w, levels, max_iterations, n_bins, fwhm,
                        noise, conv_threshold, min_control_spacing, shrink)
    return _n4_finalize(torch.as_tensor(np.asarray(vols, np.float32),
                                        device=device), total, shrink)


def _upsample(lt, out_shape, shrink):
    """Separable trilinear upsample of a shrunk log field (..., z, y, x)
    to the full grid at coordinates k / shrink, edge-clamped, in float32
    on its device: the JAX package's ``map_coordinates(order=1,
    mode='nearest')`` finish, in :func:`_host_upsample`'s form."""
    nd = lt.dim()
    for k, n in enumerate(out_shape):
        ax = nd - 3 + k
        sn = lt.shape[ax]
        u = torch.arange(n, dtype=torch.float32, device=lt.device) / shrink
        u = torch.clamp(u, max=float(sn - 1))
        i0 = torch.clamp(u.to(torch.int64), max=sn - 1)
        i1 = torch.clamp(i0 + 1, max=sn - 1)
        f = (u - i0.to(torch.float32)).reshape(
            [-1 if a == ax else 1 for a in range(nd)])
        lt = (lt.index_select(ax, i0) * (1.0 - f)
              + lt.index_select(ax, i1) * f)
    return lt


def _n4_finalize(vol, total, shrink):
    """Upsample the log field to ``vol``'s grid (leading batch axes
    allowed), exponentiate, divide; non-positive voxels pass through
    untouched. Returns (corrected, field) on the device."""
    total_full = _upsample(total, vol.shape[-3:], shrink) if shrink > 1 \
        else total
    field = torch.exp(total_full)
    return torch.where(vol > 0, vol / field, vol), field


# ---------------------------------------------------------------------------
# host float64 twins: the plain references of the device path
# ---------------------------------------------------------------------------
def _sharpen_from_hist(h, vmin, vmax, n_bins, fwhm, noise):
    """Host numpy twin of :func:`_device_sharpen` (float64 FFTs)."""
    if vmax - vmin < 1e-9:
        c = np.array([vmin, vmax + 1.0])
        return c, c.copy()
    h = np.asarray(h, np.float64)
    binw = (vmax - vmin) / n_bins
    centers = vmin + (np.arange(n_bins) + 0.5) * binw
    n_pad = _fft_size(n_bins)
    sigma = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    # wrapped Gaussian kernel centred at bin 0
    d = np.arange(n_pad, dtype=np.float64)
    d = np.minimum(d, n_pad - d) * binw
    g = np.exp(-0.5 * (d / sigma) ** 2)
    g /= g.sum()
    gf = np.fft.fft(g)
    hf = np.fft.fft(h, n_pad)
    wiener = np.conj(gf) / (np.abs(gf) ** 2 + noise ** 2)
    u_hist = np.real(np.fft.ifft(hf * wiener))[:n_bins]
    u_hist = np.maximum(u_hist, 0.0)
    if u_hist.sum() <= 0:
        return centers, centers.copy()
    # E[u|v] = conv(u_hist * u, G)(v) / conv(u_hist, G)(v)
    uf = np.fft.fft(u_hist, n_pad)
    uuf = np.fft.fft(u_hist * centers, n_pad)
    den = np.real(np.fft.ifft(uf * gf))[:n_bins]
    num = np.real(np.fft.ifft(uuf * gf))[:n_bins]
    mapping = np.where(den > _EPS, num / np.maximum(den, _EPS), centers)
    return centers, mapping


def _host_wls_fit_apply(vol_r, w, bz, by, bx, bz2, by2, bx2):
    """Host float64 twin of :func:`_wls_fit_apply` for one volume."""
    def ev(phi):
        f = np.einsum("cde,zc->zde", phi, bz)
        f = np.einsum("zde,yd->zye", f, by)
        return np.einsum("zye,xe->zyx", f, bx)

    def adj(vol, mz, my, mx):
        g = np.einsum("zyx,zc->cyx", vol, mz)
        g = np.einsum("cyx,yd->cdx", g, my)
        return np.einsum("cdx,xe->cde", g, mx)

    b = adj(w * vol_r, bz, by, bx)
    diag = adj(w, bz2, by2, bx2)
    lam = 1e-5 * max(diag.max(), _EPS)
    diag = diag + lam

    def a_op(phi):
        return adj(w * ev(phi), bz, by, bx) + lam * phi

    x = np.zeros_like(b)
    r = b.copy()
    z = r / diag
    p = z.copy()
    rz = (r * z).sum()
    rz0 = rz
    for _ in range(_CG_STEPS):
        if not rz > 1e-10 * rz0:
            break
        ap = a_op(p)
        denom = (p * ap).sum()
        alpha = rz / max(denom, _EPS) if denom > 0 else 0.0
        x = x + alpha * p
        r = r - alpha * ap
        z = r / diag
        rz_n = (r * z).sum()
        beta = rz_n / max(rz, _EPS) if rz > 0 else 0.0
        p = z + beta * p
        rz = rz_n
    return ev(x)


def _host_n4_level(res, total, w, n_bins, fwhm, noise, conv_threshold,
                   max_iter, mats):
    """Host float64 twin of one :func:`_n4_level` lane: res, total, w
    (Z, Y, X) numpy, ``mats`` the six float64 basis matrices."""
    res = res.astype(np.float64).copy()
    total = total.astype(np.float64).copy()
    n = max(w.sum(), 1.0)
    cv = 1e9
    i = 0
    while i < max_iter and cv >= conv_threshold:
        sel = w > 0
        vmin, vmax = res[sel].min(), res[sel].max()
        width = max(vmax - vmin, 1e-9) / n_bins
        idx = np.clip(((res - vmin) / width).astype(np.int64),
                      0, n_bins - 1)
        hist = np.zeros(n_bins)
        np.add.at(hist, idx.ravel(), w.ravel())
        centers, mapping = _sharpen_from_hist(hist, vmin, vmax, n_bins,
                                              fwhm, noise)
        euv = np.interp(res, centers, mapping)
        r = np.where(sel, res - euv, 0.0)
        f = _host_wls_fit_apply(r, w, *mats)
        f = f - (f * w).sum() / n
        ef = np.exp(f)
        mu = (ef * w).sum() / n
        var = (w * (ef - mu) ** 2).sum() / n
        cv = np.sqrt(max(var, 0.0)) / max(mu, _EPS)
        res -= f
        total += f
        i += 1
    return res, total


def _host_upsample(lt, out_shape, shrink):
    """Separable trilinear upsample of the shrunk log field to the full
    grid at coordinates k / shrink, edge-clamped (float64 host twin of
    :func:`_upsample`)."""
    for ax, n in enumerate(out_shape):
        u = np.arange(n) / shrink
        i0 = np.minimum(u.astype(np.int64), lt.shape[ax] - 1)
        i1 = np.minimum(i0 + 1, lt.shape[ax] - 1)
        f = (u - i0).reshape([-1 if a == ax else 1 for a in range(3)])
        lt = (np.take(lt, i0, axis=ax) * (1.0 - f)
              + np.take(lt, i1, axis=ax) * f)
    return lt


def _host_finalize(vol, log_total, shrink, want_field):
    """Host float64 twin of :func:`_n4_finalize` for one volume."""
    lt = np.asarray(log_total, np.float64)
    if shrink > 1:
        lt = _host_upsample(lt, vol.shape, shrink)
    field = np.exp(lt).astype(np.float32)
    corrected = np.where(vol > 0, vol / field, vol).astype(np.float32)
    return corrected, (field if want_field else None)
