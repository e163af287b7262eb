"""FFT phase-correlation global translation estimation.

Port of medicalimageanalysis_tpu/ops/registration/phase_correlation.py
(``_phase_correlate_core`` :40-105, ``phase_correlation``): the
cross-power spectrum (Kuglin-Hines, with subvoxel parabolic refinement
after Foroosh) recovers any cyclic translation up to half the field of
view in one shot, the capture-range step before gradient-descent
intensity registration.

On the device: mean-centering, the separable Hann window, ``torch.fft.
rfftn`` / ``irfftn``, the normalised cross-power, the argmax and the
wrapped 3-point parabola (clipped to +-0.5 voxel). The Hann window
suppresses the spurious zero-shift peak of the volume boundary but
biases a single estimate towards zero, so the core iterates (a Python
loop of ``iterations`` passes): Fourier-shift the unwindowed moving
spectrum ``G0`` by the running estimate, re-window, re-correlate. The
peak's index and its six neighbours are gathered on the device; the
shift and the response come to the host once, at the end.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...device import default_device

__all__ = ["phase_correlation"]


def _hann(n, device):
    k = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / max(n - 1, 1))


def _phase_correlate_core(fixed, moving, window, iterations):
    """(3,) float32 shift (z, y, x) in voxels and the peak, both 0-d /
    1-d tensors on the volumes' device."""
    nz, ny, nx = fixed.shape
    dev = fixed.device
    f = fixed - torch.mean(fixed)
    g = moving - torch.mean(moving)
    if window:
        w = (_hann(nz, dev)[:, None, None] * _hann(ny, dev)[None, :, None]
             * _hann(nx, dev)[None, None, :])
    else:
        w = torch.ones_like(f)

    F = torch.fft.rfftn(f * w)
    G0 = torch.fft.rfftn(g)  # unwindowed: re-windowed after each shift

    # rfftn frequency grids (cycles per array length)
    kz = torch.fft.fftfreq(nz, device=dev)[:, None, None]
    ky = torch.fft.fftfreq(ny, device=dev)[None, :, None]
    kx = torch.fft.rfftfreq(nx, device=dev)[None, None, :]

    def estimate(G):
        cross = F * torch.conj(G)
        r = torch.fft.irfftn(cross / (torch.abs(cross) + 1e-12),
                             s=(nz, ny, nx))
        flat = torch.argmax(r)
        pz = flat // (ny * nx)
        py = (flat // nx) % ny
        px = flat % nx
        peak = r[pz, py, px]

        def refine(p, n, minus, plus):
            denom = minus - 2.0 * peak + plus
            ok = torch.abs(denom) > 1e-12
            delta = torch.where(
                ok, 0.5 * (minus - plus) / torch.where(ok, denom, 1.0),
                torch.zeros_like(denom))
            delta = torch.clamp(delta, -0.5, 0.5)
            pf = p.to(torch.float32) + delta
            return torch.where(pf > n / 2.0, pf - n, pf)

        qz = refine(pz, nz, r[(pz - 1) % nz, py, px],
                    r[(pz + 1) % nz, py, px])
        qy = refine(py, ny, r[pz, (py - 1) % ny, px],
                    r[pz, (py + 1) % ny, px])
        qx = refine(px, nx, r[pz, py, (px - 1) % nx],
                    r[pz, py, (px + 1) % nx])
        # m(x) = f(x - d) puts the peak at -d (mod N): negate back
        return -torch.stack([qz, qy, qx]), peak

    cum, peak = estimate(torch.fft.rfftn(g * w))
    for _ in range(1, iterations):
        # cyclically undo the running estimate: m(x + cum) has spectrum
        # G0 * exp(+2 pi i k . cum)
        ramp = torch.exp(2j * math.pi * (kz * cum[0] + ky * cum[1]
                                         + kx * cum[2]))
        g_shift = torch.fft.irfftn(G0 * ramp, s=(nz, ny, nx))
        est, peak = estimate(torch.fft.rfftn(g_shift * w))
        cum = cum + est
    return cum, peak


def phase_correlation(fixed, moving, spacing_xyz=None, window=True,
                      iterations=6, device=None):
    """Estimate the translation of ``moving`` relative to ``fixed``.

    Returns ``(shift, response)`` where ``shift`` is the (z, y, x)
    displacement of the moving content relative to the fixed content —
    ``moving == np.roll(fixed, shift)`` recovers exactly ``shift`` —
    in voxels, or in mm per axis (still ordered (z, y, x)) when
    ``spacing_xyz`` is given. ``response`` is the normalized
    cross-power peak of the final aligned pass in [0, 1]. Rolling
    ``moving`` by ``-shift`` aligns it to ``fixed``. ``iterations`` > 1
    removes the Hann-window bias; with ``window=False`` one pass is
    already cyclic-exact. The volumes (arrays or tensors) go to
    ``device`` (default: a tensor's own device, else the card).
    """
    def dev_of(a):
        if device is not None:
            return torch.device(device)
        if isinstance(a, torch.Tensor):
            return a.device
        return default_device()

    def volume(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.float32)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    dev = dev_of(fixed)
    f, g = volume(fixed), volume(moving)
    if f.ndim != 3 or f.shape != g.shape:
        raise ValueError(
            f"phase_correlation: expected matching (Z, Y, X) volumes, "
            f"got {tuple(f.shape)} vs {tuple(g.shape)}")
    shift, peak = _phase_correlate_core(f, g, bool(window),
                                        int(max(1, iterations)))
    out = torch.cat([shift, peak[None]]).cpu().numpy()   # the one sync
    shift = out[:3].astype(np.float64)
    if spacing_xyz is not None:
        sp = np.asarray(spacing_xyz, np.float64)
        shift = shift * sp[::-1]
    return shift, float(out[3])
