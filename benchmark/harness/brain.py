"""A seeded T1 brain MR, made on the card in a few large calls.

A skull-stripped, affinely pre-aligned adult brain at the size of
OASIS-1 as Learn2Reg hands it out (1 mm, 160 x 192 x 224): an
ellipsoidal brain whose cortex, a grey shell about 3 mm thick, folds
into the white matter along sulci, CSF in the sulci and in a 2 mm band
around the brain, two lateral ventricles and two deep grey nuclei, at
T1 contrast (white brighter than grey, grey brighter than CSF, the
stripped background 0).

The template is a function of the physical position, so a subject is
the template evaluated at p + d(p), with d a smooth seeded field, and no
resample blurs it. Each subject then takes a multiplicative bias field
(an MR coil's, which is why CC and not SSD drives the registration) and
Gaussian noise inside the brain mask, and is rounded to int16 as a read
series is held.

Coordinates as in ``phantoms.py``: ``shape`` (Z, Y, X), ``spacing``
[sx, sy, sz] mm about the grid's centre, an identity direction.
"""

from __future__ import annotations

import math

import torch

from .phantoms import axes_mm, uniform

# T1 intensities of a scanner's int16 series, arbitrary units
WM, GM, DEEP_GM, CSF = 1000.0, 650.0, 760.0, 250.0
SEMI_AXES_MM = (66.0, 82.0, 70.0)      # the brain's x (L-R), y, z
CORTEX_MM = 3.0                        # grey-matter thickness
SULCUS_MM = 1.5                        # a sulcus's CSF, wall to wall
STRIP_MM = 2.0                         # CSF band inside the strip mask
EDGE_MM = 0.4                          # partial-volume width of an edge
FOLD_WAVELENGTH_MM = 26.0              # the fold field's plane waves


def _soft(v_mm):
    """1 well inside (v > 0), 0 well outside, over ~``EDGE_MM``."""
    return torch.sigmoid(v_mm / EDGE_MM)


def _waves(gen, n, wavelength_mm):
    """``n`` plane waves of one wavelength in seeded directions: (k (n,
    3) rad/mm in x, y, z, phases (n,))."""
    dirs = torch.randn((n, 3), generator=gen, device=gen.device)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    phases = uniform(gen, 0.0, 2 * math.pi, n)
    return dirs * (2 * math.pi / wavelength_mm), phases


def _wave_sum(k, phases, x, y, z):
    """sum_j cos(k_j . p + phase_j) / sqrt(n / 2): unit variance."""
    out = 0.0
    for j in range(k.shape[0]):
        out = out + torch.cos(k[j, 0] * x + k[j, 1] * y + k[j, 2] * z
                              + phases[j])
    return out / math.sqrt(k.shape[0] / 2)


def template(gen):
    """The population's seeded parameters: the fold field's waves, the
    sulci's depth, the ventricles' and nuclei's placement (mm)."""
    k, phases = _waves(gen, 12, FOLD_WAVELENGTH_MM)
    return dict(
        fold=(k, phases), sulcus_depth_mm=uniform(gen, 12.0, 17.0),
        ventricle=(uniform(gen, 9.0, 13.0), uniform(gen, -4.0, 4.0),
                   uniform(gen, 6.0, 12.0)),
        nucleus=(uniform(gen, 9.0, 12.0), uniform(gen, -12.0, -6.0),
                 uniform(gen, -4.0, 2.0)))


def t1(t, x, y, z):
    """The template's T1 intensity at the positions (x, y, z) mm."""
    ax, ay, az = SEMI_AXES_MM
    mean_r = 3.0 / (1 / ax + 1 / ay + 1 / az)
    rho = torch.sqrt((x / ax) ** 2 + (y / ay) ** 2 + (z / az) ** 2)
    depth = (1.0 - rho) * mean_r       # mm below the pial envelope
    k, phases = t["fold"]
    # mm from the fold field's zero set, a network of sheets: the sulci
    sheet = torch.abs(_wave_sum(k, phases, x, y, z)) \
        / float(k[0].norm())
    sd = t["sulcus_depth_mm"]
    sulcus = _soft(0.5 * SULCUS_MM - sheet) * _soft(sd - depth)
    cortex = torch.maximum(
        _soft(CORTEX_MM - depth),
        _soft(0.5 * SULCUS_MM + CORTEX_MM - sheet)
        * _soft(sd + CORTEX_MM - depth))
    vx, vy, vz = t["ventricle"]
    vent = torch.maximum(
        _soft(6.0 * (1 - torch.sqrt(((x - vx) / 6.0) ** 2
                                    + ((y - vy) / 24.0) ** 2
                                    + ((z - vz) / 11.0) ** 2))),
        _soft(6.0 * (1 - torch.sqrt(((x + vx) / 6.0) ** 2
                                    + ((y - vy) / 24.0) ** 2
                                    + ((z - vz) / 11.0) ** 2))))
    nx, ny, nz = t["nucleus"]
    nuclei = torch.maximum(
        _soft(8.0 * (1 - torch.sqrt(((x - nx) / 8.0) ** 2
                                    + ((y - ny) / 12.0) ** 2
                                    + ((z - nz) / 9.0) ** 2))),
        _soft(8.0 * (1 - torch.sqrt(((x + nx) / 8.0) ** 2
                                    + ((y - ny) / 12.0) ** 2
                                    + ((z - nz) / 9.0) ** 2))))
    v = torch.lerp(torch.full_like(depth, WM), torch.full_like(depth, GM),
                   cortex)
    v = torch.lerp(v, torch.full_like(v, DEEP_GM), nuclei)
    v = torch.lerp(v, torch.full_like(v, CSF), torch.maximum(sulcus, vent))
    v = torch.lerp(torch.full_like(v, CSF), v, _soft(depth))
    return v * _soft(depth + STRIP_MM)


def deformation(shape, spacing, gen, peak_mm):
    """A subject's smooth sampling field (Z, Y, X, 3) mm, components (x,
    y, z): six Gaussian bumps (sigma 18-32 mm) about seeded points of the
    brain, each pushing a seeded way, scaled so its largest vector is
    ``peak_mm``."""
    dev = gen.device
    z, y, x = axes_mm(shape, spacing, dev)
    field = torch.zeros(tuple(shape) + (3,), device=dev)
    for _ in range(6):
        c = [uniform(gen, -0.6, 0.6) * a for a in SEMI_AXES_MM]
        s = uniform(gen, 18.0, 32.0)
        w = (torch.exp(-0.5 * ((x - c[0]) / s) ** 2)
             * torch.exp(-0.5 * ((y - c[1]) / s) ** 2)
             * torch.exp(-0.5 * ((z - c[2]) / s) ** 2))
        field += w[..., None] * torch.randn(3, generator=gen, device=dev)
    return field * (peak_mm / field.norm(dim=-1).max())


def bias(shape, spacing, gen, amplitude):
    """A coil's multiplicative field 1 + b(p): four plane waves of
    150-250 mm wavelength, scaled so that |b| peaks at ``amplitude``
    inside the brain."""
    z, y, x = axes_mm(shape, spacing, gen.device)
    b = 0.0
    for _ in range(4):
        k, ph = _waves(gen, 1, uniform(gen, 150.0, 250.0))
        b = b + uniform(gen, 0.5, 1.0) * torch.cos(
            k[0, 0] * x + k[0, 1] * y + k[0, 2] * z + ph[0])
    ax, ay, az = SEMI_AXES_MM
    inside = (x / ax) ** 2 + (y / ay) ** 2 + (z / az) ** 2 <= 1.0
    return 1.0 + b * (amplitude / torch.abs(b * inside).max())


def subject(shape, spacing, t, gen, peak_range, bias_amplitude,
            noise_share):
    """One subject: (int16-valued float32 (Z, Y, X) T1 volume, its
    sampling field from the template (Z, Y, X, 3) mm). The template at
    p + d(p), times the bias, plus noise of ``noise_share`` of white
    matter's intensity inside the stripped brain, rounded; 0 outside."""
    dev = gen.device
    d = deformation(shape, spacing, gen, uniform(gen, *peak_range))
    z, y, x = axes_mm(shape, spacing, dev)
    v = t1(t, x + d[..., 0], y + d[..., 1], z + d[..., 2])
    v = v * bias(shape, spacing, gen, bias_amplitude)
    noise = torch.randn(tuple(shape), generator=gen, device=dev)
    v = torch.where(v > 0.5 * CSF, v + noise * (noise_share * WM),
                    torch.zeros((), device=dev))
    return torch.clamp(v.round(), 0.0, 32767.0), d
