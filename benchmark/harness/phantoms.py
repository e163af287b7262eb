"""Seeded inputs, made on the card in a few large calls.

The patterns follow ``chip_smoke.py`` (``phantom``, ``ct_noise``,
``known_bump``, ``structure_set``, ``dose_plan``), resized to the
deployments of ``benchmark/configs``: a thoracic CT with a body, two
lungs cut by a diaphragm dome, heart, liver, spine, ribs and seeded lung
vessels and nodules, 20 HU of in-plane correlated noise; a smooth
breathing field that moves most at the diaphragm; the same CT's organs as
contours, and a dose of a conformal plan on a coarser grid.

Coordinates: ``shape`` (Z, Y, X), ``spacing`` [sx, sy, sz] mm, an
identity direction; the patient's head is at +z, posterior at +y.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed, device):
    """A generator on ``device`` seeded from the run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003) % (2 ** 63))
    return g


def axes_mm(shape, spacing, device):
    """(z, y, x) broadcastable coordinates in mm about the grid's centre."""
    Z, Y, X = shape
    sx, sy, sz = spacing
    opts = dict(dtype=torch.float32, device=device)
    z = (torch.arange(Z, **opts) - (Z - 1) / 2) * sz
    y = (torch.arange(Y, **opts) - (Y - 1) / 2) * sy
    x = (torch.arange(X, **opts) - (X - 1) / 2) * sx
    return z[:, None, None], y[None, :, None], x[None, None, :]


def uniform(gen, lo, hi, n=None):
    dev = gen.device
    if n is None:
        return float(lo + (hi - lo) * torch.rand((), generator=gen,
                                                 device=dev))
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)


def anatomy(shape, spacing, gen):
    """Seeded organ geometry: a dict of the shapes' parameters (mm)."""
    Z, Y, X = shape
    sx, sy, sz = spacing
    half_z = (Z - 1) / 2 * sz
    body_rx = uniform(gen, 150.0, 175.0)
    body_ry = uniform(gen, 105.0, 125.0)
    return dict(
        body=(body_rx, body_ry, uniform(gen, -6.0, 6.0)),
        # (centre x, centre y, rx, ry) of each lung; the dome's apex z
        lung_l=(uniform(gen, 70.0, 82.0), uniform(gen, -8.0, 4.0),
                0.36 * body_rx, 0.68 * body_ry),
        lung_r=(-uniform(gen, 70.0, 82.0), uniform(gen, -8.0, 4.0),
                0.38 * body_rx, 0.70 * body_ry),
        dome_z=-0.35 * half_z + uniform(gen, -10.0, 10.0),
        heart=(uniform(gen, 10.0, 30.0), uniform(gen, -45.0, -30.0),
               -0.10 * half_z, 55.0, 45.0, 0.25 * half_z),
        spine=(0.0, body_ry * 0.72, 16.0),
        esophagus=(uniform(gen, -8.0, 8.0), body_ry * 0.45, 7.0),
        half_z=half_z)


def thorax(shape, spacing, gen, a=None, noise_hu=20.0):
    """(Z, Y, X) float32 HU of a thoracic CT from ``gen`` (and the
    anatomy ``a``, drawn from ``gen`` when not given)."""
    dev = gen.device
    if a is None:
        a = anatomy(shape, spacing, gen)
    z, y, x = axes_mm(shape, spacing, dev)
    brx, bry, byc = a["body"]
    vol = torch.full(shape, -1000.0, device=dev)
    body = (x / brx) ** 2 + ((y - byc) / bry) ** 2 <= 1
    vol = torch.where(body, torch.tensor(30.0, device=dev), vol)
    # ribs: a shell under the skin in bands every 28 mm above the dome
    shell = body & ((x / (brx - 12)) ** 2 + ((y - byc) / (bry - 12)) ** 2
                    > 1) & ((x / (brx - 4)) ** 2 + ((y - byc) / (bry - 4))
                            ** 2 <= 1)
    ribs = shell & (torch.remainder(z, 28.0) < 9.0) & (z > a["dome_z"])
    vol = torch.where(ribs, torch.tensor(550.0, device=dev), vol)
    dome = a["dome_z"]
    for (cx, cy, rx, ry), hu in ((a["lung_l"], -820.0),
                                 (a["lung_r"], -790.0)):
        r2 = ((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2
        top = a["half_z"] * 0.92 * torch.sqrt(torch.clamp(1 - r2, min=0))
        floor = dome + 0.004 * ((x - cx) ** 2 + (y - cy) ** 2)
        lung = (r2 <= 1) & (z < top) & (z > floor)
        vol = torch.where(lung, torch.tensor(hu, device=dev), vol)
    # liver under the right dome
    lcx, lcy, lrx, lry = a["lung_r"]
    liver = (((x - lcx * 0.8) / (lrx * 1.6)) ** 2
             + ((y - lcy) / (lry * 1.1)) ** 2 <= 1) \
        & (z < dome + 0.004 * ((x - lcx) ** 2 + (y - lcy) ** 2) - 4)
    vol = torch.where(liver & body, torch.tensor(60.0, device=dev), vol)
    hx, hy, hz, hrx, hry, hrz = a["heart"]
    heart = ((x - hx) / hrx) ** 2 + ((y - hy) / hry) ** 2 \
        + ((z - hz) / hrz) ** 2 <= 1
    vol = torch.where(heart, torch.tensor(45.0, device=dev), vol)
    ex, ey, er = a["esophagus"]
    eso = (x - ex) ** 2 + (y - ey) ** 2 <= er ** 2
    vol = torch.where(eso, torch.tensor(-100.0, device=dev), vol)
    spx, spy, spr = a["spine"]
    canal = (x - spx) ** 2 + (y - spy - 4) ** 2 <= (0.45 * spr) ** 2
    bone = ((x - spx) ** 2 + (y - spy) ** 2 <= spr ** 2) & ~canal
    disc = torch.remainder(z, 26.0) < 5.0
    vol = torch.where(bone, torch.where(disc, torch.tensor(90.0, device=dev),
                                        torch.tensor(650.0, device=dev)),
                      vol)
    vol = torch.where(canal, torch.tensor(20.0, device=dev), vol)
    # seeded vessels and nodules in the lungs: spheres of 2.5-7 mm
    n = 48
    centres = torch.stack([
        uniform(gen, -0.8, 0.8, n) * brx,
        uniform(gen, -0.6, 0.6, n) * bry,
        uniform(gen, -0.8, 0.9, n) * a["half_z"]], 1)
    radii = uniform(gen, 2.5, 7.0, n)
    inside_lung = vol < -700
    for k in range(n):
        cx, cy, cz = centres[k].tolist()
        r = float(radii[k])
        ball = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2 <= r * r
        vol = torch.where(ball & inside_lung, torch.tensor(35.0, device=dev),
                          vol)
    vol = vol + ct_noise(shape, gen, noise_hu)
    return vol.round().clamp(-1024, 3071)


def ct_noise(shape, gen, hu=20.0, sigma_vox=1.0):
    """Noise of ``hu`` standard deviation, correlated in-plane by a
    Gaussian of ``sigma_vox`` along y and x, as a reconstruction kernel
    correlates CT noise."""
    dev = gen.device
    radius = max(1, int(math.ceil(4 * sigma_vox)))
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                        device=dev)
    k = torch.exp(-0.5 * (offs / sigma_vox) ** 2)
    k = (k / k.sum()).view(1, 1, -1)
    Z, Y, X = shape
    n = torch.randn(shape, generator=gen, device=dev)
    n = F.conv1d(n.reshape(-1, 1, X), k, padding=radius).reshape(shape)
    n = F.conv1d(n.transpose(1, 2).reshape(-1, 1, Y), k, padding=radius) \
        .reshape(Z, X, Y).transpose(1, 2)
    return n * (hu / n.std())


def breathing_field(shape, spacing, gen, peak_mm):
    """The sampling field (Z, Y, X, 3) mm, components (x, y, z), that
    takes the inhale phase to the exhale phase: exhale(p) =
    inhale(p + d(p)). It moves most at the diaphragm (a Gaussian in z
    about the dome, sigma 70 mm, and in-plane about the lungs' centre),
    ``peak_mm`` superior-inferior and a quarter of it anterior-posterior,
    as the diaphragm rises and the chest wall falls at exhale."""
    dev = gen.device
    z, y, x = axes_mm(shape, spacing, dev)
    half_z = (shape[0] - 1) / 2 * spacing[2]
    zc = -0.35 * half_z + uniform(gen, -10.0, 10.0)
    xc, yc = uniform(gen, -15.0, 15.0), uniform(gen, -10.0, 10.0)
    w = torch.exp(-0.5 * ((z - zc) / 70.0) ** 2
                  - 0.5 * ((x - xc) / 120.0) ** 2
                  - 0.5 * ((y - yc) / 100.0) ** 2)
    dz = -peak_mm * w
    dy = 0.25 * peak_mm * w
    dx = torch.zeros_like(w)
    return torch.stack(torch.broadcast_tensors(dx, dy, dz), -1)


def warp_by(vol, field_mm, spacing):
    """``vol`` sampled at p + d(p) (trilinear, edge-clamped) as HU
    rounded to integers: the generator's own resample, not the port's."""
    Z, Y, X = vol.shape
    sx, sy, sz = spacing
    dev = vol.device
    gz = torch.arange(Z, dtype=torch.float32, device=dev)[:, None, None] \
        + field_mm[..., 2] / sz
    gy = torch.arange(Y, dtype=torch.float32, device=dev)[None, :, None] \
        + field_mm[..., 1] / sy
    gx = torch.arange(X, dtype=torch.float32, device=dev)[None, None, :] \
        + field_mm[..., 0] / sx
    grid = torch.stack([gx * (2.0 / (X - 1)) - 1, gy * (2.0 / (Y - 1)) - 1,
                        gz * (2.0 / (Z - 1)) - 1], -1)[None]
    out = F.grid_sample(vol[None, None], grid, mode="bilinear",
                        padding_mode="border", align_corners=True)[0, 0]
    return out.round()


def breathing_pair(shape, spacing, gen, peak_range):
    """(inhale, exhale) float32 HU volumes and the breathing peak (mm)."""
    inhale = thorax(shape, spacing, gen)
    peak = uniform(gen, *peak_range)
    field = breathing_field(shape, spacing, gen, peak)
    exhale = warp_by(inhale, field, spacing)
    del field
    return inhale, exhale, peak


# -- a thoracic plan: organs at risk and PTV as contours, and a dose ----
def _ellipse_radius(theta, rx, ry):
    return 1.0 / np.sqrt((np.cos(theta) / rx) ** 2
                         + (np.sin(theta) / ry) ** 2)


def ptv_of(a, gen):
    """A spherical PTV in one lung, seeded: (centre x, y, z) mm about the
    grid's centre and its radius."""
    side = a["lung_l"] if uniform(gen, 0.0, 1.0) < 0.5 else a["lung_r"]
    cx, cy, rx, ry = side
    radius = uniform(gen, 20.0, 32.0)
    return (cx + uniform(gen, -0.25, 0.25) * rx,
            cy + uniform(gen, -0.25, 0.25) * ry,
            uniform(gen, a["dome_z"] + 55.0, 0.45 * a["half_z"]), radius)


def organ_contours(shape, spacing, origin, a, ptv, vertices=64):
    """{roi: [(N, 3) mm polygons]} on the slices each organ crosses: the
    LCTSC organs at risk of the phantom ``a`` and the PTV sphere. Each
    polygon is a star about the organ's centre at ``vertices`` angles
    (32 for the cord and esophagus)."""
    Z, Y, X = shape
    sx, sy, sz = spacing
    to_world = [origin[0] + (X - 1) / 2 * sx, origin[1] + (Y - 1) / 2 * sy]
    half_z = a["half_z"]
    rois = {n: [] for n in ("Esophagus", "Heart", "Lung_L", "Lung_R",
                            "SpinalCord", "PTV")}

    def add(name, k, cx, cy, radius, n):
        th = np.linspace(0, 2 * np.pi, n, endpoint=False)
        r = radius(th)
        pts = np.stack([to_world[0] + cx + r * np.cos(th),
                        to_world[1] + cy + r * np.sin(th),
                        np.full(n, origin[2] + k * sz)], 1)
        rois[name].append(pts)

    for k in range(Z):
        z = (k - (Z - 1) / 2) * sz
        for name in ("Lung_L", "Lung_R"):
            cx, cy, rx, ry = a[name.lower()]
            if z <= a["dome_z"]:
                continue
            top = 1.0 if z <= 0 else 1 - (z / (0.92 * half_z)) ** 2
            if top <= 0.05:
                continue
            floor = np.sqrt((z - a["dome_z"]) / 0.004)
            if floor < 4.0:
                continue
            add(name, k, cx, cy, lambda th, rx=rx, ry=ry, top=top,
                floor=floor: np.minimum(_ellipse_radius(th, rx, ry)
                                        * np.sqrt(top), floor), vertices)
        hx, hy, hz, hrx, hry, hrz = a["heart"]
        f = 1 - ((z - hz) / hrz) ** 2
        if f > 0.05:
            add("Heart", k, hx, hy, lambda th, f=f: _ellipse_radius(
                th, hrx, hry) * np.sqrt(f), vertices)
        ex, ey, er = a["esophagus"]
        add("Esophagus", k, ex, ey, lambda th: np.full_like(th, er), 32)
        spx, spy, spr = a["spine"]
        add("SpinalCord", k, spx, spy + 4, lambda th: np.full_like(
            th, 0.45 * spr), 32)
        px, py, pz, pr = ptv
        if abs(z - pz) < pr - 0.5:
            rr = np.sqrt(pr ** 2 - (z - pz) ** 2)
            add("PTV", k, px, py, lambda th, rr=rr: np.full_like(th, rr),
                vertices)
    return rois


def dose_grid(shape, spacing, origin, a, dose_spacing):
    """(dose shape (Z, Y, X), origin (3,) mm): a grid of ``dose_spacing``
    over the body with 10 mm to spare, every CT slice's extent in z."""
    Z, Y, X = shape
    sx, sy, sz = spacing
    brx, bry, byc = a["body"]
    lo_c = np.array([-brx - 10.0, byc - bry - 10.0, -(Z - 1) / 2 * sz])
    hi_c = np.array([brx + 10.0, byc + bry + 10.0, (Z - 1) / 2 * sz])
    n = np.floor((hi_c - lo_c) / dose_spacing).astype(int) + 1
    centre = np.array([origin[0] + (X - 1) / 2 * sx,
                       origin[1] + (Y - 1) / 2 * sy,
                       origin[2] + (Z - 1) / 2 * sz])
    return (int(n[2]), int(n[1]), int(n[0])), centre + lo_c


def plan_dose(dose_shape, dose_origin, dose_spacing, ct_centre, a, ptv,
              beam_angles, prescription, shift=(0.0, 0.0, 0.0), scale=1.0,
              device="cpu"):
    """(Z, Y, X) float64 Gy of a conformal plan: coplanar beams through
    the PTV, each its radius wide with a 4 mm penumbra and 0.4 % a mm of
    attenuation along its axis, averaged, plus 8 % of scatter within
    60 mm; the prescription on the PTV, 0 Gy outside the body. ``shift``
    (mm) moves the isocentre and ``scale`` rescales the dose: a second,
    re-computed dose for gamma."""
    opts = dict(dtype=torch.float64, device=device)
    Z, Y, X = dose_shape
    z = (torch.arange(Z, **opts) * dose_spacing + dose_origin[2]
         - ct_centre[2])[:, None, None]
    y = (torch.arange(Y, **opts) * dose_spacing + dose_origin[1]
         - ct_centre[1])[None, :, None]
    x = (torch.arange(X, **opts) * dose_spacing + dose_origin[0]
         - ct_centre[0])[None, None, :]
    px, py, pz, pr = ptv
    px, py, pz = px + shift[0], py + shift[1], pz + shift[2]
    dx, dy, dz = x - px, y - py, z - pz
    total = 0
    for ang in beam_angles:
        ux, uy = math.cos(ang), math.sin(ang)
        along = dx * ux + dy * uy
        rho = torch.sqrt((dx - along * ux) ** 2 + (dy - along * uy) ** 2
                         + dz ** 2)
        edge = 0.5 * torch.erfc((rho - pr - 3.0) / (math.sqrt(2) * 4.0))
        total = total + edge * torch.exp(-0.004 * along)
    total = total / len(beam_angles)
    r2 = dx ** 2 + dy ** 2 + dz ** 2
    total = total + 0.08 * torch.exp(-r2 / (2 * 60.0 ** 2))
    brx, bry, byc = a["body"]
    body = (x / brx) ** 2 + ((y - byc) / bry) ** 2 <= 1
    # in the PTV every beam and the scatter's peak add to about 1.08
    return (prescription * scale / 1.08) * total * body
