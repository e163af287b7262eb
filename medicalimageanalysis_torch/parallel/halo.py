"""Volumes sharded along z with halo exchange.

Port of medicalimageanalysis_tpu/parallel/halo.py: a volume too large for
one device (or a pair that should use every device) splits its z axis over
the mesh's ``space`` axis; each shard extends its block by a halo of rows
from its neighbours (``Ring.ppermute``) and runs the stencil, the warp
kernel or the demons step on its own slab. The shards run in lockstep from
one thread (parallel/mesh.py); the reductions that couple them (the LNCC
centring, the step normalisation) are ``Ring.psum`` / ``Ring.pmax`` over
the shards' 0-d tensors, taken over every shard before any shard moves on.

The space-sharded functions compute on the mesh's first data row; with a
``data`` axis above 1 the JAX package computes every row alike, the port
computes the one. A process that holds no position of that row computes
nothing and receives the result through the all_gather that hands it to
every process. Every warp is one launch of the warp kernel's ``disp``
mode per shard on its halo slab (the CUDA kernel on the card, the plain
version on the CPU).

The JAX package's kernel-slab overflow count (``kovf``) has no counterpart:
the CUDA kernel reads global memory and has no slab window. The halo cap
stays: a z displacement beyond ``halo - 2`` rows cannot be served from the
slab, so :func:`warp_z_sharded` backgrounds and counts such samples.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..device import full_float32
from ..ops.warp import warp_disp
from .mesh import Ring, Sharded, Sharding, gather_blocks

__all__ = ["gaussian_z_sharded", "warp_z_sharded", "demons_z_sharded",
           "demons_batch_z_sharded"]


def _gauss_taps(sigma_vox):
    """The taps of ops.filters.gauss_taps, which also builds the dense
    Toeplitz matrices of the single-device smoothing."""
    from ..ops.filters import gauss_taps

    return gauss_taps(sigma_vox, dtype=np.float32)


def _take(t, lo, hi, z_axis):
    return t.narrow(z_axis, lo, hi - lo)


def _exchange_z(ring, blocks, h, z_axis, edge="replicate"):
    """Each local block extended by ``h`` rows along ``z_axis``: the last
    rows of the shard below, the first rows of the shard above (one hop);
    at the global edges the edge row replicated (the warp kernel's clamped
    taps, the Gaussian matrix's edge rows) or, with ``edge="zero"``,
    zeros (the LNCC box sums' clipped windows). Every slab is a new
    tensor: no halo is a view of a neighbour's block."""
    L = next(iter(blocks.values())).shape[z_axis]
    below = ring.ppermute({i: _take(b, L - h, L, z_axis)
                           for i, b in blocks.items()}, 1)
    above = ring.ppermute({i: _take(b, 0, h, z_axis)
                           for i, b in blocks.items()}, -1)
    out = {}
    for i in ring.local:
        b = blocks[i]

        def fill(row):
            if edge == "zero":
                return torch.zeros_like(_take(b, 0, h, z_axis))
            shape = list(b.shape)
            shape[z_axis] = h
            return row.expand(shape)

        lo = below[i] if i > 0 else fill(_take(b, 0, 1, z_axis))
        hi = above[i] if i < ring.n - 1 else fill(_take(b, L - 1, L, z_axis))
        out[i] = torch.cat([lo, b, hi], dim=z_axis)
    return out


def _halo_depth(halo, Zl):
    """Effective halo depth for a Zl-row shard: one hop serves at most one
    shard of halo, and below 3 rows the z cap (H - 2) serves no motion."""
    H = min(int(halo), Zl)
    if H < 3:
        raise ValueError(
            f"effective halo {H} (min(halo={halo}, Z/shards={Zl})) is "
            "too shallow for any z-motion; use fewer shards or a "
            "deeper volume")
    return H


def _put_sharded(mesh, pairs):
    """[(array, dims), ...] -> {position: tensor} per array: each block
    sliced on the host and uploaded to its own device (one upload per
    block; the whole volume never lands on one device)."""
    return [Sharding(mesh, dims).split(a).blocks for a, dims in pairs]


def _replicate(mesh, blocks):
    """{position: tensor} of this process -> the blocks of every process as
    host arrays, by position (an all_gather across processes)."""
    return {p: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for p, v in gather_blocks(mesh, blocks).items()}


def _result(mesh, shape, axis_name, out, extra=None):
    """The z blocks of the first data row (``out``: {space position:
    tensor}) as a :class:`mesh.Sharded`; across processes every process
    receives every block, on its first mesh device. ``extra``: values
    to hand round with them (key -> value, None on a process that
    computed none). Returns (Sharded, extra as every process sees it)."""
    blocks = {(0, i): b for i, b in out.items()}
    extra = dict(extra or {})
    if mesh.multiprocess:
        got = _replicate(mesh, {**blocks, **{k: v for k, v in extra.items()
                                            if v is not None}})
        extra = {k: got[k] for k in extra}
        dev = mesh.local_device()
        blocks = {p: torch.as_tensor(b, device=dev)
                  for p, b in got.items() if p not in extra}
    return Sharded(Sharding(mesh, (axis_name,)), shape, blocks), extra


def _assemble(blocks, n, axis):
    """Host blocks by space position -> one array along ``axis``."""
    return np.concatenate([blocks[(0, i)] for i in range(n)], axis=axis)


def _taps_on(ring, taps):
    """The taps as a tensor on each local device."""
    return {d: torch.as_tensor(taps, device=d)
            for d in {ring.devices[i] for i in ring.local}}


def _z_pass(ring, blocks, taps, radius, z_axis):
    """Σ taps[t] * slab rows, over a ``radius``-row edge-replicated halo
    (``taps``: device -> tensor, :func:`_taps_on`)."""
    slabs = _exchange_z(ring, blocks, radius, z_axis)
    out = {}
    for i in ring.local:
        b, slab = blocks[i], slabs[i]
        t_dev = taps[b.device]
        acc = torch.zeros_like(b)
        for t in range(2 * radius + 1):
            acc = acc + t_dev[t] * _take(slab, t, t + b.shape[z_axis], z_axis)
        out[i] = acc
    return out


def gaussian_z_sharded(volume, sigma_vox, mesh, axis_name="space"):
    """Gaussian blur along z of a (Z, Y, X) volume z-sharded over
    ``axis_name``: each shard takes ``radius`` rows from each neighbour
    and convolves its slab; the global edges replicate (the single-device
    Gaussian's 'nearest'). ``axis_name`` is kept for the JAX signature
    (only 'space' is valid). Returns a :class:`mesh.Sharded`
    (``np.asarray`` assembles it; across processes every process
    receives the whole)."""
    taps, radius = _gauss_taps(float(sigma_vox))
    ring = Ring(mesh, 0, axis_name)
    Z = volume.shape[0]
    if Z % ring.n != 0:
        raise ValueError(f"z={Z} not divisible by {ring.n} shards")
    if radius > Z // ring.n:
        raise ValueError(
            f"gaussian_z_sharded: smoothing radius {radius} exceeds "
            f"the {Z // ring.n}-slice shard depth; reduce sigma or "
            "use fewer z-shards")
    vol = volume if isinstance(volume, torch.Tensor) \
        else np.asarray(volume, np.float32)
    blocks = {p[1]: b.to(torch.float32)
              for p, b in Sharding(mesh, (axis_name,)).split(vol)
              .blocks.items()}
    out = _z_pass(ring, blocks, _taps_on(ring, taps), radius, 0) \
        if ring.local else {}
    return _result(mesh, tuple(vol.shape), axis_name, out)[0]


def warp_z_sharded(volume, dvf_mm, mesh, spacing_xyz=(1.0, 1.0, 1.0),
                   background=0.0, halo=16, axis_name="space"):
    """Warp one z-sharded volume by a DVF: the sharded twin of
    ops.registration.dvf.warp_volume (out(x) = volume(x + d(x)), d in mm,
    (Z, Y, X, 3) with components [x, y, z]).

    Each shard extends its block by ``halo`` rows and runs one ``disp``
    launch on the slab. x and y displacements are unlimited; a z
    displacement is served from the halo up to ``halo - 2`` rows. A sample
    that needs more (inside the volume) takes ``background`` and is
    counted: a non-zero count warns to rerun with a larger halo, so every
    voxel is exact or backgrounded. After the kernel the global z bounds
    are applied: the slab's replicated edge rows lie inside the kernel's
    bounds, and the single-device kernel backgrounds there.

    Z must divide by the shard count; ``axis_name`` is kept for the JAX
    signature (only 'space' is valid). Returns a :class:`mesh.Sharded` of
    the warped (Z, Y, X) volume; across processes every process receives
    the whole of it (``np.asarray`` assembles it).
    """
    ring = Ring(mesh, 0, axis_name)
    n = ring.n
    vol = volume if isinstance(volume, torch.Tensor) \
        else np.asarray(volume, np.float32)
    dvf = dvf_mm if isinstance(dvf_mm, torch.Tensor) \
        else np.asarray(dvf_mm, np.float32)
    Z, Y, X = vol.shape
    if tuple(dvf.shape) != (Z, Y, X, 3):
        raise ValueError(f"dvf shape {tuple(dvf.shape)} != {(Z, Y, X, 3)}")
    if Z % n != 0:
        raise ValueError(f"z={Z} not divisible by {n} shards")
    Zl = Z // n
    H = _halo_depth(halo, Zl)
    vb, db = _put_sharded(mesh, [(vol, (axis_name,)), (dvf, (axis_name,))])
    vb = {p[1]: b.to(torch.float32)[None] for p, b in vb.items()}
    slabs = _exchange_z(ring, vb, H, 1) if ring.local else {}
    out, over = {}, {}
    for i in ring.local:
        dev = ring.devices[i]
        sp = torch.as_tensor(spacing_xyz, dtype=torch.float32, device=dev)
        # the single-device planar voxel field: (Zl, Y, X, 3) mm -> voxels
        disp = torch.movedim(db[(0, i)].to(torch.float32) / sp, -1, 0)
        cap = torch.tensor(float(H - 2), device=dev)
        dz = disp[2]
        zz = torch.arange(Zl, dtype=torch.float32, device=dev)[:, None, None]
        gz = (torch.tensor(float(i * Zl), device=dev) + zz) + dz
        z_in = (gz >= 0.0) & (gz <= float(Z - 1))
        over_cap = dz.abs() > cap
        d = torch.stack([disp[0], disp[1],
                         torch.clamp(dz, -cap, cap) + float(H)]).contiguous()
        w = warp_disp(slabs[i], d, float(background))[0]
        out[i] = torch.where(over_cap | ~z_in,
                             torch.tensor(float(background), device=dev), w)
        over[i] = (over_cap & z_in).sum().to(torch.float32)
    total = float(ring.psum(over)[ring.local[0]]) if ring.local else None
    result, got = _result(mesh, (Z, Y, X), axis_name, out,
                          {"over": total})
    if got["over"] > 0:
        warnings.warn(
            "warp_z_sharded: z-displacements exceeded the halo reach "
            f"(cap {H - 2} rows); affected voxels took the background. "
            "Increase halo or use fewer z-shards.", RuntimeWarning)
    return result


def _gradient_planar(ring, blocks, sp, Z):
    """Per shard: the (3, Zl, Y, X) gradient (d/dx, d/dy, d/dz) / spacing,
    equal to torch.gradient of the whole volume: y and x inside the shard,
    z from a 1-row halo (central differences, one-sided at the global
    edges)."""
    slabs = _exchange_z(ring, blocks, 1, 0)
    out = {}
    for i in ring.local:
        b, s = blocks[i], slabs[i]
        gz = (s[2:] - s[:-2]) / 2
        if i == 0:
            gz[0] = s[2] - s[1]
        if i == ring.n - 1:
            gz[-1] = s[-2] - s[-3]
        gy = torch.gradient(b, dim=1)[0]
        gx = torch.gradient(b, dim=2)[0]
        spd = sp[b.device]
        out[i] = torch.stack([gx / spd[0], gy / spd[1], gz / spd[2]])
    return out


class _PairLoop:
    """The z-sharded demons loop of one pair (JAX ``_make_pair_loop``): the
    static configuration and the per-device operators, shared by
    :func:`demons_z_sharded` and :func:`demons_batch_z_sharded`.

    ``forces="lncc"``: the windowed moments' y/x passes are shard-local
    banded-matrix contractions and the z pass a sliding-window sum over an
    ``lncc_radius``-row halo with zeros past the global edges (the
    single-device box matrices clip there)."""

    def __init__(self, ring, shape, spacing_xyz, std, symmetric, smooth,
                 iterations, step, intensity_threshold, H, forces,
                 lncc_radius):
        from ..ops.filters import _gauss_kernel_matrix
        from ..ops.registration.demons import _box_matrix

        self.ring = ring
        self.Z, self.Y, self.X = shape
        self.Zl = self.Z // ring.n
        self.H = H
        self.symmetric, self.smooth = symmetric, smooth
        self.iterations, self.step = int(iterations), float(step)
        self.threshold = float(intensity_threshold)
        self.forces, self.R = forces, int(lncc_radius)
        taps, self.radius = _gauss_taps(max(float(std), 1e-3))
        self.taps = _taps_on(ring, taps)
        sigma = max(float(std), 1e-3)
        host = {"my": _gauss_kernel_matrix(self.Y, sigma),
                "mx": _gauss_kernel_matrix(self.X, sigma)}
        if forces == "lncc":
            host["ly"] = _box_matrix(self.Y, self.R)
            host["lx"] = _box_matrix(self.X, self.R)
        self.ops, self.sp = {}, {}
        for dev in {ring.devices[i] for i in ring.local}:
            self.ops[dev] = {k: torch.as_tensor(v, device=dev)
                             for k, v in host.items()}
            self.sp[dev] = torch.as_tensor(spacing_xyz, dtype=torch.float32,
                                           device=dev)

    @full_float32()
    def smooth_field(self, u):
        """y/x contractions per shard, then the z taps over a
        ``radius``-row halo (the JAX order)."""
        yx = {}
        for i in self.ring.local:
            o = self.ops[u[i].device]
            v = torch.einsum("kj,czjx->czkx", o["my"], u[i])
            yx[i] = torch.einsum("lj,czyj->czyl", o["mx"], v)
        return _z_pass(self.ring, yx, self.taps, self.radius, 1)

    @full_float32()
    def box_sum(self, v):
        slabs = _exchange_z(self.ring, {i: b[None] for i, b in v.items()},
                            self.R, 1, edge="zero")
        out = {}
        for i in self.ring.local:
            s = slabs[i][0]
            acc = torch.zeros_like(v[i])
            for t in range(2 * self.R + 1):
                acc = acc + s[t:t + self.Zl]
            o = self.ops[acc.device]
            acc = torch.einsum("kj,zjx->zkx", o["ly"], acc)
            out[i] = torch.einsum("lj,zyj->zyl", o["lx"], acc)
        return out

    def _psum_mean(self, values):
        npts = float(self.Z * self.Y * self.X)
        return {i: s / npts for i, s in self.ring.psum(values).items()}

    @torch.no_grad()
    def run(self, f, m):
        """f, m: {position: (Zl, Y, X) float32 block} -> {position: the
        (3, Zl, Y, X) voxel field}."""
        from ..ops.registration.demons import _lncc_force, _thirion

        ring, H, Zl, Z = self.ring, self.H, self.Zl, self.Z
        lncc = self.forces == "lncc"
        gf = _gradient_planar(ring, f, self.sp, Z)
        if self.symmetric or lncc:
            gm = _gradient_planar(ring, m, self.sp, Z)
            stack = {i: torch.cat([m[i][None], gm[i]]) for i in ring.local}
        else:
            stack = {i: m[i][None].contiguous() for i in ring.local}
        slab = _exchange_z(ring, stack, H, 1)
        dev = {i: ring.devices[i] for i in ring.local}
        K = {i: torch.mean(self.sp[dev[i]]) ** 2 for i in ring.local}
        zz = {i: torch.tensor(float(i * Zl), device=dev[i])
              + torch.arange(Zl, dtype=torch.float32,
                             device=dev[i])[:, None, None]
              for i in ring.local}
        cap = {i: torch.tensor(float(H - 2), device=dev[i])
               for i in ring.local}
        if lncc:
            cnt = self.box_sum({i: torch.ones_like(f[i])
                                for i in ring.local})
            # global centring (LNCC's shift invariance): removes the
            # float32 E[x^2] - E[x]^2 cancellation
            f_mean = self._psum_mean({i: f[i].sum() for i in ring.local})
            m_shift = self._psum_mean({i: m[i].sum() for i in ring.local})
            f_cent = {i: f[i] - f_mean[i] for i in ring.local}
            s1 = self.box_sum(f_cent)
            s2 = self.box_sum({i: f_cent[i] * f_cent[i]
                               for i in ring.local})
            mu_f = {i: s1[i] / cnt[i] for i in ring.local}
            var_f = {i: torch.clamp(s2[i] / cnt[i] - mu_f[i] ** 2, min=0.0)
                     for i in ring.local}
            i_f = {i: f_cent[i] - mu_f[i] for i in ring.local}
            vmean = self._psum_mean({i: var_f[i].sum() for i in ring.local})
            v_eps = {i: 1e-5 * torch.clamp(vmean[i], min=1e-12)
                     for i in ring.local}

        u = {i: torch.zeros((3, Zl, self.Y, self.X), dtype=torch.float32,
                            device=dev[i]) for i in ring.local}
        for _ in range(self.iterations):
            w, upd = {}, {}
            for i in ring.local:
                uz = torch.clamp(u[i][2], -cap[i], cap[i])
                disp = torch.stack([u[i][0], u[i][1], uz + float(H)])
                wi = warp_disp(slab[i], disp, 0.0)
                # the slab replicates rows past the volume; out there the
                # single-device kernel samples background 0
                gz = zz[i] + uz
                z_in = (gz >= 0) & (gz <= float(Z - 1))
                w[i] = torch.where(z_in[None], wi, 0.0)
            if lncc:
                w_cent = {i: w[i][0] - m_shift[i] for i in ring.local}
                s1 = self.box_sum(w_cent)
                s2 = self.box_sum({i: w_cent[i] * w_cent[i]
                                   for i in ring.local})
                sc = self.box_sum({i: f_cent[i] * w_cent[i]
                                   for i in ring.local})
                for i in ring.local:
                    mu_m = s1[i] / cnt[i]
                    var_m = torch.clamp(s2[i] / cnt[i] - mu_m ** 2, min=0.0)
                    cross = sc[i] / cnt[i] - mu_f[i] * mu_m
                    upd[i] = _lncc_force(i_f[i], var_f[i], w_cent[i] - mu_m,
                                         var_m, cross, w[i][1:4], v_eps[i])
                # smoothing before the peak normalisation
                upd = self.smooth_field(upd)
            else:
                for i in ring.local:
                    g = 0.5 * (gf[i] + w[i][1:4]) if self.symmetric \
                        else gf[i]
                    upd[i] = _thirion(f[i] - w[i][0], g, K[i],
                                      self.threshold)
            if lncc or self.symmetric:
                # every shard's peak before any shard moves
                peak = ring.pmax({i: torch.max(torch.sum(upd[i] * upd[i],
                                                         dim=0))
                                  for i in ring.local})
                for i in ring.local:
                    max_norm = torch.sqrt(peak[i])
                    if lncc:
                        scale = self.step / torch.clamp(max_norm, min=1e-12)
                    else:
                        scale = torch.clamp(
                            self.step / torch.clamp(max_norm, min=1e-9),
                            max=1.0)
                    upd[i] = upd[i] * scale
            u = {i: u[i] + upd[i] / self.sp[dev[i]][:, None, None, None]
                 for i in ring.local}
            if self.smooth:
                u = self.smooth_field(u)
        return u


def _check_demons(method, forces, name):
    if method not in ("demons", "fast"):
        raise ValueError("sharded demons supports 'demons' and 'fast'; "
                         "use demons_registration for diffeomorphic")
    if forces not in ("ssd", "lncc"):
        raise ValueError(f"{name}: forces must be 'ssd' or 'lncc', got "
                         f"{forces!r}")


def _check_depths(loop, smooth, forces):
    if smooth and loop.radius > loop.Zl:
        raise ValueError(
            f"smoothing radius {loop.radius} exceeds the {loop.Zl}-row "
            "shard depth; lower std or use fewer shards")
    if forces == "lncc" and loop.R > loop.Zl:
        raise ValueError(
            f"lncc_radius {loop.R} exceeds the {loop.Zl}-row shard "
            "depth; use fewer z-shards")


def demons_z_sharded(fixed, moving, mesh, spacing_xyz=(1.0, 1.0, 1.0),
                     method="fast", iterations=30, smooth=True, std=1,
                     step=2.0, intensity_threshold=0.001, halo=16,
                     axis_name="space", forces="ssd", lncc_radius=3):
    """Demons registration of one volume pair z-sharded over
    ``axis_name`` (for a pair too large for one device, or to put every
    device on one pair).

    The moving image and its gradients are extended by ``halo`` rows once;
    every iteration runs one ``disp`` launch per shard on its slab
    (sampling at local row + halo + u_z), the force per shard, one
    ``pmax`` for the step normalisation and, when smoothing, a
    ``radius``-row halo for the z pass (the y/x passes are shard-local
    contractions in full float32). u_z is clamped to ``halo - 2`` rows for
    sampling only; the field keeps its value. Within that bound this is
    ``demons_registration``'s single level; the fields agree to float32
    rounding (the sums run in another order), and where the ``|diff| >
    threshold`` gate flips, to equal warp residuals.

    fixed / moving: (Z, Y, X), Z divisible by the shard count; method
    'demons' or 'fast'; forces 'ssd' or 'lncc'; ``axis_name`` is kept for
    the JAX signature (only 'space' is valid). Returns the (Z, Y, X, 3)
    float32 mm DVF (host numpy, on every process)."""
    _check_demons(method, forces, "demons_z_sharded")
    ring = Ring(mesh, 0, axis_name)
    fixed = fixed if isinstance(fixed, torch.Tensor) \
        else np.asarray(fixed, np.float32)
    moving = moving if isinstance(moving, torch.Tensor) \
        else np.asarray(moving, np.float32)
    Z = fixed.shape[0]
    if Z % ring.n != 0:
        raise ValueError(f"z={Z} not divisible by {ring.n} shards")
    H = _halo_depth(halo, Z // ring.n)
    loop = _PairLoop(ring, tuple(fixed.shape), spacing_xyz, std,
                     method == "fast", smooth, iterations, step,
                     intensity_threshold, H, forces, lncc_radius)
    _check_depths(loop, smooth, forces)
    fb, mb = _put_sharded(mesh, [(fixed, (axis_name,)),
                                 (moving, (axis_name,))])
    u = loop.run({p[1]: b.to(torch.float32) for p, b in fb.items()},
                 {p[1]: b.to(torch.float32) for p, b in mb.items()}) \
        if ring.local else {}
    mm = {(0, i): torch.movedim(u[i], 0, -1) * loop.sp[u[i].device]
          for i in ring.local}
    return _assemble(_replicate(mesh, mm), ring.n, 0)


def demons_batch_z_sharded(fixed_batch, moving_batch, mesh,
                           spacing_xyz=(1.0, 1.0, 1.0), method="fast",
                           iterations=30, smooth=True, std=1, step=2.0,
                           intensity_threshold=0.001, halo=16,
                           data_axis="data", space_axis="space",
                           forces="ssd", lncc_radius=3):
    """Demons over B pairs x z-shards on the whole (data, space) mesh: the
    pairs split over ``data_axis`` and each pair's z axis over
    ``space_axis``, with :func:`demons_z_sharded`'s loop. A data row runs
    its pairs one after another; within the halo cap each field is its
    pair's single-device trajectory to float32 rounding.

    fixed / moving: (B, Z, Y, X), B divisible by the 'data' size and Z by
    the 'space' size; ``data_axis`` / ``space_axis`` are kept for the JAX
    signature (only 'data' / 'space' are valid). Returns (B, Z, Y, X, 3) float32 mm DVFs (host
    numpy, on every process)."""
    _check_demons(method, forces, "demons_batch_z_sharded")
    if (data_axis, space_axis) != mesh.axis_names:
        raise ValueError(f"the mesh's axes are {mesh.axis_names}")
    fixed = fixed_batch if isinstance(fixed_batch, torch.Tensor) \
        else np.asarray(fixed_batch, np.float32)
    moving = moving_batch if isinstance(moving_batch, torch.Tensor) \
        else np.asarray(moving_batch, np.float32)
    B, Z = fixed.shape[0], fixed.shape[1]
    n_data, n_space = mesh.shape[data_axis], mesh.shape[space_axis]
    if B % n_data != 0:
        raise ValueError(f"B={B} not divisible by {n_data} data shards")
    if Z % n_space != 0:
        raise ValueError(f"z={Z} not divisible by {n_space} shards")
    H = _halo_depth(halo, Z // n_space)
    spec = (data_axis, space_axis)
    fb, mb = _put_sharded(mesh, [(fixed, spec), (moving, spec)])
    Bl = B // n_data
    out = {}
    for r in range(n_data):
        ring = Ring(mesh, r, space_axis)
        if not ring.local:
            continue
        loop = _PairLoop(ring, tuple(fixed.shape[1:]), spacing_xyz, std,
                         method == "fast", smooth, iterations, step,
                         intensity_threshold, H, forces, lncc_radius)
        _check_depths(loop, smooth, forces)
        for k in range(Bl):
            u = loop.run({i: fb[(r, i)][k].to(torch.float32)
                          for i in ring.local},
                         {i: mb[(r, i)][k].to(torch.float32)
                          for i in ring.local})
            for i in ring.local:
                out[(r * Bl + k, i)] = torch.movedim(u[i], 0, -1) \
                    * loop.sp[u[i].device]
    everyone = gather_blocks(mesh, out)
    return np.stack([np.concatenate(
        [everyone[(b, i)].cpu().numpy() for i in range(n_space)])
        for b in range(B)])
