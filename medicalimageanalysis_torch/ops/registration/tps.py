"""Thin-plate-spline landmark interpolation (3-D biharmonic).

Port of medicalimageanalysis_tpu/ops/registration/tps.py: the
minimum-bending-energy interpolant of scattered displacements, with the
3-D biharmonic Green's function U(r) = r:

    d(q) = sum_i w_i |q - p_i|  +  A [1, q]

and the bordered system (K - lam*I) W + P A = V, P^T W = 0. The solve
(``tps_fit``) is a small host float64 problem (N landmarks ~ tens). The
evaluation is plain PyTorch on the device, chunked over queries: the
(chunk, N) squared distances in the JAX package's expanded form, its
q.p term summed by elementwise operations so that it cancels exactly at
the landmarks (float32, TF32 off for the combining matmuls), and the
grid's query positions made on the device from the flat voxel index,
chunk by chunk. ``_centered`` moves the frame to
the landmark centroid first: at clinical coordinate magnitudes the
float32 |q|^2 + |p|^2 - 2 q.p would otherwise cancel to a fraction of a
mm at the landmarks.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import default_device, full_float32

__all__ = ["tps_fit", "tps_displacement", "tps_displacement_grid"]

CHUNK = 262144      # queries a contraction: (CHUNK, N) float32 distances


def tps_fit(points, displacements, regularization=0.0):
    """Solve the 3-D TPS bordered system on host in float64.

    Parameters
    ----------
    points : (N, 3) anchor positions (mm, physical frame).
    displacements : (N, 3) displacement at each anchor.
    regularization : lam >= 0 added to the kernel diagonal; 0 gives
        exact interpolation, > 0 approximates (smoother, bounded
        bending energy under landmark jitter).

    Returns (W (N, 3), A (4, 3)) with the affine part ordered
    [const, x, y, z].
    """
    P = np.asarray(points, np.float64).reshape(-1, 3)
    V = np.asarray(displacements, np.float64).reshape(-1, 3)
    if P.shape[0] != V.shape[0]:
        raise ValueError("tps_fit: points/displacements length mismatch")
    n = P.shape[0]
    if n == 0:
        raise ValueError("tps_fit: no landmarks")
    if regularization < 0:
        raise ValueError("tps_fit: negative regularization")

    K = np.linalg.norm(P[:, None, :] - P[None, :, :], axis=2)
    if regularization:
        # the 3-D kernel +r is conditionally NEGATIVE definite on the
        # P^T W = 0 subspace, so the ridge carries the kernel's sign
        K = K - float(regularization) * np.eye(n)
    Q = np.concatenate([np.ones((n, 1)), P], axis=1)  # (N, 4)
    L = np.zeros((n + 4, n + 4))
    L[:n, :n] = K
    L[:n, n:] = Q
    L[n:, :n] = Q.T
    rhs = np.concatenate([V, np.zeros((4, 3))], axis=0)
    # lstsq: degenerate layouts (coplanar / collinear / too few
    # landmarks) drop the unresolvable affine directions
    sol = np.linalg.lstsq(L, rhs, rcond=None)[0]
    return sol[:n].astype(np.float64), sol[n:].astype(np.float64)


def _sq_norms(x):
    """Row-wise x . x, summed in the order of :func:`_kernel_eval`'s
    cross term."""
    return x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]


def _kernel_eval(q, P, W, A, p_sq):
    """(C, 3) centered queries -> (C, 3) displacements.

    The JAX package's |q|^2 + |p|^2 - 2 q.p, with the three dot products
    summed in one order by separate elementwise operations: at a
    landmark the terms then cancel to exactly 0, as they do in the JAX
    package. A matmul for q.p (fused multiply-adds on the card) would
    leave ~eps |q|^2 there, and the square root would turn that into
    hundredths of a mm of kernel at the landmarks."""
    q_sq = _sq_norms(q)[:, None]                          # (C, 1)
    cross = q[:, 0:1] * P[:, 0] + q[:, 1:2] * P[:, 1] \
        + q[:, 2:3] * P[:, 2]                             # (C, N)
    d2 = torch.clamp(q_sq + p_sq[None, :] - 2.0 * cross, min=0.0)
    U = torch.sqrt(d2)
    return U @ W + A[0][None, :] + q @ A[1:]


def _centered(points, W, A):
    """Shift the evaluation frame to the landmark centroid; the affine
    constant absorbs the shift exactly: A0' = A0 + c @ A[1:]."""
    P = np.asarray(points, np.float64).reshape(-1, 3)
    c = P.mean(axis=0)
    A = np.asarray(A, np.float64)
    A0 = A[0] + c @ A[1:]
    A_shift = np.concatenate([A0[None, :], A[1:]], axis=0)
    return (P - c), A_shift, c


def _tensors(device, *arrays):
    dev = default_device() if device is None else torch.device(device)
    return [torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                            device=dev) for a in arrays]


@full_float32()
def tps_displacement(points, W, A, queries, chunk=CHUNK, device=None):
    """Evaluate the fitted spline at (G, 3) query positions: a (G, 3)
    float32 tensor on ``device`` (default: the card)."""
    Pc, A_shift, c = _centered(points, W, A)
    q = np.asarray(queries, np.float64).reshape(-1, 3) - c
    q, P, Wt, At = _tensors(device, q, Pc, W, A_shift)
    p_sq = _sq_norms(P)
    return torch.cat([_kernel_eval(q[s:s + chunk], P, Wt, At, p_sq)
                      for s in range(0, q.shape[0], int(chunk))])


@full_float32()
def tps_displacement_grid(points, W, A, origin, spacing, matrix, shape,
                          chunk=CHUNK, device=None):
    """Dense (Z, Y, X, 3) mm displacement field over a grid, a float32
    tensor on ``device`` (default: the card).

    Grid voxel (z, y, x) sits at physical position
    origin + [x sx, y sy, z sz] @ matrix (rows = pixel-axis directions).
    The package's DVF samplers index fields axis-aligned as
    (p - origin) / spacing: pass matrix=np.eye(3) for a field those
    samplers will consume (Deformable.compute_tps does).
    """
    Z, Y, X = (int(v) for v in shape)
    G = Z * Y * X
    Pc, A_shift, c = _centered(points, W, A)
    P, Wt, At, org, sp, M = _tensors(
        device, Pc, W, A_shift, np.asarray(origin, np.float64) - c,
        spacing, matrix)
    p_sq = _sq_norms(P)
    out = torch.empty((G, 3), dtype=torch.float32, device=P.device)
    for start in range(0, G, int(chunk)):
        idx = torch.arange(start, min(start + int(chunk), G),
                           device=P.device)
        z = idx // (Y * X)
        rem = idx % (Y * X)
        y = rem // X
        x = rem % X
        pix = torch.stack([x.to(torch.float32) * sp[0],
                           y.to(torch.float32) * sp[1],
                           z.to(torch.float32) * sp[2]], dim=1)
        q = pix @ M + org[None, :]
        out[start:start + idx.shape[0]] = _kernel_eval(q, P, Wt, At, p_sq)
    return out.reshape(Z, Y, X, 3)
