"""ICP: rigid point-set registration on the device.

Port of medicalimageanalysis_tpu/ops/registration/icp.py, the
replacement for VTK's vtkIterativeClosestPointTransform and Open3D's
registration_icp (reference utils/rigid/icp.py:28-176):

- correspondences: a brute-force nearest-neighbour scan over target
  chunks with the JAX package's expanded distance |s|^2 - 2 s.t + |t|^2
  (one matmul a chunk) and its first-index tie rule (a later chunk wins
  only when strictly nearer; ``torch.argmin`` keeps the first index
  within a chunk) — plain PyTorch, no KD-tree;
- alignment: the Kabsch / Umeyama SVD solve (``torch.linalg.svd`` on the
  device);
- iteration: VTK's RMS mean-distance convergence test and landmark cap
  (default target/10, reference icp.py:79-80), a Python loop whose
  condition reads one scalar a step; point-to-plane solves the 6x6
  small-angle normal system each step;
- centroid pre-matching like SetStartByMatchingCentroids.

The JAX package pads the clouds to buckets and carries validity masks
for its compiled loop; the port scans the clouds as they are. Everything
runs in float32 on ``device`` (default: the card), with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import default_device, full_float32

__all__ = ["icp_rigid", "icp_rigid_batch", "icp_point_to_plane",
           "icp_point_to_plane_batch", "kabsch", "nearest_neighbors"]

_CHUNK = 2048


def _device(device):
    return default_device() if device is None else torch.device(device)


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


@full_float32()
def _nn_scan(pts, tgt):
    """For each pts row, the index (int64) and squared distance (float32)
    of its nearest tgt row: chunks of _CHUNK target rows, each one
    matmul, a running minimum kept where a chunk is strictly nearer."""
    s2 = torch.sum(pts * pts, dim=1)
    best_d2 = torch.full((pts.shape[0],), float("inf"),
                         dtype=torch.float32, device=pts.device)
    best_idx = torch.zeros(pts.shape[0], dtype=torch.int64,
                           device=pts.device)
    for start in range(0, tgt.shape[0], _CHUNK):
        tc = tgt[start:start + _CHUNK]
        t2 = torch.sum(tc * tc, dim=1)
        d2 = (s2[:, None] - 2.0 * (pts @ tc.T)) + t2[None, :]
        cmin, cidx = torch.min(d2, dim=1)
        better = cmin < best_d2
        best_d2 = torch.where(better, cmin, best_d2)
        best_idx = torch.where(better, cidx + start, best_idx)
    return best_idx, best_d2


def nearest_neighbors(source, target, device=None):
    """Indices into ``target`` of each source point's nearest neighbour
    and the squared distances, as numpy (int64, float32)."""
    dev = _device(device)
    idx, d2 = _nn_scan(_f32(np.reshape(source, (-1, 3)), dev),
                       _f32(np.reshape(target, (-1, 3)), dev))
    return idx.cpu().numpy(), d2.cpu().numpy()


@full_float32()
def _kabsch(src, tgt):
    """Least-squares rigid 4x4 (float32 tensor) taking src onto tgt."""
    cs = torch.mean(src, dim=0)
    ct = torch.mean(tgt, dim=0)
    H = (src - cs).T @ (tgt - ct)
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ D @ U.T
    m = torch.eye(4, dtype=torch.float32, device=src.device)
    m[:3, :3] = R
    m[:3, 3] = ct - R @ cs
    return m


def kabsch(src, tgt, weights=None, device=None):
    """Least-squares rigid transform src -> tgt (rotation + translation),
    a (4, 4) float32 tensor on ``device``. ``weights`` (0 or 1 per point)
    selects the points that count."""
    dev = _device(device)
    s = _f32(src, dev)
    t = _f32(tgt, dev)
    if weights is not None:
        keep = torch.as_tensor(np.asarray(weights) > 0, device=dev)
        s, t = s[keep], t[keep]
    return _kabsch(s, t)


def _apply(m, pts):
    return pts @ m[:3, :3].T + m[:3, 3]


def _rms(d2):
    return torch.sqrt(torch.mean(d2))


@full_float32()
def _icp_loop(src, tgt, init_matrix, tol, max_iterations):
    """Point-to-point ICP. Returns (matrix4 tensor, final RMS mean
    distance, iterations run). Convergence follows VTK's
    SetMeanDistanceModeToRMS + CheckMeanDistance: stop when the RMS mean
    distance changes by less than ``tol``."""
    m = init_matrix
    _, d2 = _nn_scan(_apply(m, src), tgt)
    cur = _rms(d2)
    prev = cur + 2 * tol + 1.0
    it = 0
    while it < max_iterations and float(torch.abs(prev - cur)) > tol:
        pts = _apply(m, src)
        idx, _ = _nn_scan(pts, tgt)
        m = _kabsch(pts, tgt[idx]) @ m
        _, d2 = _nn_scan(_apply(m, src), tgt)
        prev, cur = cur, _rms(d2)
        it += 1
    return m, cur, it


def _small_angle_matrix(x):
    a, b, c = x[0], x[1], x[2]
    one = torch.ones_like(a)
    R = torch.stack([torch.stack([one, -c, b]), torch.stack([c, one, -a]),
                     torch.stack([-b, a, one])])
    # re-orthonormalise through the SVD to keep a proper rotation
    U, _, Vt = torch.linalg.svd(R)
    m = torch.eye(4, dtype=torch.float32, device=x.device)
    m[:3, :3] = U @ Vt
    m[:3, 3] = x[3:6]
    return m


@full_float32()
def _icp_p2l_loop(src, tgt, tgt_normals, init_matrix, tol, max_iterations):
    """Point-to-plane ICP: per iteration, the linearised least squares
    min sum(((R s + t - d) . n)^2) solved as a 6x6 normal system
    (small-angle rotation [a, b, c] + translation)."""
    eye6 = 1e-6 * torch.eye(6, dtype=torch.float32, device=src.device)
    m = init_matrix
    _, d2 = _nn_scan(_apply(m, src), tgt)
    cur = _rms(d2)
    prev = cur + 2 * tol + 1.0
    it = 0
    while it < max_iterations and float(torch.abs(prev - cur)) > tol:
        pts = _apply(m, src)
        idx, _ = _nn_scan(pts, tgt)
        d, n = tgt[idx], tgt_normals[idx]
        # rows: [cross(p, n), n], residual: (d - p) . n
        A = torch.cat([torch.linalg.cross(pts, n), n], dim=1)
        b = torch.sum((d - pts) * n, dim=1)
        x = torch.linalg.solve(A.T @ A + eye6, A.T @ b)
        m = _small_angle_matrix(x) @ m
        _, d2 = _nn_scan(_apply(m, src), tgt)
        prev, cur = cur, _rms(d2)
        it += 1
    return m, cur, it


def _subsample(src, landmarks, seed, sort=True):
    rng = np.random.default_rng(seed)
    sel = rng.choice(src.shape[0], size=landmarks, replace=False)
    return src[np.sort(sel) if sort else sel]


def _init(tgt, src, init_matrix, com_matching):
    m0 = np.eye(4, dtype=np.float32)
    if init_matrix is not None:
        m0 = np.asarray(init_matrix, dtype=np.float32)
    elif com_matching:
        m0[:3, 3] = tgt.mean(axis=0) - src.mean(axis=0)
    return m0


def icp_point_to_plane(source, target, target_normals, distance=1e-7,
                       iterations=100, landmarks=None, com_matching=True,
                       init_matrix=None, seed=0, device=None):
    """Point-to-plane ICP (Open3D TransformationEstimationPointToPlane
    equivalent, reference utils/rigid/icp.py:102-149 'plane' method).
    Returns (matrix4 float64 numpy, info dict)."""
    dev = _device(device)
    src = np.asarray(source, dtype=np.float32).reshape(-1, 3)
    tgt = np.asarray(target, dtype=np.float32).reshape(-1, 3)
    nrm = np.asarray(target_normals, dtype=np.float32).reshape(-1, 3)
    if landmarks is not None and src.shape[0] > landmarks:
        src = _subsample(src, landmarks, seed)
    m0 = _init(tgt, src, init_matrix, com_matching)
    m, md, it = _icp_p2l_loop(_f32(src, dev), _f32(tgt, dev),
                              _f32(nrm, dev), _f32(m0, dev),
                              float(np.float32(distance)), int(iterations))
    return m.cpu().numpy().astype(np.float64), {
        "mean_distance": float(md), "iterations": int(it)}


def icp_rigid(source, target, distance=1e-5, iterations=1000,
              landmarks=None, com_matching=True, init_matrix=None, seed=0,
              device=None):
    """Rigid ICP aligning ``source`` onto ``target`` points.

    Mirrors the VTK variant's controls: ``landmarks`` caps the number of
    source points used (default len(target)/10 like reference
    icp.py:79-80), ``distance`` is the RMS mean-distance convergence
    threshold, ``com_matching`` starts from centroid alignment.

    Returns (matrix4 float64 numpy, info dict).
    """
    dev = _device(device)
    src = np.asarray(source, dtype=np.float32).reshape(-1, 3)
    tgt = np.asarray(target, dtype=np.float32).reshape(-1, 3)
    if landmarks is None:
        landmarks = int(np.round(tgt.shape[0] / 10))
    landmarks = max(4, min(landmarks, src.shape[0]))
    src_used = _subsample(src, landmarks, seed) \
        if src.shape[0] > landmarks else src
    m0 = _init(tgt, src_used, init_matrix, com_matching)
    m, md, it = _icp_loop(_f32(src_used, dev), _f32(tgt, dev),
                          _f32(m0, dev), float(np.float32(distance)),
                          int(iterations))
    return m.cpu().numpy().astype(np.float64), {
        "mean_distance": float(md), "iterations": int(it),
        "landmarks": int(src_used.shape[0])}


def _batch(sources, targets, normals, distance, iterations, com_matching,
           device):
    dev = _device(device)
    src = np.asarray(sources, dtype=np.float32)
    tgt = np.asarray(targets, dtype=np.float32)
    mats, mds = [], []
    for b in range(src.shape[0]):
        m0 = _init(tgt[b], src[b], None, com_matching)
        args = (_f32(src[b], dev), _f32(tgt[b], dev))
        if normals is not None:
            args += (_f32(normals[b], dev),)
        loop = _icp_loop if normals is None else _icp_p2l_loop
        m, md, _ = loop(*args, _f32(m0, dev), float(np.float32(distance)),
                        int(iterations))
        mats.append(m)
        mds.append(md)
    return (torch.stack(mats).cpu().numpy().astype(np.float64),
            torch.stack(mds).cpu().numpy())


def icp_rigid_batch(sources, targets, distance=1e-5, iterations=200,
                    com_matching=True, device=None):
    """Batched rigid ICP over B point-set pairs, each pair iterating to
    its own convergence (as the JAX package's vmapped loop does).

    sources: (B, L, 3); targets: (B, T, 3) — pre-padded to shared sizes
    (pad by repeating a real point so NN stays valid).
    Returns (B, 4, 4) matrices and per-pair RMS distances.
    """
    return _batch(sources, targets, None, distance, iterations,
                  com_matching, device)


def icp_point_to_plane_batch(sources, targets, target_normals,
                             distance=1e-7, iterations=100,
                             com_matching=True, device=None):
    """Batched point-to-plane ICP, the counterpart of
    :func:`icp_rigid_batch`: sources (B, L, 3); targets / target_normals
    (B, T, 3). Returns (B, 4, 4) matrices and per-pair RMS distances."""
    return _batch(sources, targets,
                  np.asarray(target_normals, np.float32), distance,
                  iterations, com_matching, device)
