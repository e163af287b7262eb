"""Cohort ingest: whole-patient batches through the batched preprocess.

Port of medicalimageanalysis_tpu/parallel/cohort.py: parse and assemble a
cohort, then run rescale + resample + Gaussian + external mask for every
series of a shape in one batched call (parallel/batch.make_preprocess_fn),
optionally split over a mesh's 'data' axis; and the multi-process pattern,
in which every process reads its own files and contributes them as its
blocks of one global batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import Data
from ..telemetry import trace

__all__ = ["ingest_cohort", "distributed_cohort_batch"]


def distributed_cohort_batch(local_volumes, mesh):
    """A global (B_total, Z, Y, X) batch over the mesh from each process's
    local series: every process reads and assembles its own files, and its
    volumes become the blocks of the global batch that its devices hold
    (rank-major, as the mesh orders them; only blocks exist, nothing moves
    until a collective asks for it).

    local_volumes : this process's (Z, Y, X) arrays; every process
        contributes the same count and shape (checked across processes).
    Returns a :class:`mesh.Sharded` laid out as ``volume_sharding(mesh)``
    (batch over 'data', z over 'space'), ``shape`` (B_total, Z, Y, X).
    """
    from .mesh import Sharded, _dist, _rank, volume_sharding

    local = np.stack([np.asarray(v) for v in local_volumes])
    dist = _dist()
    if dist is not None:
        shapes = [None] * dist.get_world_size()
        dist.all_gather_object(shapes, local.shape)
        if len(set(shapes)) != 1:
            raise ValueError(f"distributed_cohort_batch: every process must "
                             f"contribute the same stack, got {shapes}")
        n_proc = len(shapes)
    else:
        n_proc = 1
    shape = (local.shape[0] * n_proc,) + local.shape[1:]
    sharding = volume_sharding(mesh)
    me = _rank()
    positions = sharding.positions()
    held = [p for p in positions if mesh.is_local(*p)]
    if not held:
        return Sharded(sharding, shape, {})
    # this process's blocks cover its own contiguous run of the batch
    offset = me * local.shape[0]
    blocks = {}
    for pos in held:
        sl = sharding._slices(shape, pos)
        b0, b1 = sl[0].start - offset, sl[0].stop - offset
        if b0 < 0 or b1 > local.shape[0]:
            raise ValueError(
                "distributed_cohort_batch: the mesh places batch rows "
                f"{sl[0].start}-{sl[0].stop} on process {me}, which holds "
                f"rows {offset}-{offset + local.shape[0]}")
        blocks[pos] = torch.as_tensor(
            np.ascontiguousarray(local[(slice(b0, b1),) + sl[1:]]),
            device=mesh.devices[pos])
    return Sharded(sharding, shape, blocks)


def ingest_cohort(folder_path=None, file_list=None, out_shape=None,
                  threshold=-250.0, sigma_vox=1.0, mesh=None, clear=True,
                  keep_host_arrays=True, device=None):
    """read_dicoms + the batched preprocessing of a cohort.

    Series are grouped by shape; each group runs through one
    ``make_preprocess_fn`` call (with ``mesh``: split over its 'data'
    axis, each row on its device; the group's size must divide by it).
    ``device`` is where the series are read and, without a mesh, where
    the preprocess runs (default: the card when present). A mesh that
    spans processes is refused: this reads this process's files; see
    :func:`distributed_cohort_batch`.

    Returns dict: image_name -> {"volume": (oz, oy, ox) float32 tensor,
    "mask": uint8 tensor}, on the device that computed them.
    """
    from .. import reader
    from ..device import default_device
    from ..ops.volume import stored_to_float
    from .batch import _data_sharded_call, make_preprocess_fn

    if mesh is not None and mesh.multiprocess:
        raise ValueError("ingest_cohort reads this process's files: use a "
                         "mesh of this process's devices, and "
                         "distributed_cohort_batch for the global batch")
    device = default_device() if device is None else torch.device(device)
    with trace("mia.cohort.ingest"):
        dicom_reader = reader.read_dicoms(
            folder_path=folder_path, file_list=file_list, clear=clear,
            device=device)

    names = list(dicom_reader.report.images_created or Data.image_list)
    names = [n for n in names
             if Data.image[n].array is not None
             and Data.image[n].array.ndim == 3]
    by_shape = {}
    for n in names:
        by_shape.setdefault(Data.image[n].array.shape, []).append(n)

    fns = {}

    def run(batch, dev):
        out = tuple(out_shape) if out_shape is not None else batch.shape[1:]
        key = (batch.shape[1:], str(dev))
        if key not in fns:
            fns[key] = make_preprocess_fn(
                batch.shape[1:], out, ffs_op="none", threshold=threshold,
                sigma_vox=sigma_vox, device=dev)
        ones = torch.ones(len(batch), dtype=torch.float32, device=dev)
        return fns[key](stored_to_float(batch, dev), ones,
                        torch.zeros_like(ones))

    results = {}
    for shape, group in by_shape.items():
        batch = np.stack([Data.image[n].array for n in group])
        with trace("mia.cohort.device"):
            if mesh is None:
                vols, masks = run(batch, device)
                rows = [(vols, masks)]
            else:
                rows = _data_sharded_call(
                    "ingest_cohort", mesh,
                    lambda b, device: [run(b, device)], [batch])
        per = [(v[i], m[i]) for v, m in rows for i in range(len(v))]
        for n, (v, m) in zip(group, per):
            results[n] = {"volume": v, "mask": m}
            if not keep_host_arrays:
                Data.image[n].array = None
    return results
