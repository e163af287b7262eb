"""Device meshes: a (data, space) grid of torch devices.

Port of medicalimageanalysis_tpu/parallel/mesh.py. ``data`` splits a batch
of series, ``space`` splits one volume's z axis.

Execution model. The shards of a mesh run in lockstep from one Python
thread: a function holds one tensor per shard, each on its shard's device,
and steps them together. The collectives are functions over those tensors:
``Ring.ppermute`` copies between neighbouring shards along ``space`` (a
fresh tensor each time, never a view of the neighbour's block), and
``Ring.psum`` / ``Ring.pmax`` reduce the shards' 0-d tensors. Across
processes they call ``torch.distributed``: ``batch_isend_irecv`` for the
neighbour copies, ``all_reduce`` for the reductions, gloo for CPU
tensors and NCCL for CUDA tensors. A device may appear more
than once: four shards on one card are four logical shards, each with its
own tensors and kernel launches.

A mesh holds no DTensor: DTensor puts one rank on a device and cannot hold
several logical shards on one card.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["make_mesh", "volume_sharding", "batch_sharding",
           "replicated_sharding", "initialize_distributed",
           "shard_map_nocheck"]


def _dist():
    """torch.distributed when a process group is up, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _rank():
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


class Mesh:
    """A (data, space) array of ``torch.device`` and the rank of the
    process that holds each entry. ``shape`` maps each axis name to its
    size, as the JAX mesh's does."""

    axis_names = ("data", "space")

    def __init__(self, devices, ranks, groups=None):
        self.devices = devices
        self.ranks = ranks
        self._groups = groups or {}

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def multiprocess(self):
        return len(set(self.ranks.flat)) > 1

    def is_local(self, r, c):
        return int(self.ranks[r, c]) == _rank()

    def local_rows(self):
        """The data rows whose first space entry this process holds: the
        rows a data-sharded call computes here."""
        return [r for r in range(self.devices.shape[0])
                if self.is_local(r, 0)]

    def psum(self, values):
        """{position: 0-d tensor} of the positions this process holds ->
        their sum over the whole mesh, every process (an all_reduce across
        processes); on the device of this process's first position."""
        return _reduce(values, self.multiprocess, None, "sum")

    def local_device(self):
        """The first mesh device this process holds (the CPU if none)."""
        mine = [self.devices[p]
                for p in zip(*np.nonzero(self.ranks == _rank()))]
        return mine[0] if mine else torch.device("cpu")

    def group(self, row):
        """The process group of a data row's ranks (None: the default
        group, or a row held by one process)."""
        return self._groups.get(row)

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def _reduce(values, spans, group, op):
    """{key: 0-d tensor} of this process -> their sum (or maximum), the
    keys taken in order on the first key's device, then all_reduce'd over
    ``group`` when ``spans`` (the values sit in more than one process)."""
    keys = sorted(values)
    acc = values[keys[0]]
    for k in keys[1:]:
        v = values[k].to(acc.device)
        acc = acc + v if op == "sum" else torch.maximum(acc, v)
    if spans:
        import torch.distributed as dist

        acc = acc.clone()
        dist.all_reduce(acc, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=group)
    return acc


def _local_devices():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA device. A mesh runs on the cards; to build "
            "one on the CPU pass devices=['cpu'] * n.")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices=None, space=1, devices=None):
    """(data, space) mesh; ``space`` shards the volume z axis.

    ``devices``: this process's devices (default: every local card; with
    no card and no ``devices`` it raises). An entry may repeat: the shards
    then share the device. With a process group up every process calls
    this, and the mesh takes every rank's devices, rank-major, as
    ``jax.devices()`` orders them; the first ``n_devices`` of them form
    the mesh.
    """
    local = _local_devices() if devices is None \
        else [torch.device(d) for d in devices]
    dist = _dist()
    if dist is not None and dist.get_world_size() > 1:
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, [str(d) for d in local])
        entries = [(torch.device(d), r) for r, devs in enumerate(gathered)
                   for d in devs]
    else:
        entries = [(d, _rank()) for d in local]
    if n_devices is None:
        n_devices = len(entries)
    if n_devices > len(entries):
        raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                         f"{len(entries)} available")
    entries = entries[:n_devices]
    if n_devices % space != 0:
        raise ValueError(f"n_devices {n_devices} not divisible by "
                         f"space {space}")
    kinds = {d.type for d, _ in entries}
    if len(kinds) != 1:
        raise ValueError(f"make_mesh: a mesh holds one device type, got "
                         f"{sorted(kinds)}")
    devs = np.empty(n_devices, dtype=object)
    devs[:] = [d for d, _ in entries]
    ranks = np.asarray([r for _, r in entries], np.int64)
    shape = (n_devices // space, space)
    devs, ranks = devs.reshape(shape), ranks.reshape(shape)
    groups = {}
    if dist is not None and dist.get_world_size() > 1:
        kind = kinds.pop()
        want = "nccl" if kind == "cuda" else "gloo"
        config = dist.get_backend_config()
        have = dict(item.split(":") for item in config.split(","))
        if have.get(kind) != want:
            raise ValueError(
                f"make_mesh: a mesh of {kind} devices across processes "
                f"needs the {want} backend for {kind}, the process group "
                f"runs {config}: no tensor is staged through the host")
        # every process creates every row's group, in row order
        world = list(range(dist.get_world_size()))
        made = {}
        for r in range(shape[0]):
            row = sorted(set(int(v) for v in ranks[r]))
            if 1 < len(row) < len(world):
                if tuple(row) not in made:
                    made[tuple(row)] = dist.new_group(row)
                groups[r] = made[tuple(row)]
    return Mesh(devs, ranks, groups)


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Start the process group so that make_mesh spans processes.

    The coordinator is ``coordinator_address`` ("host:port"), else the
    ``MIA_COORDINATOR`` environment variable; without either, torchrun's
    environment (MASTER_ADDR, WORLD_SIZE, RANK) serves; without that it
    returns False. CPU tensors go through gloo; with a card present CUDA
    tensors go through NCCL ("cpu:gloo,cuda:nccl"), so a mesh of either
    device type can span processes (make_mesh checks the mesh's type has
    its backend). With a card each process takes the card of its local
    rank (LOCAL_RANK, else its rank modulo the cards). Returns True."""
    import torch.distributed as dist

    if coordinator_address is None:
        coordinator_address = os.environ.get("MIA_COORDINATOR")
    torchrun = coordinator_address is None and all(
        k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"))
    if coordinator_address is None and not torchrun:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "cpu:gloo,cuda:nccl"
        local = int(os.environ.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    init = "env://" if torchrun else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


class Ring:
    """The shards of one data row along ``space``: positions 0..n-1, their
    devices and ranks, the positions this process holds (``local``) and
    the collectives over them."""

    def __init__(self, mesh, row=0, axis_name="space"):
        # axis_name is kept for the JAX signature: z shards over 'space'
        if axis_name != "space":
            raise ValueError(f"the z axis shards over 'space', got "
                             f"{axis_name!r}")
        self.devices = list(mesh.devices[row])
        self.ranks = [int(v) for v in mesh.ranks[row]]
        self.n = len(self.devices)
        me = _rank()
        self.local = [i for i in range(self.n) if self.ranks[i] == me]
        self.spans = len(set(self.ranks)) > 1
        self.group = mesh.group(row)

    def ppermute(self, blocks, shift):
        """``blocks``: {position: tensor} for the local positions, all of
        one shape. Returns {i: copy of block i - shift on shard i's
        device} for every local i with a source inside the row (no wrap:
        the callers fill the global edges themselves). Each is a fresh
        tensor."""
        out = {}
        for i in self.local:
            j = i - shift
            if 0 <= j < self.n and self.ranks[j] == self.ranks[i]:
                out[i] = blocks[j].to(device=self.devices[i], copy=True,
                                      memory_format=torch.contiguous_format)
        if self.spans:
            import torch.distributed as dist

            me, ops, like = _rank(), [], blocks[self.local[0]]
            # one order on every process: the sources by position
            for j in range(self.n):
                i = j + shift
                if not 0 <= i < self.n or self.ranks[i] == self.ranks[j]:
                    continue
                tag = 2 * j + (shift > 0)
                if self.ranks[j] == me:
                    ops.append(dist.P2POp(dist.isend, blocks[j].contiguous(),
                                          self.ranks[i], self.group, tag))
                if self.ranks[i] == me:
                    out[i] = torch.empty(like.shape, dtype=like.dtype,
                                         device=self.devices[i])
                    ops.append(dist.P2POp(dist.irecv, out[i], self.ranks[j],
                                          self.group, tag))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        return out

    def _reduce(self, values, op):
        acc = _reduce(values, self.spans, self.group, op)
        return {i: acc.to(self.devices[i]) for i in self.local}

    def psum(self, values):
        """{position: 0-d tensor} -> the sum over every shard of the row,
        on each local shard's device (local shards added in position
        order, then an all_reduce across processes)."""
        return self._reduce(values, "sum")

    def pmax(self, values):
        """As :meth:`psum`, the maximum: exact, whatever the order."""
        return self._reduce(values, "max")


class Sharded:
    """A global array laid over a mesh: ``blocks`` maps a mesh position
    (data, space) to the tensor of the block that position holds (only the
    positions of this process, unless replicated), ``shape`` is the global
    shape. ``np.asarray`` assembles it on the host."""

    def __init__(self, sharding, shape, blocks):
        self.sharding = sharding
        self.shape = tuple(int(s) for s in shape)
        self.blocks = blocks

    def numpy(self):
        return self.sharding.gather(self)

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)


class Sharding:
    """How an array lies on a mesh: ``dims`` names, for each leading
    dimension of the array, the mesh axis that splits it (None: whole).
    A mesh axis that ``dims`` does not name is not replicated: the block
    sits on that axis's index-0 device (the port computes each block
    once)."""

    def __init__(self, mesh, dims):
        self.mesh = mesh
        self.dims = tuple(dims)
        for a in self.dims:
            if a is not None and a not in mesh.axis_names:
                raise ValueError(f"unknown mesh axis {a!r}")

    def positions(self):
        """Every (data, space) position holding a block, in order."""
        sizes = [self.mesh.shape[a] if a in self.dims else 1
                 for a in self.mesh.axis_names]
        return [(r, c) for r in range(sizes[0]) for c in range(sizes[1])]

    def _slices(self, shape, pos):
        out = []
        for d, a in enumerate(self.dims):
            if a is None:
                out.append(slice(None))
                continue
            n = self.mesh.shape[a]
            if shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} not "
                                 f"divisible by the {a!r} axis ({n})")
            k, size = pos[self.mesh.axis_names.index(a)], shape[d] // n
            out.append(slice(k * size, (k + 1) * size))
        return tuple(out)

    def split(self, array):
        """One upload per block this process holds, each block sliced on
        the host (or from the tensor given): the whole array never lands
        on one device. Returns a :class:`Sharded`."""
        blocks = {}
        for pos in self.positions():
            if not self.mesh.is_local(*pos):
                continue
            part = array[self._slices(array.shape, pos)]
            dev = self.mesh.devices[pos]
            if isinstance(part, torch.Tensor):
                blocks[pos] = part.to(device=dev, copy=True,
                                      memory_format=torch.contiguous_format)
            else:
                blocks[pos] = torch.as_tensor(np.ascontiguousarray(part),
                                              device=dev)
        return Sharded(self, array.shape, blocks)

    def gather(self, sharded):
        """The whole array on the host (numpy). Every block must be held
        here: across processes, replicate first (``halo._replicate``)."""
        missing = [p for p in self.positions() if p not in sharded.blocks]
        if missing:
            raise ValueError(f"blocks at {missing} belong to other "
                             "processes: replicate the array first")
        first = sharded.blocks[self.positions()[0]]
        dtype = torch.empty(0, dtype=first.dtype).numpy().dtype
        out = np.empty(sharded.shape, dtype=dtype)
        for pos in self.positions():
            out[self._slices(sharded.shape, pos)] = \
                sharded.blocks[pos].cpu().numpy()
        return out


def volume_sharding(mesh):
    """(B, Z, Y, X) volumes: batch over 'data', z over 'space'."""
    return Sharding(mesh, ("data", "space"))


def batch_sharding(mesh):
    """(B, ...) per-series quantities: batch over 'data'."""
    return Sharding(mesh, ("data",))


def replicated_sharding(mesh):
    """One block, on the mesh's first device."""
    return Sharding(mesh, ())


def _merge(parts):
    """Per-block results (in block order) -> one result: arrays and
    tensors concatenated along their first dimension, lists joined, dicts
    and tuples merged item by item; anything else (a scalar every block
    shares) taken from the first block."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _merge([p[k] for p in parts]) for k in first}
    if isinstance(first, tuple):
        return tuple(_merge(list(z)) for z in zip(*parts))
    if isinstance(first, list):
        return [x for p in parts for x in p]
    if isinstance(first, np.ndarray) and first.ndim:
        return np.concatenate(parts)
    if isinstance(first, torch.Tensor) and first.dim():
        return torch.cat([p.to(first.device) for p in parts])
    return first


def _moved(tree, device):
    """A result with its tensor leaves moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_moved(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def gather_blocks(mesh, results):
    """{position: result} of this process -> the results of every process
    by position (an all_gather across processes; tensors come back on this
    process's first mesh device)."""
    dist = _dist()
    if dist is None or not mesh.multiprocess:
        return dict(results)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, {k: _moved(v, "cpu")
                                      for k, v in results.items()})
    device = mesh.local_device()
    out = {}
    for part in everyone:
        out.update({k: _moved(v, device) for k, v in part.items()})
    return out


def shard_map_nocheck(f, mesh, in_specs, out_specs=None):
    """The lockstep helper for bodies without collectives: split each input
    by its spec (a tuple of mesh axis names, one per leading dimension;
    :class:`Sharding`), call ``f`` once per block this process holds, with
    that block's tensors on its device, then merge the blocks' results in
    block order (:func:`_merge`: concatenated along dimension 0), across
    processes too. ``out_specs`` is accepted for the JAX signature; the
    results concatenate along the first dimension."""
    del out_specs

    def run(*arrays):
        shardings = [Sharding(mesh, s) for s in in_specs]
        parts = [a if isinstance(a, Sharded) else s.split(a)
                 for s, a in zip(shardings, arrays)]
        positions = shardings[0].positions()
        results = {pos: f(*[p.blocks[pos] for p in parts])
                   for pos in positions if mesh.is_local(*pos)}
        everyone = gather_blocks(mesh, results)
        return _merge([everyone[pos] for pos in positions])

    return run
