"""Two processes over torch.distributed (gloo, CPU): the port's
counterpart of test_distributed.py.

Each worker starts the process group through
``parallel.mesh.initialize_distributed`` (MIA_COORDINATOR), reads its own
synthetic DICOM folder with ``ingest_cohort``, and contributes its series
as its blocks of one global batch (``distributed_cohort_batch``) over a
mesh built from both processes' devices; one reduction over the shards
(``Mesh.psum``, an all_reduce across the processes) must give the sum of
the series means, 1000. A ``dvh_batch`` over that mesh (two data rows in
each process) must equal ``mesh=None`` in both processes. Then ``demons_z_sharded`` runs on a mesh whose
'space' axis spans both processes (two shards each), so the halo
exchange crosses them (``batch_isend_irecv``) and the step normalisation
takes an all_reduce; its field must lie within 2e-3 mm of each worker's
own ``demons_registration`` (test_parallel.py's tolerance: the sums run
in another order). On a mesh of two data rows, one in each process,
the second process holds no shard of the row that computes: the z-sharded
demons, Gaussian and warp must hand it the result (and the halo-cap
warning) all the same. The CPU tensors go through gloo whether or not
the host has a card. Each worker asserts that neither jax nor the JAX
package was imported. A hang fails the test at the timeout (the workers
are killed) instead of stalling the run.

A second pair of workers runs ``demons_batch`` over four data rows, two
in each process: each steps its own rows in lockstep, and both get the
four fields in batch order, equal to ``mesh=None``'s.
"""

import os
import socket
import subprocess
import sys
import tempfile

_WORKER = r"""
import os, sys, tempfile
import numpy as np
import torch

pid = int(sys.argv[1])
port = sys.argv[2]
os.environ["MIA_COORDINATOR"] = f"localhost:{port}"
torch.set_num_threads(1)

from medicalimageanalysis_torch.device import set_default_device
set_default_device("cpu")
from medicalimageanalysis_torch.parallel.mesh import (
    initialize_distributed, make_mesh)
ok = initialize_distributed(num_processes=2, process_id=pid)
assert ok, "initialize_distributed returned False with a coordinator set"
import torch.distributed as dist
assert dist.get_world_size() == 2
backends = dict(b.split(":") for b in dist.get_backend_config().split(","))
assert backends["cpu"] == "gloo", backends

# host-local ingest: each worker reads its own folder
from medicalimageanalysis_torch.data import Data
from medicalimageanalysis_torch.parallel.cohort import (
    distributed_cohort_batch, ingest_cohort)
from medicalimageanalysis_torch.utils.creation import CreateDicomImage

tmp = tempfile.mkdtemp()
for s in range(2):
    arr = np.full((8, 16, 16), 100 * (pid * 2 + s + 1), np.int16)
    CreateDicomImage(os.path.join(tmp, f"s{s}"), arr,
                     spacing=[1.0, 1.0], thickness=2.0).run()
results = ingest_cohort(folder_path=tmp)
names = sorted(results)
assert len(names) == 2, names

mesh = make_mesh(8, space=2, devices=["cpu"] * 4)   # 4 per process
assert mesh.shape == {"data": 4, "space": 2}
local_vols = [np.asarray(Data.image[n].array, np.float32) for n in names]
gbatch = distributed_cohort_batch(local_vols, mesh)
assert gbatch.shape == (4, 8, 16, 16), gbatch.shape
# series values 100, 200 (process 0) and 300, 400 (process 1): the sum of
# the per-series means is the global sum over the series' voxel count
total = mesh.psum({pos: b.to(torch.float64).sum()
                   for pos, b in gbatch.blocks.items()})
val = float(total) / (8 * 16 * 16)
assert abs(val - 1000.0) < 1e-3, val

# a data-sharded call whose rows sit in both processes: each process runs
# its two rows, and both get the whole panel, equal to mesh=None's
from medicalimageanalysis_torch.parallel.batch import dvh_batch
rng = np.random.default_rng(7)
doses = rng.uniform(0, 70, (4, 6, 8, 8)).astype(np.float32)
masks = (rng.random((4, 6, 8, 8)) > 0.5).astype(np.uint8)
sharded = dvh_batch(doses, masks, 0.002, mesh=mesh)
single = dvh_batch(doses, masks, 0.002)
assert sharded.keys() == single.keys()
for k in single:
    assert np.array_equal(sharded[k], single[k], equal_nan=True), k

# one volume z-sharded over a 'space' axis that spans both processes
from medicalimageanalysis_torch.ops.registration.demons import (
    demons_registration)
from medicalimageanalysis_torch.parallel.halo import demons_z_sharded

span = make_mesh(4, space=4, devices=["cpu"] * 2)
assert [int(r) for r in span.ranks[0]] == [0, 0, 1, 1]
zz, yy, xx = np.mgrid[0:16, 0:16, 0:16].astype(np.float32)
fx = (np.exp(-(((zz - 8) / 3) ** 2 + ((yy - 8) / 4) ** 2
               + ((xx - 8) / 4) ** 2)) * 100).astype(np.float32)
mv = np.roll(fx, shift=1, axis=2).astype(np.float32)
got = demons_z_sharded(fx, mv, span, iterations=4, std=1, halo=4)
ref = demons_registration(fx, mv, method="fast", iterations=4, std=1,
                          device="cpu")
derr = float(np.abs(got - ref).max())
assert derr < 2e-3, f"sharded demons mismatch across processes: {derr}"
assert np.abs(got[..., 0]).max() > 0.1

# two data rows, one in each process (two devices each): process 1 holds
# no position of row 0, which computes; it receives the result, and the
# halo-cap warning, through the all_gather
import warnings

from medicalimageanalysis_torch.ops.filters import _gauss_kernel_matrix
from medicalimageanalysis_torch.ops.registration.dvf import warp_volume
from medicalimageanalysis_torch.parallel.halo import (gaussian_z_sharded,
                                                      warp_z_sharded)

rows2 = make_mesh(4, space=2, devices=["cpu"] * 2)
assert rows2.shape == {"data": 2, "space": 2}
assert [int(r) for r in rows2.ranks[:, 0]] == [0, 1]
got2 = demons_z_sharded(fx, mv, rows2, iterations=4, std=1, halo=4)
assert float(np.abs(got2 - ref).max()) < 2e-3, pid
g2 = np.asarray(gaussian_z_sharded(fx, 1.0, rows2))
g1 = np.einsum("ij,jyx->iyx", _gauss_kernel_matrix(16, 1.0), fx)
assert float(np.abs(g2 - g1).max()) < 2e-3, pid
dvf = np.zeros((16, 16, 16, 3), np.float32)
dvf[..., 0] = 0.7
dvf[2, :, :, 2] = 6.0          # 6 rows: beyond the halo-4 cap of 2 rows
with warnings.catch_warnings(record=True) as rec:
    warnings.simplefilter("always")
    w2 = np.asarray(warp_z_sharded(fx, dvf, rows2, background=-1.0,
                                   halo=4))
assert any("(cap 2 rows)" in str(r.message) for r in rec), pid
w1 = warp_volume(fx, dvf, (1.0, 1.0, 1.0), background=-1.0,
                 device="cpu").numpy()
assert np.all(w2[2] == -1.0) and not np.all(w1[2] == -1.0)
keep = np.arange(16) != 2
assert float(np.abs(w2[keep] - w1[keep]).max()) < 2e-3, pid
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "medicalimageanalysis_tpu"))
assert not loaded, loaded
dist.destroy_process_group()
print(f"worker {pid} OK total={val} demons_err={derr:.2e}")
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_BATCH_WORKER = r"""
import os, sys
import numpy as np
import torch

pid = int(sys.argv[1])
os.environ["MIA_COORDINATOR"] = f"localhost:{sys.argv[2]}"
torch.set_num_threads(1)

from medicalimageanalysis_torch.device import set_default_device
set_default_device("cpu")
from medicalimageanalysis_torch.parallel.batch import LOCKSTEP, demons_batch
from medicalimageanalysis_torch.parallel.mesh import (
    initialize_distributed, make_mesh)
assert initialize_distributed(num_processes=2, process_id=pid)
import torch.distributed as dist

# four pairs over four data rows, two in each process: each process steps
# its own two rows in lockstep, and both get the four fields in batch
# order, equal to mesh=None's
mesh = make_mesh(4, devices=["cpu"] * 2)
assert [int(r) for r in mesh.ranks[:, 0]] == [0, 0, 1, 1]
rng = np.random.default_rng(3)
zz, yy, xx = np.mgrid[0:8, 0:12, 0:10].astype(np.float32)
blob = 1000 * np.exp(-(((zz - 4) / 2.5) ** 2 + ((yy - 6) / 3) ** 2
                       + ((xx - 5) / 3) ** 2))
fixed = np.stack([blob] * 4).astype(np.int16)
moving = np.stack([np.roll(blob, k % 3 - 1, axis=k % 3) for k in range(4)]
                  ).astype(np.int16)
got = demons_batch(fixed, moving, (1.2, 1.1, 2.0), iterations=3, mesh=mesh)
assert LOCKSTEP == {"rows": 2, "rounds": 3}, LOCKSTEP
want = demons_batch(fixed, moving, (1.2, 1.1, 2.0), iterations=3)
assert got.shape == want.shape == (4, 8, 12, 10, 3), got.shape
assert np.array_equal(got, want), pid
# one data row whose 'space' entries sit in both processes: the first
# process steps all four pairs, the second none, and both get the fields
row = make_mesh(2, space=2, devices=["cpu"])
got = demons_batch(fixed, moving, (1.2, 1.1, 2.0), iterations=3, mesh=row)
assert np.array_equal(got, want), pid
# (mesh=None's four pairs above counted too: one row of four pairs)
assert LOCKSTEP == ({"rows": 4, "rounds": 27} if pid == 0
                    else {"rows": 3, "rounds": 15}), (pid, LOCKSTEP)
dist.destroy_process_group()
print(f"worker {pid} OK")
"""


def _run_workers(script):
    """Start two workers of ``script`` (argv: process id, port) and
    return their (return code, output)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("MIA_COORDINATOR", None)
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as f:
        f.write(script)
        worker = f.name
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), str(port)], env=env, cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        os.unlink(worker)
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def test_two_process_cohort_and_sharded_demons():
    for i, (rc, out) in enumerate(_run_workers(_WORKER)):
        assert rc == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert f"worker {i} OK total=1000.0" in out, out[-1500:]


def test_two_process_demons_batch_lockstep():
    for i, (rc, out) in enumerate(_run_workers(_BATCH_WORKER)):
        assert rc == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert f"worker {i} OK" in out, out[-1500:]
