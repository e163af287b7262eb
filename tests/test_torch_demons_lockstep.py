"""``parallel.batch.demons_batch`` in lockstep, on the CPU: four seeded
breathing pairs (the benchmark's thoracic phantom, ``benchmark/harness/
phantoms.breathing_pair``) at 16 x 24 x 20.

Tolerances, stated per check:
- the lockstep rounds over a mesh of four and of two CPU entries, and
  with no mesh, against each pair solved alone one after another
  (``_demons_core``): equal, bit for bit (the same operations on the same
  values; only their order across pairs differs);
- against the JAX package's ``demons_batch(mesh=)``: 0.15 mm, the bound
  of test_torch_parallel.py's data-sharded case (demons trajectories fork
  on sub-ulp differences), at all but 0.1 % of the field's components,
  none past 0.3 mm and the mean within 1e-3 mm: on this phantom the
  diffeomorphic LNCC solve forks by 0.187 mm at one component of 92,160
  after four iterations (its mean gap 2.7e-4 mm), where every other case
  stays under 0.025 mm;
- against the benchmark's plain reference in float64
  (``reference/demons.Plain.fast_demons``, the pyramid (1,)): the mean gap
  within 1e-3 mm and the largest within 1.5 times the float32 reference's
  own largest gap plus 1e-4 mm. The port runs in float32, and so forks
  where float32 forks: the |D| > threshold gate flips at single voxels
  and the peak normalisation carries it everywhere, by up to 0.2 mm at a
  voxel and 7.4e-4 mm on the mean over these seeds' first five
  iterations, the float32 reference's own gaps to the last digit;
- ``demons_registration`` against its fields recorded before the level
  was made steppable: equal (SHA-256 of the field's bytes).
"""

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops.registration.demons import (
    _demons_core, demons_registration)
from medicalimageanalysis_torch.parallel import batch as tbatch
from medicalimageanalysis_torch.parallel.mesh import make_mesh
from medicalimageanalysis_tpu.parallel import batch as jbatch
from medicalimageanalysis_tpu.parallel.mesh import make_mesh as j_make_mesh

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
from harness import phantoms  # noqa: E402
from harness.reference.demons import Plain  # noqa: E402

SHAPE = (16, 24, 20)
SPACING = [17.0, 14.0, 20.0]              # [sx, sy, sz] mm
SEED = 2 ** 31 + 11
METHODS = ("demons", "fast", "diffeomorphic", "biomechanical")


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def cohort(n=4, shape=SHAPE, spacing=SPACING, seed=SEED):
    """(fixed, moving) int16 (n, Z, Y, X) stacks: n inhale / exhale
    pairs, as the benchmark's cohort job makes them."""
    gen = phantoms.generator(seed, "cpu")
    fixed, moving = [], []
    for _ in range(n):
        f, m, _ = phantoms.breathing_pair(shape, spacing, gen, (7.0, 15.0))
        fixed.append(f.numpy().astype(np.int16))
        moving.append(m.numpy().astype(np.int16))
    return np.stack(fixed), np.stack(moving)


def one_after_another(fixed, moving, method, forces, iterations):
    """Each pair's single-level solve on its own, in batch order."""
    sp = torch.tensor(SPACING, dtype=torch.float32)
    return np.stack([
        _demons_core(torch.tensor(f, dtype=torch.float32),
                     torch.tensor(m, dtype=torch.float32), sp, 1.0, 2.0,
                     0.001, iterations, method, True, forces=forces).numpy()
        for f, m in zip(fixed, moving)])


@pytest.mark.parametrize("forces", ["ssd", "lncc"])
@pytest.mark.parametrize("method", METHODS)
def test_lockstep_equals_pairs_one_after_another(method, forces):
    fixed, moving = cohort()
    kw = dict(method=method, iterations=5, forces=forces)
    want = one_after_another(fixed, moving, method, forces, 5)
    for mesh in (make_mesh(devices=["cpu"] * 4),
                 make_mesh(devices=["cpu"] * 2), None):
        got = tbatch.demons_batch(fixed, moving, SPACING, mesh=mesh, **kw)
        assert got.dtype == np.float32 and got.shape == (4,) + SHAPE + (3,)
        # an ordinary numpy array that owns its (pageable) memory
        assert got.flags.owndata and not torch.from_numpy(got).is_pinned()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("forces", ["ssd", "lncc"])
@pytest.mark.parametrize("method", METHODS)
def test_lockstep_matches_jax_mesh(method, forces):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual devices of tests/conftest.py")
    fixed, moving = cohort()
    kw = dict(method=method, iterations=4, forces=forces)
    got = tbatch.demons_batch(fixed, moving, SPACING,
                              mesh=make_mesh(devices=["cpu"] * 4), **kw)
    want = np.asarray(jbatch.demons_batch(
        fixed.astype(np.float32), moving.astype(np.float32), SPACING,
        mesh=j_make_mesh(4), **kw))
    assert np.isfinite(got).all()
    gap = np.abs(got - want)
    assert np.count_nonzero(gap > 0.15) <= 1e-3 * gap.size, gap.max()
    assert gap.max() <= 0.3 and gap.mean() <= 1e-3, (gap.max(), gap.mean())


def test_lockstep_within_the_plain_reference():
    fixed, moving = cohort()
    got = tbatch.demons_batch(fixed, moving, SPACING, method="fast",
                              iterations=5,
                              mesh=make_mesh(devices=["cpu"] * 4))
    for k in range(len(fixed)):
        fields = {}
        for dtype in (torch.float64, torch.float32):
            p = Plain(dtype, "cpu")
            with torch.no_grad():
                fields[dtype] = p.fast_demons(
                    p.t(fixed[k]), p.t(moving[k]), p.t(SPACING), (1,), 5,
                    2.0, 1.0, 0.001).numpy()
        ref = fields[torch.float64]
        gap = np.abs(got[k] - ref).max(-1)
        own = np.abs(fields[torch.float32] - ref).max(-1)
        assert gap.mean() < 1e-3, (k, gap.mean())
        assert gap.max() <= 1.5 * own.max() + 1e-4, (k, gap.max(), own.max())


def test_lockstep_counts_rows_and_rounds():
    fixed, moving = cohort()
    before = dict(tbatch.LOCKSTEP)
    tbatch.demons_batch(fixed, moving, SPACING, iterations=6,
                        mesh=make_mesh(devices=["cpu"] * 4))
    assert tbatch.LOCKSTEP["rows"] - before["rows"] == 4
    assert tbatch.LOCKSTEP["rounds"] - before["rounds"] == 6
    # SyN keeps its pairs one after another, outside the count
    tbatch.demons_batch(fixed, moving, SPACING, iterations=2, method="syn",
                        mesh=make_mesh(devices=["cpu"] * 2))
    assert tbatch.LOCKSTEP["rows"] - before["rows"] == 4
    assert tbatch.LOCKSTEP["rounds"] - before["rounds"] == 6
    # two rows of two pairs: each row's pairs one after another
    tbatch.demons_batch(fixed, moving, SPACING, iterations=3,
                        mesh=make_mesh(devices=["cpu"] * 2))
    assert tbatch.LOCKSTEP["rows"] - before["rows"] == 6
    assert tbatch.LOCKSTEP["rounds"] - before["rounds"] == 12
    # no mesh: one row, its pairs one after another
    tbatch.demons_batch(fixed, moving, SPACING, iterations=3)
    assert tbatch.LOCKSTEP["rows"] - before["rows"] == 7
    assert tbatch.LOCKSTEP["rounds"] - before["rounds"] == 24


@pytest.mark.parametrize("n_rows", [4, 2])
def test_rounds_interleave_the_rows(monkeypatch, n_rows):
    """Round i steps every row's pair before any row takes step i + 1,
    each row on its own mesh device; a row's next pair starts after the
    last round of its previous one."""
    from medicalimageanalysis_torch.ops.registration import demons

    order = []
    real = demons._Demons.step

    def step(self):
        order.append((id(self), str(self.fixed.device)))
        real(self)

    monkeypatch.setattr(demons._Demons, "step", step)
    fixed, moving = cohort()
    tbatch.demons_batch(fixed, moving, SPACING, iterations=3,
                        mesh=make_mesh(devices=["cpu"] * n_rows))
    per_row = 4 // n_rows
    assert len(order) == 3 * 4
    for j in range(per_row):
        part = order[j * 3 * n_rows:(j + 1) * 3 * n_rows]
        rows = part[:n_rows]
        assert len(set(rows)) == n_rows and part == rows * 3


@pytest.mark.parametrize("mesh_rows,most", [(None, 1), (4, 4), (2, 2)])
def test_one_solve_a_row_at_a_time(monkeypatch, mesh_rows, most):
    """Eight pairs hold at most one solve's working set a data row at
    once: pair j + 1 of a row is set up only after pair j's solve is
    gone, so a device's memory does not grow with the batch."""
    import weakref

    from medicalimageanalysis_torch.ops.registration import demons

    live, peak = [], []
    init, real = demons._Demons.__init__, demons._Demons.step

    def counted_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        live.append(weakref.ref(self))
        peak.append(sum(r() is not None for r in live))

    def step(self):
        peak.append(sum(r() is not None for r in live))
        real(self)

    monkeypatch.setattr(demons._Demons, "__init__", counted_init)
    monkeypatch.setattr(demons._Demons, "step", step)
    fixed, moving = cohort(8, (8, 12, 10))
    mesh = None if mesh_rows is None else make_mesh(
        devices=["cpu"] * mesh_rows)
    tbatch.demons_batch(fixed, moving, SPACING, iterations=2, mesh=mesh)
    assert len(live) == 8 and max(peak) == most, peak


# SHA-256 (first 16 hex digits) of demons_registration's (Z, Y, X, 3)
# float32 field, recorded with the level's loop written as one function,
# at a 12 x 16 x 14 breathing pair (seed 2**31 + 11, 24 x 20 x 26 mm
# voxels), 4 iterations a level of the pyramid (2, 1)
RECORDED = {
    ("demons", "ssd"): "ef5830e91e4160fa",
    ("demons", "lncc"): "fd5c3d58747ca70d",
    ("fast", "ssd"): "e0ac588a78ce0e73",
    ("fast", "lncc"): "fd5c3d58747ca70d",
    ("diffeomorphic", "ssd"): "4fef1944df30c268",
    ("diffeomorphic", "lncc"): "5aa926ee99243dcf",
    ("biomechanical", "ssd"): "cd7c9bcf20e4c4e7",
    ("biomechanical", "lncc"): "9cdf35b2218c42c6",
    ("syn", "ssd"): "69d63e70deec9d47",
    ("syn", "lncc"): "60f253d4e302ea25",
}


@pytest.mark.parametrize("method,forces", sorted(RECORDED))
def test_demons_registration_fields_unchanged(method, forces):
    spacing = [24.0, 20.0, 26.0]
    fixed, moving = cohort(1, (12, 16, 14), spacing)
    field = demons_registration(fixed[0], moving[0], spacing, method=method,
                                iterations=4, pyramid=(2, 1), forces=forces,
                                device="cpu")
    digest = hashlib.sha256(np.ascontiguousarray(field).tobytes())
    assert digest.hexdigest()[:16] == RECORDED[(method, forces)]

