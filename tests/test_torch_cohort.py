"""The port's parallel/cohort.py against the JAX package's, on the CPU:
``ingest_cohort`` of a synthetic four-series folder over a mesh (the JAX
side on its 8-device virtual mesh, the port's on eight CPU shards) and
without one, and ``distributed_cohort_batch`` in one process.

Tolerances, stated per check:
- the port's ``mesh=`` result against its ``mesh=None`` result:
  bit-equal (each data row runs the same contractions on its series);
- against the JAX package: test_torch_rigid.py's preprocess bound, HU
  within 1e-5 relative (atol 1e-5 of the largest value: the two sum
  orders), masks equal except within 1e-3 HU of the threshold;
- the global batch: bit-equal to the stacked volumes.
"""

import numpy as np
import pytest
import torch

import jax

from helpers import write_ct_series
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.parallel import cohort as tcohort
from medicalimageanalysis_torch.parallel.mesh import make_mesh
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.parallel import cohort as jcohort
from medicalimageanalysis_tpu.parallel.mesh import make_mesh as j_make_mesh


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    JData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    JData.clear()
    set_default_device(None)


def write_cohort(folder, rng, n=4, shape=(8, 32, 32)):
    zz, yy, xx = np.mgrid[tuple(slice(0, s) for s in shape)]
    for s in range(n):
        body = 900 * np.exp(-(((yy - 16) / 9.0) ** 2
                              + ((xx - 15 - s) / 10.0) ** 2)) - 700
        arr = (body + rng.normal(0, 40, shape)).astype(np.int16)
        write_ct_series(folder / f"s{s}", arr, spacing=(1, 1),
                        thickness=2.0)


def test_ingest_cohort_mesh_matches_mesh_none_and_jax(tmp_path, rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    write_cohort(tmp_path, rng)
    mesh = make_mesh(8, space=2, devices=["cpu"] * 8)
    got = tcohort.ingest_cohort(folder_path=str(tmp_path),
                                out_shape=(8, 16, 16), mesh=mesh)
    plain = tcohort.ingest_cohort(folder_path=str(tmp_path),
                                  out_shape=(8, 16, 16))
    want = jcohort.ingest_cohort(folder_path=str(tmp_path),
                                 out_shape=(8, 16, 16),
                                 mesh=j_make_mesh(8, space=2))
    assert len(got) == 4 and set(got) == set(plain)
    assert sorted(TData.image[n].series_uid for n in got) == sorted(
        JData.image[n].series_uid for n in want)
    by_uid = {JData.image[n].series_uid: want[n] for n in want}
    from medicalimageanalysis_tpu.ops.filters import _gauss_kernel_matrix
    for name, r in got.items():
        assert r["volume"].shape == (8, 16, 16)
        assert r["volume"].dtype == torch.float32
        assert r["mask"].dtype == torch.uint8
        assert torch.equal(r["volume"], plain[name]["volume"])
        assert torch.equal(r["mask"], plain[name]["mask"])
        assert TData.image[name].array is not None
        j = by_uid[TData.image[name].series_uid]
        vol_j, mask_j = np.asarray(j["volume"]), np.asarray(j["mask"])
        np.testing.assert_allclose(r["volume"].numpy(), vol_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(vol_j).max())
        blurred = vol_j.astype(np.float64)
        for axis, n in enumerate((8, 16, 16)):
            g = _gauss_kernel_matrix(n, 1.0).astype(np.float64)
            blurred = np.moveaxis(np.tensordot(g, blurred, axes=(1, axis)),
                                  0, axis)
        differ = r["mask"].numpy() != mask_j
        assert not (differ & (np.abs(blurred + 250.0) > 1e-3)).any()
        assert mask_j.any() and not mask_j.all()


def test_ingest_cohort_batch_must_divide_and_drops_host_arrays(tmp_path,
                                                               rng):
    write_cohort(tmp_path, rng, n=3)
    with pytest.raises(ValueError, match="not divisible by the 'data'"):
        tcohort.ingest_cohort(folder_path=str(tmp_path),
                              mesh=make_mesh(2, devices=["cpu"] * 2))
    out = tcohort.ingest_cohort(folder_path=str(tmp_path),
                                mesh=make_mesh(3, devices=["cpu"] * 3),
                                keep_host_arrays=False)
    assert len(out) == 3
    assert all(TData.image[n].array is None for n in out)
    assert all(r["volume"].shape == (8, 32, 32) for r in out.values())


def test_distributed_cohort_batch_one_process(rng):
    vols = [rng.normal(size=(8, 6, 5)).astype(np.float32) for _ in range(4)]
    mesh = make_mesh(8, space=2, devices=["cpu"] * 8)
    g = tcohort.distributed_cohort_batch(vols, mesh)
    assert g.shape == (4, 8, 6, 5)
    assert sorted(g.blocks) == [(r, c) for r in range(4) for c in range(2)]
    assert all(b.shape == (1, 4, 6, 5) for b in g.blocks.values())
    np.testing.assert_array_equal(np.asarray(g), np.stack(vols))
    total = mesh.psum({p: b.to(torch.float64).sum()
                       for p, b in g.blocks.items()})
    assert float(total) == pytest.approx(float(np.stack(vols).astype(
        np.float64).sum()), rel=1e-12)
