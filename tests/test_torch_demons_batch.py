"""``parallel.batch.demons_batch`` in both packages, on the CPU: two
pairs (test_torch_demons.py's blobs, and the same blobs displaced
further), each pair held against the JAX package's ``demons_batch`` and
against the port's single-pair ``demons_registration``.

Tolerances, stated per check (those of test_torch_demons.py):
- against the port's single-pair solve: equal (the same level on the
  same inputs);
- against the JAX package's ``demons_batch``: the warp residual within
  2 % of JAX's, and the fields within 0.15 mm of each other after 8
  iterations (demons trajectories fork on sub-ulp differences).
"""

import numpy as np
import pytest
import torch

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops.registration.demons import (
    demons_registration)
from medicalimageanalysis_torch.parallel.batch import demons_batch
from medicalimageanalysis_torch.parallel.mesh import make_mesh
from medicalimageanalysis_tpu.ops.registration.dvf import (
    warp_volume as j_warp)
from medicalimageanalysis_tpu.parallel.batch import (
    demons_batch as j_demons_batch)
from test_torch_demons import SHAPE, SPACING, pair


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def batch():
    fixed, moving = pair()
    shifted = np.roll(moving, 1, axis=2)
    return np.stack([fixed, fixed]), np.stack([moving, shifted])


@pytest.mark.parametrize("method,forces", [
    ("fast", "ssd"), ("demons", "ssd"), ("diffeomorphic", "lncc"),
    ("syn", "ssd")])
def test_demons_batch_matches_single_pairs_and_jax(method, forces):
    fixed, moving = batch()
    kw = dict(method=method, iterations=8, forces=forces)
    out = demons_batch(fixed, moving, SPACING, **kw)
    ref = np.asarray(j_demons_batch(fixed, moving, SPACING, **kw))
    assert out.shape == (2,) + SHAPE + (3,) and out.dtype == np.float32
    assert np.isfinite(out).all()
    for b in range(2):
        single = demons_registration(fixed[b], moving[b], SPACING,
                                     device="cpu", **kw)
        np.testing.assert_array_equal(out[b], single)

        def residual(field):
            return np.abs(np.asarray(j_warp(moving[b], field, SPACING))
                          - fixed[b]).mean()

        r_port, r_jax = residual(out[b]), residual(ref[b])
        assert r_jax < 0.6 * np.abs(moving[b] - fixed[b]).mean()
        assert abs(r_port - r_jax) <= 0.02 * r_jax
        assert np.abs(out[b] - ref[b]).max() < 0.15


def test_demons_batch_arguments():
    fixed, moving = batch()
    with pytest.raises(ValueError, match="forces"):
        demons_batch(fixed, moving, forces="ncc")
    with pytest.raises(ValueError, match="method"):
        demons_batch(fixed, moving, method="elastic")
    # over a 2-shard CPU mesh: one pair a data row, each the mesh=None
    # result (the same single-pair solve)
    np.testing.assert_array_equal(
        demons_batch(fixed, moving, SPACING, iterations=4,
                     mesh=make_mesh(2, devices=["cpu"] * 2)),
        demons_batch(fixed, moving, SPACING, iterations=4))
