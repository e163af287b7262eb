"""The last JAX names in the port, each against its JAX function:
``DicomReader.add_datasets`` followed by the grouping, the numpy twin
``assemble_volume_numpy``, the warp entry names of the JAX module
(``field_warp_xla``, ``warp_jit``, ``warp_disp_jit``, ``field_warp_disp``,
``affine_warp``) and ``voxelize_compute_marginal_ms``; and the walk over
both packages' sources that finds no public JAX function, class or
method missing from the port but ROADMAP.md item 12's."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import volume as tvol
from medicalimageanalysis_torch.ops import voxelize as tvox
from medicalimageanalysis_torch.ops import warp as twarp
from medicalimageanalysis_torch.read import dicom as tdicom
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.ops import pallas_warp as jwarp
from medicalimageanalysis_tpu.ops import volume as jvol
from medicalimageanalysis_tpu.read import dicom as jdicom
from medicalimageanalysis_tpu.utils.creation import CreateDicomImage
from test_torch_ingest import assert_same_registry
from test_torch_warp import affine_map, boundary_distance, smooth_coords

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (16, 18, 40)
BG = -3001.0
# ROADMAP.md queue 1, item 12: the JAX names the port leaves out. The
# TPU kernel's VMEM slab and window helpers (ops/pallas_warp.py) and the
# tunnel helpers of runtime.py
LEFT_OUT = ("fits_warp_caps", "fits_x_window", "predicted_spread",
            "required_window", "window_slab_bytes", "setup_jax_cache",
            "transfer_rate_bytes_per_s")


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def public_names(package, jax_side):
    """Every public top-level function and class of the package's
    modules and every public method of its classes; on the port's side
    also the names assigned at module level or in a class body (a method
    made by a factory, an alias)."""
    names = {}
    for path in sorted((ROOT / package).rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            found = []
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                found.append(node.name)
            elif isinstance(node, ast.Assign) and not jax_side:
                found += [x.id for x in node.targets
                          if isinstance(x, ast.Name)]
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef):
                        found.append(sub.name)
                    elif isinstance(sub, ast.Assign) and not jax_side:
                        found += [x.id for x in sub.targets
                                  if isinstance(x, ast.Name)]
            for name in found:
                if not name.startswith("_"):
                    names.setdefault(name, path.relative_to(ROOT).as_posix())
    return names


def test_no_public_jax_name_is_missing_but_item_12s():
    jax_names = public_names("medicalimageanalysis_tpu", True)
    port = public_names("medicalimageanalysis_torch", False)
    missing = sorted(n for n in jax_names if n not in port)
    assert missing == sorted(LEFT_OUT), \
        {n: jax_names[n] for n in missing}


@pytest.mark.parametrize("shuffled", [False, True])
def test_add_datasets_then_grouping_matches_jax(tmp_path, shuffled):
    rng = np.random.default_rng(8)
    ct = rng.integers(-1000, 1500, size=(5, 8, 9)).astype(np.int16)
    pt = rng.integers(0, 3000, size=(4, 8, 9)).astype(np.int16)
    CreateDicomImage(str(tmp_path / "ct"), ct, origin=[3, -4, 5],
                     spacing=[0.9, 1.1], thickness=2.5).run()
    CreateDicomImage(str(tmp_path / "pt"), pt, origin=[0, 0, 40],
                     spacing=[0.9, 1.1], thickness=2.5).run(
        modality="PT", rescale_slope=0.37, rescale_intercept=1.5)
    paths = sorted(str(p) for p in tmp_path.rglob("*.dcm"))
    if shuffled:
        paths = list(np.random.default_rng(9).permutation(paths))
    for mod, Reader in ((jdicom, jdicom.DicomReader),
                        (tdicom, tdicom.DicomReader)):
        kw = {} if mod is jdicom else {"device": "cpu"}
        reader = Reader(None, False, None, None, True, **kw)
        reader.add_datasets([mod.thread_process_dicom(p) for p in paths])
        assert len(reader.ds) == len(paths)
        reader.separate_modalities_and_images()
        reader.image_creation()
        mod.sort_images_by_datetime()
    assert sorted(TData.image_list) == ["CT 01", "PT 02"]
    assert_same_registry()


@pytest.mark.parametrize("op", ["none", "ax_rot2", "sag_fix"])
@pytest.mark.parametrize("dtype,out_dtype,slope,intercept", [
    (np.int16, np.int16, 1.0, -1024.0),
    (np.uint16, np.int16, 1.0, -1024.0),
    (np.int16, np.int16, 1.0, 0.0),
    (np.uint16, np.float32, 0.25, 3.5),
    (np.int16, np.float32, 0.37, 1.5),
])
def test_assemble_volume_numpy_is_bit_equal_to_jax(dtype, out_dtype, slope,
                                                   intercept, op):
    """The rescale cases of test_torch_ingest.py (the integer fast path
    among them), and each FFS op: the same bits and dtype as the JAX
    package's numpy twin, and the port's device assembly on the CPU."""
    rng = np.random.default_rng(7)
    hi = 30000 if dtype == np.uint16 else 3000
    raw = rng.integers(0, hi, size=(4, 6, 5)).astype(dtype)
    slopes = np.full(4, slope, np.float32)
    intercepts = np.full(4, intercept, np.float32)
    out = tvol.assemble_volume_numpy(raw, slopes, intercepts, op,
                                     out_dtype=out_dtype)
    ref = jvol.assemble_volume_numpy(raw, slopes, intercepts, op,
                                     out_dtype=out_dtype)
    assert out.dtype == ref.dtype and out.flags.c_contiguous
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, tvol.assemble_volume(
        raw, slopes, intercepts, op, out_dtype=out_dtype).numpy())


@pytest.mark.parametrize("B", [1, 3])
def test_field_warp_xla_and_warp_jit_match_jax(B):
    rng = np.random.default_rng(50 + B)
    vol = rng.normal(size=(B,) + SHAPE).astype(np.float32) * 300
    vol = vol[0] if B == 1 else vol
    cz, cy, cx = smooth_coords(rng)
    atol = 1e-6 * np.abs(vol).max()     # f32 rounding of the 8-tap lerp
    ref = np.asarray(jwarp.field_warp_xla(jnp.asarray(vol), cz, cy, cx, BG))
    plain = twarp.field_warp_xla(t(vol), t(cz), t(cy), t(cx), BG)
    assert plain.shape == ref.shape
    np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=atol)
    ref_jit = np.asarray(jwarp.warp_jit(jnp.asarray(vol), jnp.asarray(cz),
                                        jnp.asarray(cy), jnp.asarray(cx),
                                        BG))
    out = twarp.warp_jit(t(vol), t(cz), t(cy), t(cx), BG)
    np.testing.assert_allclose(out.numpy(), ref_jit, rtol=0, atol=atol)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("B", [1, 2])
def test_warp_disp_jit_and_field_warp_disp_match_jax(B):
    rng = np.random.default_rng(60 + B)
    vol = rng.normal(size=(B,) + SHAPE).astype(np.float32) * 300
    vol = vol[0] if B == 1 else vol
    disp = rng.normal(scale=1.5, size=(3,) + SHAPE).astype(np.float32)
    atol = 1e-6 * np.abs(vol).max()
    ref, ref_ovf = jwarp.warp_disp_jit(jnp.asarray(vol), jnp.asarray(disp),
                                       BG, with_overflow=True)
    out, ovf = twarp.warp_disp_jit(t(vol), t(disp), BG, with_overflow=True)
    assert float(ref_ovf) == 0.0 and float(ovf) == 0.0
    assert ovf.dtype == torch.float32 and ovf.dim() == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)
    assert torch.equal(twarp.warp_disp_jit(t(vol), t(disp), BG), out)
    eager = twarp.field_warp_disp(t(vol), t(disp), BG)
    np.testing.assert_allclose(
        eager.numpy(), np.asarray(jwarp.field_warp_disp(vol, disp, BG)),
        rtol=0, atol=atol)
    assert torch.equal(eager, out)


@pytest.mark.parametrize("deg,shift", [(0.0, (0.25, -0.5, 0.0)),
                                       (8.0, (1.3, -2.2, 0.4))])
def test_affine_warp_matches_jax(deg, shift):
    """As test_torch_warp.test_affine_mode_matches_jax: the JAX CPU path
    contracts the coefficient sums into FMAs, so samples differ by a few
    ulp of coordinate and the background mask only within 1e-4 voxel of
    a face."""
    rng = np.random.default_rng(70)
    vol = rng.normal(size=SHAPE).astype(np.float32) * 300
    A = affine_map(deg, shift)
    ref = np.asarray(jwarp.affine_warp(jnp.asarray(vol), A, SHAPE, BG))
    out = twarp.affine_warp(t(vol), A, SHAPE, BG).numpy()
    both = (out != BG) & (ref != BG)
    coord_err = 4 * np.spacing(np.float32(max(SHAPE)))
    max_step = max(np.abs(np.diff(vol, axis=k)).max() for k in range(3))
    atol = 3 * coord_err * max_step + 1e-6 * np.abs(vol).max()
    np.testing.assert_allclose(out[both], ref[both], rtol=0, atol=atol)
    flip = (out == BG) != (ref == BG)
    assert np.all(boundary_distance(A, SHAPE, SHAPE)[flip] < 1e-4)
    # the batch form and the JAX module's argument order give the same
    batch = twarp.affine_warp(t(np.stack([vol, -vol])), A, SHAPE, BG)
    assert torch.equal(batch[0], t(out))
    assert torch.equal(twarp.affine_warp_fused(t(vol), A, BG, SHAPE),
                       t(out))


def test_voxelize_compute_marginal_ms_runs_on_the_cpu_when_asked():
    from medicalimageanalysis_torch.ops.marching_cubes import mask_to_mesh

    zz, yy, xx = np.mgrid[0:10, 0:14, 0:12].astype(np.float64)
    blob = (((zz - 5) / 3.5) ** 2 + ((yy - 7) / 5) ** 2
            + ((xx - 6) / 4) ** 2) <= 1.0
    mesh = mask_to_mesh(blob.astype(np.uint8), [1, 1, 1], [0, 0, 0],
                        np.eye(3))
    meshes = [(np.asarray(mesh.points, np.float64), mesh.faces)] * 2
    ms = tvox.voxelize_compute_marginal_ms(meshes, (10, 14, 12), iters=2,
                                           device="cpu")
    assert np.isfinite(ms) and ms >= 0.0
    # no face in a window class: nothing to time
    assert tvox.voxelize_compute_marginal_ms(
        [(np.zeros((0, 3)), np.zeros((0, 3), np.int64))], (4, 4, 4),
        device="cpu") == 0.0
    # the split pass still voxelizes as before
    np.testing.assert_array_equal(
        tvox.voxelize_batch(meshes, (10, 14, 12), device="cpu")[1],
        blob.astype(np.uint8))
