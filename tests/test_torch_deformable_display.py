"""The ``Deformable`` Display in both packages, on the CPU: a demons field
computed by the JAX package on test_torch_deformable.py's written pair
and carried into the port (``interop.deformable_from_numpy``), then the
fractional frames (``compute_deformation`` at division 1 and 3),
``compute_grid``, the six ``retrieve_*`` queries and ``compute_aspect``.

Tolerances, stated per check (those of test_torch_deformable.py):
- each frame: equal to the port's own ``create_image(ratio)``; against
  the JAX package's frame, 1e-4 of the moving image's largest step per
  voxel where both are inside, the background masks differing on under
  0.1 % of the voxels (the inversion's and the affine coordinates'
  few-ulp differences);
- grid planes, offsets, slice locations and positions, scroll limits and
  aspects: equal.
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from medicalimageanalysis_torch import interop
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.structure.deformable import (
    Deformable as JDeformable)
from test_torch_deformable import BG, RIGID, write_pair

PLANES = ("Axial", "Coronal", "Sagittal")


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


@pytest.fixture
def pair(tmp_path):
    write_pair(tmp_path)
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    ref_name, mov_name = TData.image_list
    j_def = JDeformable(reference_name=ref_name, moving_name=mov_name,
                        roi_names=[], rigid_matrix=RIGID)
    j_def.compute_demons(method="fast", iterations=6, crop=0)
    t_def = interop.deformable_from_numpy(
        j_def.dvf, j_def.origin, j_def.spacing, ref_name, mov_name,
        rigid_matrix=j_def.rigid_matrix, device="cpu")
    return t_def, j_def


def assert_frame_close(out, ref, moving):
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == np.float32
    max_step = max(np.abs(np.diff(moving, axis=k)).max() for k in range(3))
    both = (out != BG) & (ref != BG)
    assert both.mean() > 0.75
    np.testing.assert_allclose(out[both], ref[both], rtol=0,
                               atol=1e-4 * max_step)
    assert ((out == BG) != (ref == BG)).mean() < 1e-3


@pytest.mark.parametrize("division", [1, 3])
def test_frames_match_jax(pair, division):
    t_def, j_def = pair
    moving = TData.image[t_def.moving_name].array.astype(np.float32)
    td, jd = t_def.display, j_def.display
    np.testing.assert_array_equal(td.scroll_max, jd.scroll_max)
    td.compute_deformation(division=division)
    jd.compute_deformation(division=division)
    assert len(td.array) == len(jd.array) == division
    for ii in range(division):
        ratio = (ii + 1) / division
        np.testing.assert_array_equal(
            td.array[ii], t_def.create_image(ratio=ratio)["array"])
        assert_frame_close(td.array[ii], jd.array[ii], moving)
    assert td.spacing == jd.spacing
    np.testing.assert_array_equal(td.origin, jd.origin)
    assert td.offset == jd.offset
    assert list(td.scroll_max) == list(jd.scroll_max)
    # a later call appends, as in the JAX package
    td.compute_deformation(division=1)
    assert len(td.array) == division + 1


def test_grid_queries_and_aspect_match_jax(pair):
    t_def, j_def = pair
    for d in (t_def, j_def):
        d.display.compute_deformation(division=2)
        d.display.compute_slice_location()
    np.testing.assert_array_equal(t_def.display.slice_location,
                                  j_def.display.slice_location)
    for plane in PLANES:
        for vector in ("x", "y", "z"):
            g = t_def.retrieve_grid(slice_plane=plane, vector=vector)
            assert g.dtype == np.float32
            np.testing.assert_array_equal(
                g, j_def.retrieve_grid(slice_plane=plane, vector=vector))
            np.testing.assert_array_equal(
                t_def.retrieve_array_plane(plane, solo=True, vector=vector),
                j_def.retrieve_array_plane(plane, solo=True, vector=vector))
        assert t_def.compute_aspect(plane) == j_def.compute_aspect(plane)
        assert t_def.retrieve_offset(plane) == j_def.retrieve_offset(plane)
        assert t_def.retrieve_slice_location(plane) \
            == j_def.retrieve_slice_location(plane)
        assert t_def.retrieve_scroll_max(plane) \
            == j_def.retrieve_scroll_max(plane)
        np.testing.assert_array_equal(t_def.retrieve_slice_position(plane),
                                      j_def.retrieve_slice_position(plane))
        np.testing.assert_array_equal(
            t_def.display.compute_slice_origin(plane),
            j_def.display.compute_slice_origin(plane))
    np.testing.assert_array_equal(t_def.retrieve_slice_position(),
                                  j_def.retrieve_slice_position())
    assert t_def.retrieve_array_plane("Axial", solo=True, vector="w") \
        is None


def test_retrieve_array_plane_builds_the_first_frame(pair):
    """On an empty display ``retrieve_array_plane`` computes the ratio-1
    frame and the slice location from the reference image's display,
    then slices; a position moves the location."""
    t_def, j_def = pair
    moving = TData.image[t_def.moving_name].array.astype(np.float32)
    for plane in PLANES:
        out = t_def.retrieve_array_plane(plane)
        ref = j_def.retrieve_array_plane(plane)
        assert out.dtype == np.float64 and out.shape == np.shape(ref)
    assert len(t_def.display.array) == len(j_def.display.array) == 1
    assert_frame_close(t_def.display.array[0], j_def.display.array[0],
                       moving)
    np.testing.assert_array_equal(t_def.display.slice_location,
                                  j_def.display.slice_location)
    position = np.asarray(t_def.origin) + np.array([6.0, 9.0, 7.5])
    t_def.retrieve_array_plane("Axial", position=position)
    j_def.retrieve_array_plane("Axial", position=position)
    np.testing.assert_array_equal(t_def.display.slice_location,
                                  j_def.display.slice_location)
    for plane, scroll in zip(PLANES, (3, 5, 7)):
        t_def.display.update_slice_location(scroll, plane)
        j_def.display.update_slice_location(scroll, plane)
        assert t_def.retrieve_slice_location(plane) == scroll
        np.testing.assert_array_equal(
            t_def.display.compute_array(plane),
            t_def.display.array[0][{"Axial": np.s_[scroll],
                                    "Coronal": np.s_[:, scroll],
                                    "Sagittal": np.s_[:, :, scroll]}[plane]])
        np.testing.assert_array_equal(
            t_def.display.convert_position_to_pixel([position])[0],
            j_def.display.convert_position_to_pixel([position])[0])
