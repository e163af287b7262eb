"""The port's public API against the JAX package's: every public name of
the JAX package's classes, top level and parallel modules (``batch``,
``mesh``, ``halo``, ``cohort``) exists in the port, and none stands in for
an unported one; ``Rigid.compute_aspect``; and the ``only_tags``
read finished by ``Image.load_array``, bit-equal to a normal read and to
the JAX package's ``load_array``."""

import importlib
import inspect
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.structure.rigid import Rigid as TRigid
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.structure.rigid import Rigid as JRigid


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


CLASSES = [("structure.image", "Image"), ("structure.rigid", "Rigid"),
           ("structure.deformable", "Deformable"), ("structure.dose", "Dose"),
           ("structure.roi", "Roi"), ("structure.poi", "Poi"),
           ("structure.plan", "Plan"), ("data", "Data")]
# the names the JAX package's top level serves (its __getattr__), besides
# its utils re-exports
TOP_LEVEL = ("read_dicoms", "read_3mf", "read_mhd", "read_stl", "read_vtk",
             "read_ply", "read_obj", "file_parser", "check_memory",
             "read_nifti", "DicomReader", "MhdReader", "ThreeMfReader",
             "StlReader", "VtkReader", "PlyReader", "ObjReader", "Image",
             "Dose", "Rigid", "Deformable", "utils", "Data")
ITEM = r"ROADMAP\.md queue 1, item \d+"


def public(obj):
    return sorted(n for n in dir(obj) if not n.startswith("_"))


def stub_item(raw):
    """The ROADMAP item of a stand-in (a function, or a classmethod of
    one), else None."""
    fn = raw.__func__ if isinstance(raw, (classmethod, staticmethod)) \
        else raw
    return getattr(fn, "roadmap_item", None)


@pytest.mark.parametrize("module,name",
                         CLASSES + [("", "top_level")],
                         ids=[c for _, c in CLASSES] + ["top_level"])
def test_every_public_name_exists_and_stubs_name_their_item(module, name):
    if name == "top_level":
        jax_names = list(TOP_LEVEL) + list(
            importlib.import_module("medicalimageanalysis_tpu.utils")
            .__all__)
        assert all(hasattr(jmia, n) for n in TOP_LEVEL)
        port, stubs = tmia, {n: getattr(tmia, n) for n in jax_names}
    else:
        jcls = getattr(importlib.import_module(
            f"medicalimageanalysis_tpu.{module}"), name)
        port = getattr(importlib.import_module(
            f"medicalimageanalysis_torch.{module}"), name)
        jax_names = public(jcls)
        stubs = {n: inspect.getattr_static(port, n) for n in public(port)}
    missing = [n for n in jax_names if not hasattr(port, n)]
    assert not missing, f"{name}: missing {missing}"
    for n, raw in stubs.items():
        item = stub_item(raw)
        if item is None:
            continue
        fn = raw.__func__ if isinstance(raw, classmethod) else raw
        with pytest.raises(NotImplementedError, match=ITEM):
            fn(None)


# the names of the image-analysis and IO slices: real callables now, no
# stand-ins
PORTED = {
    ("parallel.batch", None): ("demons_batch", "radiomics_batch",
                               "n4_batch"),
    # the IO slice's names
    ("structure.image", "Image"): (
        "resample_to", "compute_suv", "compute_projection",
        "create_rotated_volume", "create_rotated_sitk_image",
        "correct_bias", "compute_radiomics", "compute_mtv_tlg",
        "input_seg", "input_mhd", "create_rtstruct", "create_seg",
        "create_nifti", "export_dicom", "save_image", "save_rois",
        "save_pois", "load_rois", "load_pois", "load_image"),
    ("structure.dose", "Dose"): ("create_rtdose", "save_image",
                                 "load_image"),
    ("structure.plan", "Plan"): ("linked_dose_names", "total_beam_meterset",
                                 "summary", "create_rtplan", "save_plan",
                                 "load_plan"),
    ("structure.plan", None): ("load_plan",),
    ("structure.common", None): ("rebuild_dataset_from_meta",
                                 "collision_suffix", "build_reg_dataset",
                                 "series_item"),
    ("read.reg", None): ("ReadREG",),
    ("read.rtplan", None): ("ReadRTPlan",),
    ("read.seg", None): ("ReadSEG", "cielab_uint16_to_rgb",
                         "rgb_to_cielab_uint16"),
    ("read.nifti", None): ("read_nifti_volume", "write_nifti_volume",
                           "NiftiReader", "read_nifti"),
    ("read.mhd", None): ("read_mhd_volume", "write_mhd_volume",
                         "MhdReader"),
    ("reader", None): ("check_memory", "read_mhd", "read_nifti",
                       "read_3mf", "read_stl", "read_vtk", "read_ply",
                       "read_obj"),
    ("utils.creation", None): ("image_from_saved",),
    # the image-analysis, IO and registration slices' Rigid, Deformable
    # and utils names, and the rest of ingest and registration
    ("structure.rigid", "Rigid"): ("create_reg", "export_image",
                                   "save_rigid", "load_rigid",
                                   "auto_register",
                                   "compute_phase_correlation",
                                   "compute_landmarks", "compute_icp_vtk",
                                   "compute_o3d"),
    ("structure.deformable", "Deformable"): (
        "compute_aspect", "retrieve_array_plane", "retrieve_grid",
        "retrieve_offset", "retrieve_scroll_max", "retrieve_slice_location",
        "retrieve_slice_position", "compute_tps", "roi_mask_union"),
    ("utils", None): ("CreateImageFromMask", "euler_transform",
                      "find_phase_groups", "combine_phases", "compute_itv",
                      "ICP", "ModelToMask", "Volume", "clean_mesh",
                      "expansion", "surface_boundary", "only_main_component"),
    ("read", None): ("Read3D", "ReadXRay", "ReadRF", "ReadUS",
                     "ReadNMPlanar", "ThreeMfReader", "StlReader",
                     "VtkReader", "PlyReader", "ObjReader"),
    ("read.multiframe", None): ("is_enhanced_multiframe",
                                "expand_multiframe", "FrameView"),
    ("read.nm", None): ("is_nm_tomo", "expand_nm_tomo", "NMTomoFrameView",
                        "ReadNMPlanar"),
    ("ops.bitpack", None): ("pack12", "unpack12_device"),
    ("ops.registration.phase_correlation", None): ("phase_correlation",),
    ("ops.registration.tps", None): ("tps_fit", "tps_displacement",
                                     "tps_displacement_grid"),
    ("ops.registration.icp", None): ("icp_rigid", "icp_rigid_batch",
                                     "icp_point_to_plane",
                                     "icp_point_to_plane_batch", "kabsch",
                                     "nearest_neighbors"),
    ("ops.registration.bspline", None): ("elastix_registration",),
    ("utils.deformable.torch_backend", "DeformableTorch"): ("elastix",),
    # the mesh slice
    ("utils.mesh.surface", "Refinement"): ("tri_split", "advanced_split",
                                           "find_face_correction",
                                           "compute_midpoints"),
    ("utils.convert.contour", None): ("ModelToMask",),
    ("utils.mesh.surface", None): ("clean_mesh", "expansion",
                                   "surface_boundary",
                                   "only_main_component"),
    ("utils.mesh.volume", None): ("Volume", "TetMesh"),
    ("read.mf3", None): ("ThreeMfReader", "write_3mf"),
    ("read.stl", None): ("StlReader", "read_stl", "write_stl"),
    ("read.vtk", None): ("VtkReader", "read_vtk_polydata",
                         "write_vtk_polydata"),
    ("read.ply", None): ("PlyReader", "read_ply", "write_ply"),
    ("read.obj", None): ("ObjReader", "read_obj", "write_obj"),
    ("ops.voxelize", None): ("voxelize_mesh_device", "voxelize_batch"),
    ("ops.rasterize", None): ("polygon_bitmaps", "fill_polygons_2d"),
}
PORTED_TOP_LEVEL = ("read_mhd", "MhdReader", "read_nifti", "check_memory",
                    "read_3mf", "read_stl", "read_vtk", "read_ply",
                    "read_obj", "ThreeMfReader", "StlReader", "VtkReader",
                    "PlyReader", "ObjReader")


@pytest.mark.parametrize("module,cls", sorted(PORTED, key=str),
                         ids=lambda v: str(v))
def test_ported_names_are_not_stand_ins(module, cls):
    owner = importlib.import_module(f"medicalimageanalysis_torch.{module}")
    if cls is not None:
        owner = getattr(owner, cls)
    for name in PORTED[(module, cls)]:
        raw = inspect.getattr_static(owner, name) if cls is not None \
            else getattr(owner, name)
        assert stub_item(raw) is None, f"{module}.{name} is a stand-in"
    if cls == "Deformable":
        d = owner(device="cpu")
        assert d.display.deformable is d


@pytest.mark.parametrize("name", PORTED_TOP_LEVEL)
def test_ported_top_level_names_are_not_stand_ins(name):
    assert stub_item(getattr(tmia, name)) is None
    assert getattr(tmia, name) is not getattr(jmia, name)


def test_no_stand_in_is_left_but_multi_device():
    """After the multi-device slice no public name of the port stands in
    for an unported one: the top level and utils serve real objects, the
    classes have no stand-ins, the parallel modules carry the JAX
    modules' ``__all__``, and a ``mesh=`` argument runs (here on a
    2-shard CPU mesh, equal to ``mesh=None``)."""
    from medicalimageanalysis_torch.parallel import batch
    from medicalimageanalysis_torch.parallel.mesh import make_mesh
    from medicalimageanalysis_tpu import utils as jutils

    names = list(TOP_LEVEL) + list(jutils.__all__)
    assert [n for n in names if stub_item(getattr(tmia, n)) is not None] \
        == []
    for module, cls in CLASSES:
        port = getattr(importlib.import_module(
            f"medicalimageanalysis_torch.{module}"), cls)
        assert [n for n in public(port) if stub_item(
            inspect.getattr_static(port, n)) is not None] == []
    for module in ("batch", "mesh", "halo", "cohort"):
        jmod = importlib.import_module(
            f"medicalimageanalysis_tpu.parallel.{module}")
        tmod = importlib.import_module(
            f"medicalimageanalysis_torch.parallel.{module}")
        assert set(jmod.__all__) <= set(tmod.__all__), module
        assert [n for n in jmod.__all__
                if stub_item(getattr(tmod, n)) is not None] == [], module
    assert not os.path.exists(os.path.join(
        os.path.dirname(tmia.__file__), "_waiting.py"))
    a = np.zeros((2, 3, 4, 4), np.uint8)
    a[:, 1, 1:3, 1:3] = 1
    got = batch.compare_masks_batch(a, a[::-1], (1.0, 1.0, 1.0),
                                    mesh=make_mesh(2, devices=["cpu"] * 2))
    want = batch.compare_masks_batch(a, a[::-1], (1.0, 1.0, 1.0))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_data_plan_registries_start_empty_and_clear():
    assert TData.plan == {} and TData.plan_list == []
    assert JData.plan == {} and JData.plan_list == []
    TData.plan["P"] = object()
    TData.plan_list.append("P")
    TData.clear()
    assert TData.plan == {} and TData.plan_list == []


@pytest.mark.parametrize("plane", ["Axial", "Coronal", "Sagittal"])
@pytest.mark.parametrize("spacing", [(0.8, 0.8, 2.0),
                                     (0.9765625, 0.5, 3.0)])
def test_rigid_compute_aspect_matches_jax(plane, spacing):
    rigid = TRigid("ref", "mov")
    rigid.display.spacing = tuple(spacing)
    ref = JRigid.compute_aspect(
        SimpleNamespace(display=SimpleNamespace(spacing=spacing)), plane)
    got = rigid.compute_aspect(plane)
    assert got == ref and type(got) is type(ref)


def write_series(folder):
    r = np.random.default_rng(5)
    ct = r.integers(-1000, 2000, size=(5, 24, 20)).astype(np.int16)
    write_ct_series(folder, ct, spacing=(0.9, 0.8), thickness=2.5)
    return folder


def test_only_tags_then_load_array_equals_a_full_read(tmp_path):
    folder = str(write_series(tmp_path / "ct"))
    tmia.read_dicoms(folder_path=folder, device="cpu")
    full = TData.image[TData.image_list[0]]
    tmia.read_dicoms(folder_path=folder, only_tags=True, device="cpu")
    lazy = TData.image[TData.image_list[0]]
    assert lazy.array is None
    arr = lazy.load_array()
    assert arr is lazy.array and lazy.load_array() is arr
    jmia.read_dicoms(folder_path=folder, only_tags=True)
    jimg = JData.image[JData.image_list[0]]
    assert jimg.array is None
    jarr = np.asarray(jimg.load_array())
    for ref in (full.array, jarr):
        assert arr.dtype == ref.dtype and arr.shape == ref.shape
        np.testing.assert_array_equal(arr, ref)
    for key in ("origin", "spacing", "dimensions", "matrix"):
        np.testing.assert_array_equal(getattr(lazy, key),
                                      getattr(full, key))
        np.testing.assert_array_equal(getattr(lazy, key),
                                      getattr(jimg, key))
    assert lazy.window == full.window
    assert lazy.display.slice_location == full.display.slice_location


def test_load_array_raises_value_error_like_jax(tmp_path):
    folder = str(write_series(tmp_path / "ct"))
    tmia.read_dicoms(folder_path=folder, only_tags=True, device="cpu")
    img = TData.image[TData.image_list[0]]
    sops = list(img.sops)
    img.sops = ["1.2.3.no.such.sop"] * len(sops)
    with pytest.raises(ValueError, match="no slices matched"):
        img.load_array()
    img.sops = sops
    os.remove(img.filepaths[0])
    with pytest.raises(ValueError, match="deferred pixel load failed"):
        img.load_array()
    img.filepaths = [None] * len(sops)
    with pytest.raises(ValueError, match="no filepaths"):
        img.load_array()
    assert img.array is None
