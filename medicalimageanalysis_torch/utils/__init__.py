"""Utilities: the synthetic DICOM series writer and in-memory image
builder, contour and mesh conversion, the external threshold, the Euler
transform, metrics, dose accumulation and goals, radiobiology, ROI
margins, the 4D phase tools, the deformable backend and the ICP class.

The exports match the JAX package's utils/__init__.py, lazily.
"""

_LAZY = {
    "ContourToDiscreteMesh": ("convert.contour", "ContourToDiscreteMesh"),
    "ContourToMask": ("convert.contour", "ContourToMask"),
    "MaskToContour": ("convert.contour", "MaskToContour"),
    "ModelToMask": ("convert.contour", "ModelToMask"),
    "Volume": ("mesh.volume", "Volume"),
    **{n: ("mesh.surface", n) for n in ("clean_mesh", "expansion",
                                        "surface_boundary",
                                        "only_main_component")},
    "DeformableITK": ("deformable.torch_backend", "DeformableITK"),
    "DeformableJAX": ("deformable.torch_backend", "DeformableJAX"),
    "TriMesh": ("mesh.trimesh", "TriMesh"),
    "ICP": ("rigid.icp", "ICP"),
    "Refinement": ("mesh.surface", "Refinement"),
    "external": ("image.threshold", "external"),
    "contours_from_mask": ("roi.contour", "contours_from_mask"),
    "CreateDicomImage": ("creation", "CreateDicomImage"),
    "CreateImageFromMask": ("creation", "CreateImageFromMask"),
    "euler_transform": ("image.transform", "euler_transform"),
    **{n: ("fourd", n) for n in ("find_phase_groups", "combine_phases",
                                 "compute_itv")},
    **{n: ("dose", n) for n in ("accumulate_dose", "register_dose_grid",
                                "evaluate_constraints")},
    **{n: ("radiobiology", n) for n in ("bed", "eqd2", "geud", "ntcp_lkb",
                                        "ntcp_logistic", "tcp_logistic")},
    **{n: ("metrics", n) for n in ("dice_coefficient", "jaccard_index",
                                   "hausdorff_distance",
                                   "mean_surface_distance", "surface_dice",
                                   "compare_rois")},
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(f"{__name__}.{module}"), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
