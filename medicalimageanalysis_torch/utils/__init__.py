"""Utilities: the synthetic DICOM series writer and in-memory image
builder, contour and mesh conversion, the external threshold, the Euler
transform, metrics, dose accumulation and goals, radiobiology, ROI
margins, the 4D phase tools, the deformable backend and the ICP class.

The exports match the JAX package's utils/__init__.py, lazily. The names
it exports that the port has not ported yet stand in as callables that
raise NotImplementedError naming their ROADMAP.md queue 1 item.
"""

_LAZY = {
    "ContourToDiscreteMesh": ("convert.contour", "ContourToDiscreteMesh"),
    "ContourToMask": ("convert.contour", "ContourToMask"),
    "MaskToContour": ("convert.contour", "MaskToContour"),
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

_WAITING = {
    **dict.fromkeys(("ModelToMask", "Volume", "clean_mesh", "expansion",
                     "surface_boundary", "only_main_component"),
                    "item 9, mesh"),
}

__all__ = list(_LAZY) + list(_WAITING)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(f"{__name__}.{module}"), attr)
    if name in _WAITING:
        from .._waiting import waiting
        return waiting(name, _WAITING[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
