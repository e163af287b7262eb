"""medicalimageanalysis_torch — the PyTorch / CUDA port for one NVIDIA H100.

Carried over from medicalimageanalysis_tpu/__init__.py. The package mirrors
the JAX package's layout and names; the slices ported so far cover

    import medicalimageanalysis_torch as mia
    mia.read_dicoms(folder_path=...)              # host parse + device assembly
    rigid = mia.Rigid("CT 01", "CT 02")
    rigid.compute_intensity()                     # CUDA warp kernel, coords mode
    rigid.create_image()                          # CUDA warp kernel, affine mode
    deform = mia.Deformable(reference_name="CT 01", moving_name="CT 02")
    deform.compute_demons(method="fast")          # CUDA warp kernel, disp mode
    deform.compute_bspline()                      # disp mode with gradients
    deform.create_image()                         # coords + disp modes
    deform.compute_jacobian()
    mia.read_dicoms(folder_path=...)              # CT + RTSTRUCT + RTDOSE
    mia.Data.image["CT 01"].compute_roi_masks()   # pooled device rasterizer
    dose = mia.Data.dose["RTDOSE 01"]
    dose.compute_roi_dose_statistics("CT 01", "PTV")  # affine mode + sort
    dose.compute_dvh_curve("CT 01", "PTV")        # CUDA histogram kernel
    deform.update_dose("RTDOSE 01")               # affine, coords, disp
    mia.read_dicoms(folder_path=...)              # + SEG, REG, RTPLAN
    mia.Data.image["CT 01"].create_seg(path=...)  # and the other writers
    mia.read_nifti(path); mia.read_mhd(path)      # NIfTI, MetaImage
    mia.read_stl(path); mia.read_3mf(path)        # and VTK, PLY, OBJ meshes
    roi.compute_mask()                            # a mesh-only ROI: voxelized

Every entry point runs on the card unless the caller passes
``device="cpu"`` or calls ``device.set_default_device("cpu")``; without
a card and without that request it raises.

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package: ``dicom`` and ``native`` are its own copies of that package's
host DICOM core.
"""

__version__ = "0.1.0"

from .data import Data

__all__ = ["Data", "Deformable", "Dose", "Image", "Rigid", "read_dicoms",
           "__version__"]


def __getattr__(name):
    # lazy exports keep `import medicalimageanalysis_torch` free of torch
    # until a compute path is touched
    import importlib

    if name in ("read_dicoms", "read_3mf", "read_mhd", "read_stl",
                "read_vtk", "read_ply", "read_obj", "file_parser",
                "read_nifti", "check_memory"):
        from . import reader
        return getattr(reader, name)
    if name == "MhdReader":
        from .read.mhd import MhdReader
        return MhdReader
    if name in ("DicomReader", "ThreeMfReader", "StlReader", "VtkReader",
                "PlyReader", "ObjReader"):
        return getattr(importlib.import_module(".read", __name__), name)
    if name == "Image":
        from .structure.image import Image
        return Image
    if name == "Dose":
        from .structure.dose import Dose
        return Dose
    if name == "Rigid":
        from .structure.rigid import Rigid
        return Rigid
    if name == "Deformable":
        from .structure.deformable import Deformable
        return Deformable
    if name in ("utils", "ops", "parallel", "structure", "read", "dicom",
                "models", "native", "config", "reader", "telemetry"):
        # not `from . import utils`: that re-enters this __getattr__
        return importlib.import_module(f".{name}", __name__)
    if not name.startswith("_"):
        # the JAX package re-exports its utils at top level
        utils = importlib.import_module(".utils", __name__)
        if name in utils.__all__:
            return getattr(utils, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
