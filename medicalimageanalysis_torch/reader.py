"""Top-level IO orchestration: file parsing and the reader entry points.

Carried over from medicalimageanalysis_tpu/reader.py (``check_memory``,
``file_parser``, ``read_dicoms`` with the zip and no-extension handling,
``read_mhd``, ``read_nifti``). ``check_memory`` reads ``MemAvailable``
from /proc/meminfo, the figure psutil reports as available memory on
Linux: the port does not import psutil. ``read_3mf``, ``read_stl``,
``read_vtk``, ``read_ply`` and ``read_obj`` are the mesh readers
(read/mf3.py, stl.py, vtk.py, ply.py, obj.py), host Python.
"""

from __future__ import annotations

import os
import zipfile
from pathlib import Path

__all__ = ["check_memory", "file_parser", "read_3mf", "read_dicoms",
           "read_mhd", "read_nifti", "read_obj", "read_ply", "read_stl",
           "read_vtk"]


def available_memory_bytes(meminfo="/proc/meminfo"):
    """The kernel's estimate of the memory available to a new process
    without swapping (``MemAvailable``), in bytes."""
    with open(meminfo) as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                value, unit = line.split()[1:3]
                if unit != "kB":
                    raise ValueError(f"{meminfo}: MemAvailable in {unit!r}")
                return int(value) * 1024
    raise ValueError(f"{meminfo} has no MemAvailable line")


def check_memory(files):
    """Remaining system memory (GB) after hypothetically loading `files`
    (reference reader.py:54-108): available memory less the files'
    bytes."""
    total_size = sum(
        Path(file).stat().st_size
        for file_list in files.values()
        for file in file_list
    )
    return (available_memory_bytes() - total_size) / 1e9


def file_parser(folder_path=None, file_list=None, exclude_files=None):
    """Recursive extension bucketing (reference reader.py:111-227).

    Returns dict with keys Dicom/MHD/Raw/Nifti/Stl/Vtk/Ply/Obj/3mf/Zip/
    NoExtension. ``file_list`` overrides ``folder_path``;
    ``exclude_files`` honored.
    """
    files = {
        "Dicom": [],
        "MHD": [],
        "Raw": [],
        "Nifti": [],
        "Stl": [],
        "Vtk": [],
        "Ply": [],
        "Obj": [],
        "3mf": [],
        "Zip": [],
        "NoExtension": [],
    }

    exclude_files = exclude_files or []

    if file_list is None:
        file_list = []
        for root, _, filenames in os.walk(folder_path):
            file_list.extend(str(Path(root) / fn) for fn in filenames)

    for filepath in file_list:
        if filepath in exclude_files:
            continue
        extension = Path(filepath).suffix.lower()
        if extension == ".dcm":
            files["Dicom"].append(filepath)
        elif extension == ".mhd":
            files["MHD"].append(filepath)
        elif extension == ".raw":
            files["Raw"].append(filepath)
        elif filepath.lower().endswith(".nii.gz"):
            files["Nifti"].append(filepath)
        elif extension == ".stl":
            files["Stl"].append(filepath)
        elif extension == ".vtk":
            files["Vtk"].append(filepath)
        elif extension == ".ply":
            files["Ply"].append(filepath)
        elif extension == ".obj":
            files["Obj"].append(filepath)
        elif extension == ".3mf":
            files["3mf"].append(filepath)
        elif extension == ".zip":
            files["Zip"].append(filepath)
        elif extension == "":
            files["NoExtension"].append(filepath)

    return files


_ZIP_CACHE = {}


def _expand_zip(path):
    """Extract a .zip archive into a temp dir and return it (zip-slip
    members — absolute or '..' paths — skipped). Extractions are cached
    per (path, mtime, size) and removed at interpreter exit."""
    import atexit
    import shutil
    import tempfile

    st = os.stat(str(path))
    key = (os.path.abspath(str(path)), st.st_mtime_ns, st.st_size)
    cached = _ZIP_CACHE.get(key)
    if cached is not None and os.path.isdir(cached):
        return cached

    out = tempfile.mkdtemp(prefix="mia_zip_")
    if not _ZIP_CACHE:
        atexit.register(
            lambda: [shutil.rmtree(d, ignore_errors=True)
                     for d in _ZIP_CACHE.values()])
    with zipfile.ZipFile(str(path)) as z:
        for m in z.namelist():
            p = Path(m)
            if p.is_absolute() or ".." in p.parts:
                continue
            z.extract(m, out)
    _ZIP_CACHE[key] = out
    return out


def read_dicoms(folder_path=None, file_list=None, exclude_files=None,
                only_tags=False, only_modality=None,
                only_load_roi_names=None, clear=True,
                include_no_extension=True, device=None):
    """Load DICOM files into the port's Data registry.

    ``include_no_extension`` sniffs extension-less files for the DICM
    magic. ``folder_path`` may be a .zip archive, .zip entries in
    ``file_list`` are expanded, and .zip archives found inside a walked
    folder are expanded in place (corrupt archives are skipped).
    ``device`` is where the volumes are assembled (default: the card when
    present)."""
    from .read.dicom import DicomReader

    if only_modality is None:
        only_modality = ["CT", "MR", "PT", "NM", "US", "DX", "RF", "CR",
                         "MG", "XA", "SEG", "RTSTRUCT", "REG", "RTDOSE",
                         "RTPLAN"]

    if folder_path is not None \
            and str(folder_path).lower().endswith(".zip") \
            and os.path.isfile(str(folder_path)):
        folder_path = _expand_zip(folder_path)
    if file_list is not None:
        expanded = []
        for f in file_list:
            if str(f).lower().endswith(".zip") \
                    and os.path.isfile(str(f)):
                root = _expand_zip(f)
                for r, _, names in os.walk(root):
                    expanded.extend(str(Path(r) / n) for n in names)
            else:
                expanded.append(f)
        file_list = expanded

    files = None
    if folder_path is not None or file_list is not None:
        files = file_parser(folder_path=folder_path, file_list=file_list,
                            exclude_files=exclude_files)
        for zpath in files.get("Zip", ()):
            try:
                zroot = _expand_zip(zpath)
            except (OSError, zipfile.BadZipFile):
                continue  # corrupt archive: skip, like unparseable files
            sub = file_parser(folder_path=zroot)
            for key, vals in sub.items():
                if key != "Zip":  # no nested-zip recursion
                    files[key].extend(vals)
        if include_no_extension:
            for path in files["NoExtension"]:
                try:
                    with open(path, "rb") as f:
                        f.seek(128)
                        if f.read(4) == b"DICM":
                            files["Dicom"].append(path)
                except OSError:
                    pass

    dicom_reader = DicomReader(files, only_tags, only_modality,
                               only_load_roi_names, clear, device=device)
    dicom_reader.load()
    return dicom_reader


def read_3mf(file, roi_name=None):
    """Load a 3MF mesh file as a fake image with a mesh-only ROI
    (reference reader.py:332-372)."""
    from .read.mf3 import ThreeMfReader

    reader = ThreeMfReader(file, roi_name)
    reader.load()
    return reader


def _read_meshes(read, file_list):
    if isinstance(file_list, (str, bytes, os.PathLike)):
        file_list = [file_list]
    return [read(f) for f in file_list]


def read_stl(file_list):
    """Load STL meshes -> list of TriMesh (the reference's wrapper is
    commented out at reference reader.py:462-473)."""
    from .read.stl import read_stl as read
    return _read_meshes(read, file_list)


def read_vtk(file_list):
    """Load legacy .vtk polydata -> list of TriMesh."""
    from .read.vtk import read_vtk_polydata
    return _read_meshes(read_vtk_polydata, file_list)


def read_ply(file_list):
    """Load .ply meshes -> list of TriMesh."""
    from .read.ply import read_ply as read
    return _read_meshes(read, file_list)


def read_obj(file_list):
    """Load Wavefront .obj meshes -> list of TriMesh."""
    from .read.obj import read_obj as read
    return _read_meshes(read, file_list)


def read_nifti(file, modality=None, image_name=None, device=None):
    """Load a NIfTI volume as an Image (read/nifti.py)."""
    from .read.nifti import read_nifti as _read
    return _read(file, modality=modality, image_name=image_name,
                 device=device)


def read_mhd(file=None, modality=None, image_name=None, roi_name=None,
             roi_names=None, dose=None, dose_name=None,
             reference_name=None, moving_name=None, dvf=False, device=None):
    """Load a MetaImage (.mhd) file (reference reader.py:375-459): an
    Image; with ``reference_name``, ROI mask(s) on that image
    (``roi_name`` / ``roi_names``), a Dose grid (``dose``: True or a Gy
    scaling factor) or, with ``dvf`` and ``moving_name``, a Deformable."""
    from .read.mhd import MhdReader

    reader = MhdReader(file=file, modality=modality,
                       image_name=image_name, roi_name=roi_name,
                       roi_names=roi_names, dose=dose,
                       dose_name=dose_name,
                       reference_name=reference_name,
                       moving_name=moving_name, dvf=dvf, device=device)
    reader.load()
    return reader
