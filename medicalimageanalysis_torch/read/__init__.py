"""Readers: DICOM ingest (read/dicom.py), the 3D volume reader
(read/volume3d.py), the planar and NM readers (read/planar.py,
read/nm.py), the RT, NIfTI and MHD readers, and the mesh readers and
writers (read/stl.py, vtk.py, ply.py, obj.py, mf3.py). The class exports
match the JAX package's read/__init__.py."""


def __getattr__(name):
    import importlib
    table = {"DicomReader": "dicom", "MhdReader": "mhd",
             "ThreeMfReader": "mf3", "StlReader": "stl",
             "VtkReader": "vtk", "PlyReader": "ply", "ObjReader": "obj",
             "ReadRTStruct": "rtstruct", "ReadREG": "reg",
             "ReadRTDose": "rtdose", "Read3D": "volume3d",
             "ReadXRay": "planar", "ReadRF": "planar", "ReadUS": "planar",
             "ReadNMPlanar": "nm"}
    if name in table:
        mod = importlib.import_module(f"{__name__}.{table[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["DicomReader", "MhdReader", "ThreeMfReader", "StlReader",
           "VtkReader", "PlyReader", "ObjReader", "Read3D", "ReadXRay",
           "ReadRF", "ReadUS", "ReadNMPlanar", "ReadRTStruct", "ReadREG",
           "ReadRTDose"]
