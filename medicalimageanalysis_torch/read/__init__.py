"""Readers: DICOM ingest (read/dicom.py) and the 3D volume builder
(read/volume3d.py)."""
