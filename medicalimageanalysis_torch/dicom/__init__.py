# Copied from medicalimageanalysis_tpu/dicom/__init__.py.
"""Host-side DICOM core: parser, object model, pixel decode, writer.

This subpackage is the framework's own replacement for the
pydicom + GDCM/pylibjpeg stack the reference wraps (reference
requirements.txt; read/dicom.py:52).
"""

from .dataset import DataElement, Dataset, FileMetaDataset, Sequence
from .parser import InvalidDicomError, dcmread
from .uids import generate_uid
from .writer import dcmwrite

__all__ = [
    "DataElement", "Dataset", "FileMetaDataset", "Sequence",
    "InvalidDicomError", "dcmread", "dcmwrite", "generate_uid",
]
