"""Utilities: the synthetic DICOM series writer, contour conversion,
metrics and the deformable backend."""
