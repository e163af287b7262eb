"""Utilities: the synthetic DICOM series writer."""
