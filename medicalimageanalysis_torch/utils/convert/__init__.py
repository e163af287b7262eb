"""Contour <-> mask conversion."""
