"""Image utilities: the external-contour threshold (threshold.py)."""
