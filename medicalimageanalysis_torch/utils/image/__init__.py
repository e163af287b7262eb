"""Image utilities: the external-contour threshold (threshold.py) and the
Euler rigid transform (transform.py)."""
