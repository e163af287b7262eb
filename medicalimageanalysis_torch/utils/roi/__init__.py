"""ROI utilities: margins and boolean combination (margin.py), mask ->
contour extraction (contour.py), slice interpolation (interpolate.py)."""
