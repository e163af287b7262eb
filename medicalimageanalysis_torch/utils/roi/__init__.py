"""ROI utilities: margin expansion and boolean combination (margin.py)."""
