"""Deformable registration: DVF primitives, demons and the B-spline FFD."""
