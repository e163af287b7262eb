"""Deformable-registration backend facade."""
