"""Rigid registration utilities: the ICP class."""
