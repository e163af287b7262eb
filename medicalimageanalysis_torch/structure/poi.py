"""Poi: named landmark point.

Carried over from medicalimageanalysis_tpu/structure/poi.py.
"""

from __future__ import annotations

import numpy as np

from ..ops import geometry as geo

__all__ = ["Poi"]


class Poi(object):
    def __init__(self, image, position=None, name=None, color=None,
                 visible=None, filepaths=None):
        self.image = image

        self.name = name
        self.visible = visible
        self.color = color
        self.filepaths = filepaths

        self.point_position = position
        # the reference never fills point_pixel (structure/poi.py:28)
        self.point_pixel = None
        if position is not None and image is not None \
                and getattr(image, "display", None) is not None:
            try:
                m = image.display.compute_matrix_position_to_pixel()
                self.point_pixel = geo.apply_homogeneous(
                    np.asarray(position, dtype=float).reshape(-1, 3), m)
            except Exception:
                self.point_pixel = None
