"""Global registry with the reference's public surface.

Carried over from medicalimageanalysis_tpu/data.py. The port keeps its own
registry, so one process can load the same folder into both packages and
compare them. ROI/POI union-sync waits for the structure slice.
"""

from __future__ import annotations

__all__ = ["Data"]


class Data(object):
    """Centralized class-level registry (Singleton pattern).

    Attributes
    ----------
    image : dict            image name -> Image
    rigid : dict            rigid name -> Rigid
    deformable : dict       deformable name -> Deformable
    image_list, rigid_list, deformable_list, roi_list, poi_list : list
    """

    image = {}
    rigid = {}
    deformable = {}

    image_list = []
    rigid_list = []
    deformable_list = []
    roi_list = []
    poi_list = []

    @classmethod
    def clear(cls):
        """Wipe all data from the registry."""
        cls.image = {}
        cls.rigid = {}
        cls.deformable = {}

        cls.image_list = []
        cls.rigid_list = []
        cls.deformable_list = []
        cls.roi_list = []
        cls.poi_list = []

    @classmethod
    def delete_image(cls, image_name):
        """Remove an image and its registry entry."""
        del cls.image[image_name]
        cls.image_list.remove(image_name)
