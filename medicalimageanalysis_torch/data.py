"""Global registry with the reference's public surface.

Carried over from medicalimageanalysis_tpu/data.py. The port keeps its own
registry, so one process can load the same folder into both packages and
compare them. ``plan`` and ``plan_list`` hold the RTPLAN summaries
(structure/plan.Plan).
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
    dose : dict             dose name -> Dose
    plan : dict             plan name -> RTPLAN summary (Plan)
    image_list, rigid_list, deformable_list, dose_list, plan_list,
    roi_list, poi_list : list
    """

    image = {}
    rigid = {}
    deformable = {}
    dose = {}
    plan = {}

    image_list = []
    rigid_list = []
    deformable_list = []
    dose_list = []
    plan_list = []
    roi_list = []
    poi_list = []

    @classmethod
    def clear(cls):
        """Wipe all data from the registry."""
        cls.image = {}
        cls.rigid = {}
        cls.deformable = {}
        cls.dose = {}
        cls.plan = {}

        cls.image_list = []
        cls.rigid_list = []
        cls.deformable_list = []
        cls.dose_list = []
        cls.plan_list = []
        cls.roi_list = []
        cls.poi_list = []

    @classmethod
    def delete_image(cls, image_name):
        """Remove an image and its registry entry."""
        del cls.image[image_name]
        cls.image_list.remove(image_name)

    @classmethod
    def match_rois(cls):
        """Union-sync ROI names/colors/visibility across all images
        (reference data.py:111-145)."""
        image_rois = [list(cls.image[name].rois.keys()) for name in cls.image]
        roi_names = list({x for r in image_rois for x in r})
        cls.roi_list = roi_names

        color = [[128, 128, 128]] * len(roi_names)
        visible = [False] * len(roi_names)
        for ii, roi_name in enumerate(roi_names):
            for image_name in cls.image:
                rois_on_image = cls.image[image_name].rois
                if roi_name in rois_on_image \
                        and rois_on_image[roi_name].color is not None:
                    color[ii] = rois_on_image[roi_name].color
                    visible[ii] = rois_on_image[roi_name].visible

        for ii, roi_name in enumerate(roi_names):
            for image_name in cls.image:
                if roi_name not in cls.image[image_name].rois:
                    cls.image[image_name].add_roi(
                        roi_name=roi_name, color=color[ii],
                        visible=visible[ii])

    @classmethod
    def match_pois(cls):
        """Union-sync POI names across all images
        (reference data.py:147-178)."""
        image_pois = [list(cls.image[name].pois.keys()) for name in cls.image]
        poi_names = list({x for r in image_pois for x in r})
        cls.poi_list = poi_names

        color = [[128, 128, 128]] * len(poi_names)
        visible = [False] * len(poi_names)
        for ii, poi_name in enumerate(poi_names):
            for image_name in cls.image:
                pois_on_image = cls.image[image_name].pois
                if poi_name in pois_on_image \
                        and pois_on_image[poi_name].color is not None:
                    color[ii] = pois_on_image[poi_name].color
                    visible[ii] = pois_on_image[poi_name].visible

        for ii, poi_name in enumerate(poi_names):
            for image_name in cls.image:
                if poi_name not in cls.image[image_name].pois:
                    cls.image[image_name].add_poi(
                        poi_name=poi_name, color=color[ii],
                        visible=visible[ii])
