"""RTPLAN (RT Plan / RT Ion Plan) reader.

Port of medicalimageanalysis_tpu/read/rtplan.py (``ReadRTPlan``,
:32-160): the plan's summary (fractionation, target prescription, dose
references, per-beam geometry from the first control point) into a
``Plan`` in ``Data.plan``. Photon (BeamSequence) and ion
(IonBeamSequence) plans both parse; missing groups degrade to None / []
rather than raising. A plan is metadata only: nothing goes to the card.
"""

from __future__ import annotations

from ..dicom.dataset import value_or

__all__ = ["ReadRTPlan"]


def _f(ds, key):
    v = value_or(ds, key, None)
    try:
        return None if v is None else float(v)
    except (TypeError, ValueError):
        return None


def _i(ds, key):
    v = _f(ds, key)
    return None if v is None else int(v)


class ReadRTPlan:
    def __init__(self, image_set, only_tags=False):
        ds = image_set[0] if isinstance(image_set, (list, tuple)) \
            else image_set
        self.image_set = [ds]
        self.only_tags = only_tags
        self.modality = str(value_or(ds, "Modality", "RTPLAN"))
        self.filepaths = [getattr(ds, "filename", "")]
        self.sops = [str(value_or(ds, "SOPInstanceUID", ""))]

        self.label = value_or(ds, "RTPlanLabel", None)
        self.name = value_or(ds, "RTPlanName", None)
        self.description = value_or(ds, "RTPlanDescription", None)
        self.approval_status = value_or(ds, "ApprovalStatus", None)

        self.dose_references = self._dose_references(ds)
        self.fraction_groups = self._fraction_groups(ds)
        self.beams = self._beams(ds)

        self.n_fractions = next(
            (fg["n_fractions"] for fg in self.fraction_groups
             if fg["n_fractions"] is not None), None)
        self.target_prescription_dose = next(
            (dr["target_prescription_dose"] for dr in self.dose_references
             if dr["target_prescription_dose"] is not None), None)

        self.referenced_structure_set_sop = None
        if "ReferencedStructureSetSequence" in ds:
            for item in ds.ReferencedStructureSetSequence:
                sop = value_or(item, "ReferencedSOPInstanceUID", None)
                if sop is not None:
                    self.referenced_structure_set_sop = str(sop)
                    break
        self.referenced_dose_sops = []
        if "ReferencedDoseSequence" in ds:
            for item in ds.ReferencedDoseSequence:
                sop = value_or(item, "ReferencedSOPInstanceUID", None)
                if sop is not None:
                    self.referenced_dose_sops.append(str(sop))

        from ..read.dicom import create_plan_name
        self.plan_name = create_plan_name(self.modality)

        from ..structure.plan import Plan
        Plan(self)

    @staticmethod
    def _dose_references(ds):
        out = []
        if "DoseReferenceSequence" not in ds:
            return out
        for item in ds.DoseReferenceSequence:
            out.append({
                "number": _i(item, "DoseReferenceNumber"),
                "structure_type": value_or(
                    item, "DoseReferenceStructureType", None),
                "type": value_or(item, "DoseReferenceType", None),
                "description": value_or(
                    item, "DoseReferenceDescription", None),
                "target_prescription_dose": _f(
                    item, "TargetPrescriptionDose"),
                "delivery_maximum_dose": _f(
                    item, "DeliveryMaximumDose"),
            })
        return out

    @staticmethod
    def _fraction_groups(ds):
        out = []
        if "FractionGroupSequence" not in ds:
            return out
        for item in ds.FractionGroupSequence:
            beam_doses = []
            if "ReferencedBeamSequence" in item:
                for rb in item.ReferencedBeamSequence:
                    beam_doses.append({
                        "beam_number": _i(rb, "ReferencedBeamNumber"),
                        "dose_gy": _f(rb, "BeamDose"),
                        "meterset": _f(rb, "BeamMeterset"),
                    })
            out.append({
                "number": _i(item, "FractionGroupNumber"),
                "n_fractions": _i(item, "NumberOfFractionsPlanned"),
                "n_beams": _i(item, "NumberOfBeams"),
                "beam_doses": beam_doses,
            })
        return out

    @staticmethod
    def _beams(ds):
        out = []
        seq = (ds.BeamSequence if "BeamSequence" in ds
               else ds.IonBeamSequence if "IonBeamSequence" in ds
               else [])
        for item in seq:
            beam = {
                "number": _i(item, "BeamNumber"),
                "name": value_or(item, "BeamName", None),
                "type": value_or(item, "BeamType", None),
                "radiation": value_or(item, "RadiationType", None),
                "machine": value_or(item, "TreatmentMachineName", None),
                "delivery_type": value_or(
                    item, "TreatmentDeliveryType", None),
                "n_control_points": _i(item, "NumberOfControlPoints"),
                "final_meterset_weight": _f(
                    item, "FinalCumulativeMetersetWeight"),
            }
            # geometry keys are ALWAYS present (None when no control
            # point) so consumers can index uniformly across beams
            beam.update({"energy": None, "gantry_angle": None,
                         "collimator_angle": None, "couch_angle": None,
                         "isocenter": None})
            cp_seq = (item.ControlPointSequence
                      if "ControlPointSequence" in item
                      else item.IonControlPointSequence
                      if "IonControlPointSequence" in item else [])
            if len(cp_seq):
                cp = cp_seq[0]
                beam.update({
                    "energy": _f(cp, "NominalBeamEnergy"),
                    "gantry_angle": _f(cp, "GantryAngle"),
                    "collimator_angle": _f(cp, "BeamLimitingDeviceAngle"),
                    "couch_angle": _f(cp, "PatientSupportAngle"),
                })
                iso = value_or(cp, "IsocenterPosition", None)
                beam["isocenter"] = (
                    [float(v) for v in iso] if iso is not None else None)
            out.append(beam)
        return out
