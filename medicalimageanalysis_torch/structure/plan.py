"""RT Plan domain object.

Port of medicalimageanalysis_tpu/structure/plan.py (``Plan``, :23-317, and
the module-level ``load_plan``): the harvested plan summary registered in
``Data.plan``; ``linked_dose_names`` ties it to ingested RTDOSE grids by
Referenced SOP instance (either direction); ``create_rtplan`` writes the
summary back as an RT (Ion) Plan dataset; ``save_plan`` / ``load_plan``
keep it as json.
"""

from __future__ import annotations

from ..data import Data
from ..dicom import generate_uid
from .common import MetadataMixin

__all__ = ["Plan", "load_plan"]


class Plan(MetadataMixin):
    """Summary of an RT Plan (or RT Ion Plan) dataset."""

    def __init__(self, plan):
        self.tags = plan.image_set
        self.plan_name = plan.plan_name
        self.modality = plan.modality
        self.filepaths = plan.filepaths
        self.sops = plan.sops

        self.patient_name = self.get_patient_name()
        self.mrn = self.get_mrn()
        self.birthdate = self.get_birthdate()
        self.date = self.get_date()
        self.time = self.get_time()
        self.local_uid = generate_uid()
        self.series_uid = self.get_series_uid()
        self.frame_ref = self.get_frame_ref()

        self.label = plan.label
        self.name = plan.name
        self.description = plan.description
        self.approval_status = plan.approval_status
        self.n_fractions = plan.n_fractions
        self.target_prescription_dose = plan.target_prescription_dose
        self.dose_references = plan.dose_references
        self.fraction_groups = plan.fraction_groups
        self.beams = plan.beams
        self.referenced_structure_set_sop = \
            plan.referenced_structure_set_sop
        self.referenced_dose_sops = plan.referenced_dose_sops
        self.misc = {}

        Data.plan[self.plan_name] = self
        Data.plan_list += [self.plan_name]

    # -- convenience -----------------------------------------------------
    def linked_dose_names(self):
        """Names of ingested Dose grids this plan references (by
        Referenced SOP instance), plus any RTDOSE whose own
        ReferencedRTPlanSequence points back at this plan."""
        mine = set(self.referenced_dose_sops)
        my_sops = set(self.sops)
        out = []
        for name in Data.dose_list:
            dose = Data.dose[name]
            if mine and set(dose.sops) & mine:
                out.append(name)
                continue
            ds = dose.tags[0] if getattr(dose, "tags", None) else None
            if ds is not None and "ReferencedRTPlanSequence" in ds:
                for item in ds.ReferencedRTPlanSequence:
                    if "ReferencedSOPInstanceUID" in item and \
                            str(item.ReferencedSOPInstanceUID) in my_sops:
                        out.append(name)
                        break
        return out

    def total_beam_meterset(self):
        """Sum of ReferencedBeamSequence metersets (MU) over all
        fraction groups; None when absent."""
        total, seen = 0.0, False
        for fg in self.fraction_groups:
            for bd in fg.get("beam_doses", []):
                if bd.get("meterset") is not None:
                    total += float(bd["meterset"])
                    seen = True
        return total if seen else None

    def create_rtplan(self, path=None):
        """Serialize this plan summary back to an RT Plan dataset.
        Carries what the reader harvests: label/
        name/description, approval, dose references, fraction groups
        (with referenced-beam doses/metersets), and the beam list with
        a single control point each — a SUMMARY export, so
        NumberOfControlPoints is written as the serialized CP count
        (PS3.3 C.8.8.14), not the source plan's delivery count. Ion
        plans serialize IonBeamSequence/IonControlPointSequence under
        the RT Ion Plan SOP class. Returns the Dataset; writes to
        ``path`` when given."""
        from ..dicom import Dataset, Sequence, dcmwrite, uids

        ds = Dataset()
        is_ion = any(b.get("radiation") in ("PROTON", "ION")
                     for b in self.beams)
        ds.SOPClassUID = (uids.RTIonPlanStorage if is_ion
                          else uids.RTPlanStorage)
        ds.SOPInstanceUID = generate_uid()
        ds.SeriesInstanceUID = generate_uid()
        ds.StudyInstanceUID = self.get_study_uid()
        ds.Modality = "RTPLAN"
        if self.frame_ref:
            ds.FrameOfReferenceUID = self.frame_ref
        src = self.tags[0]
        for key in ("PatientName", "PatientID", "PatientBirthDate"):
            if key in src:
                setattr(ds, key, src.get(key))
        if self.label is not None:
            ds.RTPlanLabel = self.label
        if self.name is not None:
            ds.RTPlanName = self.name
        if self.description is not None:
            ds.RTPlanDescription = self.description
        if self.approval_status is not None:
            ds.ApprovalStatus = self.approval_status

        def _set(item, key, value):
            if value is not None:
                setattr(item, key, value)

        if self.dose_references:
            seq = []
            for dr in self.dose_references:
                item = Dataset()
                _set(item, "DoseReferenceNumber", dr.get("number"))
                _set(item, "DoseReferenceStructureType",
                     dr.get("structure_type"))
                _set(item, "DoseReferenceType", dr.get("type"))
                _set(item, "DoseReferenceDescription",
                     dr.get("description"))
                _set(item, "TargetPrescriptionDose",
                     dr.get("target_prescription_dose"))
                _set(item, "DeliveryMaximumDose",
                     dr.get("delivery_maximum_dose"))
                seq.append(item)
            ds.DoseReferenceSequence = Sequence(seq)

        if self.fraction_groups:
            seq = []
            for fg in self.fraction_groups:
                item = Dataset()
                _set(item, "FractionGroupNumber", fg.get("number"))
                _set(item, "NumberOfFractionsPlanned",
                     fg.get("n_fractions"))
                _set(item, "NumberOfBeams", fg.get("n_beams"))
                rbs = []
                for bd in fg.get("beam_doses", []):
                    rb = Dataset()
                    _set(rb, "ReferencedBeamNumber", bd.get("beam_number"))
                    _set(rb, "BeamDose", bd.get("dose_gy"))
                    _set(rb, "BeamMeterset", bd.get("meterset"))
                    rbs.append(rb)
                if rbs:
                    item.ReferencedBeamSequence = Sequence(rbs)
                seq.append(item)
            ds.FractionGroupSequence = Sequence(seq)

        if self.beams:
            # ion plans carry Ion(ControlPoint)Sequence per the RT Ion
            # Plan IOD — serializing BeamSequence under the ion SOP
            # class would be a conformance violation
            cp_key = ("IonControlPointSequence" if is_ion
                      else "ControlPointSequence")
            seq = []
            for b in self.beams:
                item = Dataset()
                _set(item, "BeamNumber", b.get("number"))
                _set(item, "BeamName", b.get("name"))
                _set(item, "BeamType", b.get("type"))
                _set(item, "RadiationType", b.get("radiation"))
                _set(item, "TreatmentMachineName", b.get("machine"))
                _set(item, "TreatmentDeliveryType",
                     b.get("delivery_type"))
                _set(item, "FinalCumulativeMetersetWeight",
                     b.get("final_meterset_weight"))
                if any(b.get(k) is not None for k in
                       ("energy", "gantry_angle", "collimator_angle",
                        "couch_angle", "isocenter")):
                    cp = Dataset()
                    cp.ControlPointIndex = 0
                    _set(cp, "NominalBeamEnergy", b.get("energy"))
                    _set(cp, "GantryAngle", b.get("gantry_angle"))
                    _set(cp, "BeamLimitingDeviceAngle",
                         b.get("collimator_angle"))
                    _set(cp, "PatientSupportAngle", b.get("couch_angle"))
                    _set(cp, "IsocenterPosition", b.get("isocenter"))
                    setattr(item, cp_key, Sequence([cp]))
                    # PS3.3 C.8.8.14: the declared count MUST equal the
                    # serialized ControlPointSequence length — this is a
                    # summary export, so 1, not the source plan's count
                    item.NumberOfControlPoints = 1
                elif b.get("n_control_points") is not None:
                    item.NumberOfControlPoints = 0
                seq.append(item)
            if is_ion:
                ds.IonBeamSequence = Sequence(seq)
            else:
                ds.BeamSequence = Sequence(seq)

        if self.referenced_structure_set_sop:
            rs = Dataset()
            rs.ReferencedSOPClassUID = uids.RTStructureSetStorage
            rs.ReferencedSOPInstanceUID = self.referenced_structure_set_sop
            ds.ReferencedStructureSetSequence = Sequence([rs])
        if self.referenced_dose_sops:
            seq = []
            for sop in self.referenced_dose_sops:
                rd = Dataset()
                rd.ReferencedSOPClassUID = uids.RTDoseStorage
                rd.ReferencedSOPInstanceUID = sop
                seq.append(rd)
            ds.ReferencedDoseSequence = Sequence(seq)

        if path is not None:
            dcmwrite(path, ds)
        return ds

    def summary(self):
        return {
            "plan": self.plan_name,
            "label": self.label,
            "n_fractions": self.n_fractions,
            "prescription_gy": self.target_prescription_dose,
            "beams": len(self.beams),
            "approval": self.approval_status,
        }

    # -- persistence (documented json schema, like the other types) ------
    def save_plan(self, path):
        """Write the plan summary as ``{path}/{plan_name}/meta.json``
        (the json+npy persistence stance of every other structure;
        plans are pure metadata so json alone suffices)."""
        import json
        import os

        base = os.path.join(str(path), self.plan_name)
        os.makedirs(base, exist_ok=True)
        meta = {
            "plan_name": self.plan_name, "modality": self.modality,
            "patient_name": self.patient_name, "mrn": self.mrn,
            "birthdate": str(self.birthdate),
            "date": str(self.date), "time": str(self.time),
            "series_uid": str(self.series_uid),
            "frame_ref": (str(self.frame_ref)
                          if self.frame_ref else None),
            "label": self.label, "name": self.name,
            "description": self.description,
            "approval_status": self.approval_status,
            "n_fractions": self.n_fractions,
            "target_prescription_dose": self.target_prescription_dose,
            "dose_references": self.dose_references,
            "fraction_groups": self.fraction_groups,
            "beams": self.beams,
            "referenced_structure_set_sop":
                self.referenced_structure_set_sop,
            "referenced_dose_sops": self.referenced_dose_sops,
            "sops": [str(s) for s in self.sops],
        }
        with open(os.path.join(base, "meta.json"), "w") as fh:
            json.dump(meta, fh, indent=1)
        return base

    @classmethod
    def load_plan(cls, path):
        """Load a :meth:`save_plan` directory back into ``Data.plan``
        (name-collision suffixing like the other load_* paths;
        classmethod like every sibling loader — the module-level
        ``load_plan`` alias below is kept for callers that imported
        it directly)."""
        import json
        import os
        import types

        from .common import collision_suffix, rebuild_dataset_from_meta

        with open(os.path.join(str(path), "meta.json")) as fh:
            meta = json.load(fh)

        ds = rebuild_dataset_from_meta(
            meta, os.path.join(str(path), "meta.json"), "RTPLAN")
        name = collision_suffix(meta.get("plan_name", "RTPLAN 01"),
                                Data.plan)

        carrier = types.SimpleNamespace(
            image_set=[ds],
            plan_name=name,
            modality=meta.get("modality", "RTPLAN"),
            filepaths=[ds.filename],
            sops=meta.get("sops", []),
            label=meta.get("label"),
            name=meta.get("name"),
            description=meta.get("description"),
            approval_status=meta.get("approval_status"),
            n_fractions=meta.get("n_fractions"),
            target_prescription_dose=meta.get(
                "target_prescription_dose"),
            dose_references=meta.get("dose_references", []),
            fraction_groups=meta.get("fraction_groups", []),
            beams=meta.get("beams", []),
            referenced_structure_set_sop=meta.get(
                "referenced_structure_set_sop"),
            referenced_dose_sops=meta.get("referenced_dose_sops", []),
        )
        return cls(carrier)


def load_plan(path):
    """Module-level alias for :meth:`Plan.load_plan`."""
    return Plan.load_plan(path)
