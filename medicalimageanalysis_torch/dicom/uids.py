# Copied from medicalimageanalysis_tpu/dicom/uids.py.
"""Transfer-syntax / SOP-class UID constants and UID generation."""

import hashlib
import os
import time

# transfer syntaxes
ImplicitVRLittleEndian = "1.2.840.10008.1.2"
ExplicitVRLittleEndian = "1.2.840.10008.1.2.1"
ExplicitVRBigEndian = "1.2.840.10008.1.2.2"
DeflatedExplicitVRLittleEndian = "1.2.840.10008.1.2.1.99"
RLELossless = "1.2.840.10008.1.2.5"
JPEGBaseline8Bit = "1.2.840.10008.1.2.4.50"
JPEGExtended12Bit = "1.2.840.10008.1.2.4.51"
JPEGLossless = "1.2.840.10008.1.2.4.57"
JPEGLosslessSV1 = "1.2.840.10008.1.2.4.70"
JPEGLSLossless = "1.2.840.10008.1.2.4.80"
JPEGLSNearLossless = "1.2.840.10008.1.2.4.81"
JPEG2000Lossless = "1.2.840.10008.1.2.4.90"
JPEG2000 = "1.2.840.10008.1.2.4.91"
HTJ2KLossless = "1.2.840.10008.1.2.4.201"
HTJ2KLosslessRPCL = "1.2.840.10008.1.2.4.202"
HTJ2K = "1.2.840.10008.1.2.4.203"

UNCOMPRESSED_SYNTAXES = {
    ImplicitVRLittleEndian,
    ExplicitVRLittleEndian,
    ExplicitVRBigEndian,
}

ENCAPSULATED_SYNTAXES = {
    RLELossless,
    JPEGBaseline8Bit,
    JPEGExtended12Bit,
    JPEGLossless,
    JPEGLosslessSV1,
    JPEGLSLossless,
    JPEGLSNearLossless,
    JPEG2000Lossless,
    JPEG2000,
    HTJ2KLossless,
    HTJ2KLosslessRPCL,
    HTJ2K,
}

# SOP classes
CTImageStorage = "1.2.840.10008.5.1.4.1.1.2"
MRImageStorage = "1.2.840.10008.5.1.4.1.1.4"
PETImageStorage = "1.2.840.10008.5.1.4.1.1.128"
USImageStorage = "1.2.840.10008.5.1.4.1.1.6.1"
USMultiframeImageStorage = "1.2.840.10008.5.1.4.1.1.3.1"
XRayRFImageStorage = "1.2.840.10008.5.1.4.1.1.12.2"
DXImageStorage = "1.2.840.10008.5.1.4.1.1.1.1"
CRImageStorage = "1.2.840.10008.5.1.4.1.1.1"
RTStructureSetStorage = "1.2.840.10008.5.1.4.1.1.481.3"
RTDoseStorage = "1.2.840.10008.5.1.4.1.1.481.2"
RTPlanStorage = "1.2.840.10008.5.1.4.1.1.481.5"
RTIonPlanStorage = "1.2.840.10008.5.1.4.1.1.481.8"
SpatialRegistrationStorage = "1.2.840.10008.5.1.4.1.1.66.1"
DeformableSpatialRegistrationStorage = "1.2.840.10008.5.1.4.1.1.66.3"
SegmentationStorage = "1.2.840.10008.5.1.4.1.1.66.4"
NuclearMedicineImageStorage = "1.2.840.10008.5.1.4.1.1.20"
MammographyImageStorage = "1.2.840.10008.5.1.4.1.1.1.2"
XRayAngiographicImageStorage = "1.2.840.10008.5.1.4.1.1.12.1"

MODALITY_SOP_CLASS = {
    "CT": CTImageStorage,
    "MR": MRImageStorage,
    "PT": PETImageStorage,
    "NM": NuclearMedicineImageStorage,
    "US": USImageStorage,
    "RF": XRayRFImageStorage,
    "DX": DXImageStorage,
    "CR": CRImageStorage,
    "MG": MammographyImageStorage,
    "XA": XRayAngiographicImageStorage,
    "RTSTRUCT": RTStructureSetStorage,
    "RTDOSE": RTDoseStorage,
    "REG": SpatialRegistrationStorage,
}

# UUID-derived UID root per DICOM PS3.5 B.2
_UID_ROOT = "2.25."
_counter = [0]


def generate_uid():
    """Generate a unique DICOM UID (2.25.<uuid-as-int> form, <=64 chars)."""
    _counter[0] += 1
    h = hashlib.sha1(
        f"{time.time_ns()}-{os.getpid()}-{_counter[0]}".encode()
    ).digest()
    val = int.from_bytes(h[:15], "big")  # 120 bits -> <= 37 digits
    return (_UID_ROOT + str(val))[:64]
