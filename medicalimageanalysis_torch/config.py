"""Central numeric-policy configuration.

Carried over from medicalimageanalysis_tpu/config.py with identical
defaults, for the constants the ported slices read; the others (mesh,
ICP, B-spline) arrive with their slices. The TPU execution knobs
(jit_ingest, mesh axes, the shear-warp lane) have no counterpart here.
"""

from dataclasses import dataclass


@dataclass
class MiaConfig:
    background_fill: float = -3001.0
    contour_decimals: int = 3
    spacing_tolerance_mm: float = 0.01


config = MiaConfig()
