"""Central numeric-policy configuration.

Carried over from medicalimageanalysis_tpu/config.py with identical
defaults, for the constants the ported slices read (the 3MF reader's
50k-point decimation target among them). ``use_shear_warp`` keeps the JAX
package's meaning: ``reslice_transform`` (``Rigid.create_image`` and the
Rigid view updates) takes the three-pass shear-warp lane
(ops/resample.affine_resample_shear, the lane_interp kernel on the card)
instead of the exact one-pass affine warp. The other TPU execution knobs
(jit_ingest, mesh axes) have no counterpart here.
"""

from dataclasses import dataclass


@dataclass
class MiaConfig:
    background_fill: float = -3001.0
    contour_decimals: int = 3
    spacing_tolerance_mm: float = 0.01
    mesh_decimate_target_points: int = 50_000
    use_shear_warp: bool = False


config = MiaConfig()
