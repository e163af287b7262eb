"""DeformableTorch: the deformable-registration backend facade.

Port of medicalimageanalysis_tpu/utils/deformable/jax_backend.py
(``DeformableJAX``, the reference's ``DeformableITK`` API): B-spline and
the demons family, cross-modality gradient correction, mask blurring,
grid resampling, joint-mask cropping and the elastix-parity B-spline
(``elastix``: ops/registration/bspline.elastix_registration). Volumes
are dicts {array, origin, spacing, direction} of numpy values, as in the
JAX package; the compute runs on ``device`` (default: the card when
present).
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import default_device
from ...ops.filters import gaussian_filter
from ...ops.registration.bspline import bspline_registration
from ...ops.registration.demons import demons_registration
from ...ops.registration.dvf import gradient_magnitude
from ...ops.resample import affine_resample, compose_pixel_matrix
from ...telemetry import trace

__all__ = ["DeformableTorch", "DeformableJAX", "DeformableITK"]


def _volume(array, origin=(0, 0, 0), spacing=(1, 1, 1), direction=None):
    return {"array": np.asarray(array),
            "origin": np.asarray(origin, dtype=np.float64),
            "spacing": np.asarray(spacing, dtype=np.float64),
            "direction": np.eye(3) if direction is None
            else np.asarray(direction, dtype=np.float64)}


def _demons_method(method, doc):
    """A backend method running ``demons_registration`` with ``method``
    on the (cropped, masked) pair; ``info`` receives the per-level
    shapes. ``elastic_lambda`` is read by 'biomechanical'
    only, ``pyramid`` by every method."""

    def run(self, smooth=True, std=1, iterations=50,
            intensity_threshold=0.001, step=2.0, *, elastic_lambda=0.2,
            crop=5, pyramid=None, forces="ssd", lncc_radius=3, info=None):
        with trace("mia.demons.inputs"):
            if crop > 0:
                self.mask_crop(margin=crop)
            fixed, moving = self._masked_arrays()
        dvf = demons_registration(
            fixed, moving, self.reference_image["spacing"], method=method,
            smooth=smooth, std=std, iterations=iterations,
            intensity_threshold=intensity_threshold, step=step,
            elastic_lambda=elastic_lambda, pyramid=pyramid, forces=forces,
            lncc_radius=lncc_radius, device=self.device, info=info)
        return self._dvf_volume(dvf)

    run.__name__ = {"fast": "fast_demons"}.get(method, method)
    run.__doc__ = doc
    return run


class DeformableTorch(object):
    """Deformable backend: reference/moving images + optional masks."""

    def __init__(self, reference_image=None, moving_image=None,
                 reference_mask=None, moving_mask=None, device=None):
        self.reference_image = reference_image
        self.reference_mask = reference_mask
        self.moving_image = moving_image
        self.moving_mask = moving_mask
        self.device = default_device() if device is None \
            else torch.device(device)

    def create_sitk_image(self, array, origin, spacing, direction,
                          reference=True, mask=False):
        """Store a geometric volume (name kept from the reference API;
        no SimpleITK involved)."""
        vol = _volume(array, origin, spacing, direction)
        if reference:
            if mask:
                self.reference_mask = vol
            else:
                self.reference_image = vol
        else:
            if mask:
                self.moving_mask = vol
            else:
                self.moving_image = vol
        return vol

    create_volume = create_sitk_image

    def cross_modality_correction(self):
        """Gradient-magnitude both images."""
        for vol in (self.reference_image, self.moving_image):
            if vol is not None:
                vol["array"] = gradient_magnitude(
                    vol["array"], vol["spacing"],
                    device=self.device).cpu().numpy()

    def blur_mask(self, sigma=2):
        """Gaussian blur + min-max normalise the masks."""
        for attr in ("reference_mask", "moving_mask"):
            vol = getattr(self, attr)
            if vol is None:
                continue
            blurred = gaussian_filter(
                torch.as_tensor(vol["array"].astype(np.float32),
                                device=self.device),
                sigma, vol["spacing"]).cpu().numpy()
            lo, hi = blurred.min(), blurred.max()
            vol["array"] = (blurred - lo) / max(hi - lo, 1e-9)

    @trace("mia.deformable.resample")
    def resample(self):
        """Resample the moving image/mask onto the reference grid."""
        def do(mov, ref):
            A = compose_pixel_matrix(
                mov["direction"], mov["spacing"], mov["origin"],
                ref["direction"], ref["spacing"], ref["origin"])
            out = affine_resample(mov["array"], A, ref["array"].shape,
                                  background=0.0, device=self.device)
            return _volume(out.cpu().numpy(), ref["origin"], ref["spacing"],
                           ref["direction"])

        if self.reference_image is not None and self.moving_image is not None:
            self.moving_image = do(self.moving_image, self.reference_image)
        if self.reference_mask is not None and self.moving_mask is not None:
            self.moving_mask = do(self.moving_mask, self.reference_mask)

    def _masked_arrays(self):
        fixed = self.reference_image["array"].astype(np.float32)
        moving = self.moving_image["array"].astype(np.float32)
        if self.reference_mask is not None:
            fixed = fixed * self.reference_mask["array"].astype(np.float32)
        if self.moving_mask is not None:
            moving = moving * self.moving_mask["array"].astype(np.float32)
        return fixed, moving

    def _dvf_volume(self, dvf):
        ref = self.reference_image
        return {"array": dvf, "origin": ref["origin"],
                "spacing": ref["spacing"], "direction": ref["direction"]}

    def bspline(self, control_spacing=None, mesh_size=None, gradient=1e-5,
                iterations=100, crop=5, lr=0.5):
        """B-spline FFD; returns the DVF volume dict on the (possibly
        cropped) reference grid. ``gradient`` is accepted for the
        reference's signature and unused, as in the JAX package."""
        if crop > 0:
            self.mask_crop(margin=crop)
        fmask = None if self.reference_mask is None \
            else self.reference_mask["array"]
        mmask = None if self.moving_mask is None \
            else self.moving_mask["array"]
        dvf, _ = bspline_registration(
            self.reference_image["array"], self.moving_image["array"],
            self.reference_image["spacing"],
            control_spacing=control_spacing, mesh_size=mesh_size,
            iterations=iterations, lr=lr, fixed_mask=fmask,
            moving_mask=mmask, device=self.device)
        return self._dvf_volume(dvf)

    def elastix(self, parameter=None, metric="Intensity", bins=6,
                resolution=4, spacing=10, iterations=2000, order=3,
                crop=5, info=None):
        """Elastix-parity nonrigid registration (the reference needs a
        SimpleElastix build, simpleitk.py:131-176): multi-resolution
        B-spline with Mattes mutual information (``metric`` anything but
        'Intensity', like the reference's switch) or mean squares, grid
        and image halving per level; an elastix-style parameter map (or
        a sequence of stage maps) through ``parameter``. ``order`` is
        accepted for the reference's signature (cubic always); ``info``
        receives the levels' shapes and seconds."""
        from ...ops.registration.bspline import elastix_registration

        if crop > 0:
            self.mask_crop(margin=crop)
        fmask = None if self.reference_mask is None \
            else self.reference_mask["array"]
        mmask = None if self.moving_mask is None \
            else self.moving_mask["array"]
        dvf, _ = elastix_registration(
            self.reference_image["array"].astype(np.float32),
            self.moving_image["array"].astype(np.float32),
            self.reference_image["spacing"], parameter_map=parameter,
            metric=("mse" if metric == "Intensity" else "mi"),
            bins=max(int(bins), 8), resolutions=int(resolution),
            final_grid_spacing=float(spacing),
            iterations=min(int(iterations), 300), fixed_mask=fmask,
            moving_mask=mmask, device=self.device, info=info)
        return self._dvf_volume(dvf)

    demons = _demons_method("demons", "Thirion demons (ITK "
                            "DemonsRegistrationFilter).")
    fast_demons = _demons_method("fast", "Symmetric-forces demons (ITK "
                                 "FastSymmetricForcesDemons).")
    diffeomorphic = _demons_method("diffeomorphic", "Diffeomorphic demons: "
                                   "exp(update) composed into the field.")
    syn = _demons_method("syn", "Greedy SyN: inverse-consistent symmetric "
                         "diffeomorphic registration.")
    biomechanical = _demons_method("biomechanical", "Linear-elastic demons "
                                   "(grad(div u) relaxation).")

    def mask_crop(self, margin=5):
        """Crop images+masks to the joint-mask bbox + margin."""
        if self.reference_mask is None or self.moving_mask is None:
            return
        combined = (np.asarray(self.reference_mask["array"]) > 0) \
            | (np.asarray(self.moving_mask["array"]) > 0)
        if not combined.any():
            return
        nz = np.argwhere(combined)
        lo = np.maximum(nz.min(axis=0) - margin, 0)
        hi = np.minimum(nz.max(axis=0) + 1 + margin, combined.shape)

        def crop(vol):
            arr = vol["array"][lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
            # origin moves by the cropped-away voxels (x, y, z)
            shift = np.array([lo[2], lo[1], lo[0]], dtype=np.float64)
            new_origin = vol["origin"] + vol["direction"].T @ (
                shift * vol["spacing"])
            return _volume(arr, new_origin, vol["spacing"],
                           vol["direction"])

        self.reference_image = crop(self.reference_image)
        self.moving_image = crop(self.moving_image)
        self.reference_mask = crop(self.reference_mask)
        self.moving_mask = crop(self.moving_mask)


# the JAX package's and the reference's class names, for drop-in imports
DeformableJAX = DeformableITK = DeformableTorch
