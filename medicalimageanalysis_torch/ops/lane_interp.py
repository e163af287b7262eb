"""Per-row 1-D linear interpolation: a hand-written CUDA kernel and its
plain twin.

Port of ``lane_interp`` and ``shear_x`` in
medicalimageanalysis_tpu/ops/pallas_kernels.py, whose TPU kernel
(``_lane_interp_kernel``) becomes csrc/lane_interp.cu. For data (R, Xs)
and positions (R, Xd), float32:

    out[r, j] = data[r, x0] * (1 - f) + data[r, x0 + 1] * f,
    x0 = clamp(floor(pos[r, j]), 0, Xs - 2),  f = pos[r, j] - x0,

and 0 unless -0.5 < pos < Xs - 0.5 (NaN and +-inf give 0). It is the
building block of the three-pass shear-warp reslice
(ops/resample.affine_resample_shear).

It is registered as the PyTorch operator ``torch.ops.mia_torch.
lane_interp``. The dispatcher picks the implementation by the tensors'
device and nothing else: a CPU tensor runs the plain twin
``lane_interp_plain``, a CUDA tensor launches the kernel or raises.

``Xs == 1``: the JAX package's two routes disagree there (the Pallas
kernel reads a zero-padded lane at index -1, its XLA twin wraps to the
last column). The port reads the one column for both taps, the edge
value to within rounding (ROADMAP.md queue 3). The TPU's 128-lane and
row-tile padding and the segmented vreg gather (``_gather_lanes``) have
no counterpart.
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["LAUNCHES", "lane_interp", "lane_interp_plain", "shear_x"]

# Kernel launches; a run reads it to show that its path went through the
# kernel. Only the CUDA implementation adds to it.
LAUNCHES = {"lane_interp": 0}


def lane_interp_plain(data, pos):
    """The plain twin, in the kernel's operation order: data (R, Xs),
    pos (R, Xd) float32 -> (R, Xd) float32 on their device."""
    Xs = data.shape[1]
    # clamp in float before the cast, as the kernel does (NaN -> 0); the
    # mask below zeroes every position whose clamp changed the tap
    x0f = torch.nan_to_num(torch.floor(pos), nan=0.0).clamp(
        0, max(Xs - 2, 0))
    x0 = x0f.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=Xs - 1)
    f = pos - x0f
    out = torch.gather(data, 1, x0) * (1 - f) \
        + torch.gather(data, 1, x1) * f
    valid = (pos > -0.5) & (pos < Xs - 0.5)
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype,
                                               device=out.device))


def check_index_range(R, Xs, Xd):
    """Raise unless R * max(Xs, Xd) < 2^31: the kernel's offsets inside
    data, pos and out are int32."""
    if R * max(Xs, Xd) >= 2 ** 31:
        raise ValueError(f"lane_interp kernel: {R} rows of {max(Xs, Xd)} "
                         "floats reach 2^31 elements, beyond the kernel's "
                         "int32 offsets")


@torch.library.custom_op("mia_torch::lane_interp", mutates_args=(),
                         device_types="cpu")
def _lane_interp_op(data: Tensor, pos: Tensor) -> Tensor:
    return lane_interp_plain(data, pos)


@_lane_interp_op.register_kernel("cuda")
def _lane_interp_cuda(data, pos):
    from ._build import load_lane_interp_library

    dev = data.device
    for name, t in (("data", data), ("pos", pos)):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.dim() != 2:
            raise ValueError(
                f"lane_interp kernel: {name} must be a contiguous 2-d "
                f"float32 tensor on {dev}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    R, Xs = data.shape
    if pos.shape[0] != R or Xs < 1:
        raise ValueError("lane_interp kernel: data (R, Xs >= 1) and pos "
                         f"(R, Xd), got {tuple(data.shape)}, "
                         f"{tuple(pos.shape)}")
    check_index_range(R, Xs, pos.shape[1])
    out = torch.empty(pos.shape, dtype=torch.float32, device=dev)
    lib = load_lane_interp_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mia_lane_interp(data.data_ptr(), pos.data_ptr(), R, Xs,
                                  pos.shape[1], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"lane_interp launch failed: CUDA error {err}")
    LAUNCHES["lane_interp"] += 1
    return out


def lane_interp(data, pos):
    """Per-row linear interpolation along the last axis: data (R, Xs),
    pos (R, Xd) sample positions into each row -> (R, Xd) float32, zero
    outside (-0.5, Xs - 0.5). A tensor stays on its device; anything
    else goes to ``default_device()``."""
    from ..device import default_device

    device = data.device if isinstance(data, Tensor) else default_device()
    data = torch.as_tensor(data, device=device).to(torch.float32).contiguous()
    pos = torch.as_tensor(pos, device=device).to(torch.float32).contiguous()
    return _lane_interp_op(data, pos)


def shear_x(vol, pos_x):
    """Resample a (Z, Y, Xs) volume along x: out[z, y, x] =
    vol[z, y, pos_x[z, y, x]] (linear, zero outside); pos_x (Z, Y, Xd).
    One pass of the shear-decomposed affine warp: the rows are flattened
    to (Z*Y, X) for the lane_interp kernel."""
    Z, Y, Xs = vol.shape
    Xd = pos_x.shape[-1]
    out = lane_interp(vol.reshape(Z * Y, Xs), pos_x.reshape(Z * Y, Xd))
    return out.reshape(Z, Y, Xd)
