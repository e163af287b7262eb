"""Device choice and float32 numerics for the port.

TF32 keeps about three decimal digits; it is the H100's version of the
TPU's bf16 matmul default, which once destroyed the LNCC cancellation in
the JAX package. Every contraction of the port (the stride-s downsample,
the preprocess einsums, the MI joint histogram) runs inside
:func:`full_float32`, so it computes in full float32 even in a process
that turned TF32 on; :func:`set_numerics` turns it off process-wide.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["as_f32", "default_device", "full_float32", "set_default_device",
           "set_numerics", "using_device"]

_requested = None


def set_default_device(device):
    """Make ``device`` (e.g. ``"cpu"``) the device of every entry point
    called without one; ``None`` goes back to the card."""
    global _requested
    _requested = None if device is None else torch.device(device)


@contextlib.contextmanager
def using_device(device):
    """Within the block, ``device`` (e.g. ``"cpu"``) is the device of
    every entry point called without one, as :func:`set_default_device`
    makes it; the earlier choice is restored on exit. ``None`` changes
    nothing."""
    global _requested
    saved = _requested
    if device is not None:
        set_default_device(device)
    try:
        yield
    finally:
        _requested = saved


def default_device():
    """The device an entry point runs on when the caller names none: the
    one asked for through :func:`set_default_device`, else ``cuda``. With
    no card and no request it raises: the port never falls back to the
    CPU unasked."""
    if _requested is not None:
        return _requested
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card. To run on the CPU, "
            "pass device='cpu' to the entry point or call "
            "medicalimageanalysis_torch.device.set_default_device('cpu') "
            "first.")
    return torch.device("cuda")


def as_f32(a, device=None):
    """``a`` (array, tensor or scalars) as a float32 tensor on ``device``;
    with no device a tensor stays where it is and anything else goes to
    :func:`default_device`."""
    if device is None:
        device = a.device if isinstance(a, torch.Tensor) else default_device()
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def set_numerics():
    """Full-float32 matmuls and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def full_float32():
    """Full-float32 matmuls and convolutions inside the block (or the
    decorated function), whatever the caller set; the caller's setting
    is restored on exit."""
    matmul = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = cudnn
