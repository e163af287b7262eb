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

__all__ = ["as_f32", "default_device", "full_float32", "set_numerics"]


def default_device():
    """``cuda`` when a card is present, else ``cpu``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


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
