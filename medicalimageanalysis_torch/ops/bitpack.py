"""Lossless 12-bit pixel packing for host -> device staging, and 1-bit
mask packing for device -> host.

Port of medicalimageanalysis_tpu/ops/bitpack.py. CT pixels are <= 12
bits stored in int16; packing groups of 8 values into 3 uint32 words
(96 bits) cuts the staged bytes by 25 %, and the card unpacks them with
eight static shift / mask extractions (plain PyTorch bit operations).

Packing is RANGE-KEYED and lossless: values are offset by the batch min
and must span < 4096; :func:`pack12` returns None when they don't
(callers stage raw int16 instead, e.g. 16-bit MR).

:func:`packbits_device` is ``np.packbits`` on the device, for 0/1 masks
that come down to the host a bit a voxel (the ROI mask cache), and
:func:`unpackbits_device` its inverse, for the packed crops the cache
keeps on the device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pack12", "packbits_device", "unpack12_device",
           "unpackbits_device"]


def pack12(arr):
    """Pack an int array whose value RANGE fits 12 bits (on the host).

    arr: any-shape integer array with (max - min) < 4096, trailing axis
    length padded internally to a multiple of 8.

    Returns ``(words, lo, orig_tail)`` — ``words`` uint32 with shape
    ``arr.shape[:-1] + (ceil(tail/8)*3,)``, ``lo`` the int offset,
    ``orig_tail`` the unpadded trailing length — or None when the range
    does not fit (caller stages raw).
    """
    a = np.asarray(arr)
    if not np.issubdtype(a.dtype, np.integer) or a.size == 0:
        return None
    lo = int(a.min())
    if int(a.max()) - lo > 0xFFF:
        return None
    # the port's threaded native packer when the layout allows zero-copy
    # (int16, contiguous, tail already a multiple of 8)
    tail_ = a.shape[-1]
    if (a.dtype == np.int16 and tail_ % 8 == 0
            and a.flags.c_contiguous):
        from ..native import pack12_native
        w = np.empty(a.shape[:-1] + (tail_ // 8 * 3,), np.uint32)
        if pack12_native(a.reshape(-1), lo, w.reshape(-1)):
            return w, lo, tail_
    v = (a.astype(np.int32) - lo).astype(np.uint32)
    tail = a.shape[-1]
    pad = (-tail) % 8
    if pad:
        v = np.concatenate(
            [v, np.zeros(a.shape[:-1] + (pad,), np.uint32)], axis=-1)
    g = v.reshape(a.shape[:-1] + ((tail + pad) // 8, 8))
    w = np.empty(a.shape[:-1] + ((tail + pad) // 8, 3), np.uint32)
    np.bitwise_or(g[..., 0], g[..., 1] << 12, out=w[..., 0])
    w[..., 0] |= (g[..., 2] & 0xFF) << 24
    np.bitwise_or(g[..., 2] >> 8, g[..., 3] << 4, out=w[..., 1])
    w[..., 1] |= g[..., 4] << 16
    w[..., 1] |= (g[..., 5] & 0xF) << 28
    np.bitwise_or(g[..., 5] >> 4, g[..., 6] << 8, out=w[..., 2])
    w[..., 2] |= g[..., 7] << 20
    return w.reshape(a.shape[:-1] + (-1,)), lo, tail


def unpack12_device(words, lo, tail, dtype=torch.float32, device=None):
    """Inverse of :func:`pack12` on ``device`` (default: where ``words``
    already is for a tensor, else the card).

    words: (..., 3*ceil(tail/8)) uint32 numpy array, or its int32 tensor
    view; returns (..., tail) ``dtype``. The words are held as int32 (the
    same bits): each right shift is masked to the bits it keeps, so the
    arithmetic shift's sign bits never reach a value.
    """
    from ..device import default_device

    if isinstance(words, torch.Tensor):
        w = words if device is None else words.to(device)
    else:
        a = np.ascontiguousarray(words)
        w = torch.from_numpy(a.view(np.int32)).to(
            default_device() if device is None else device)
    g = w.reshape(w.shape[:-1] + (w.shape[-1] // 3, 3))
    w0, w1, w2 = g[..., 0], g[..., 1], g[..., 2]
    m = 0xFFF
    vals = torch.stack([
        w0 & m,
        (w0 >> 12) & m,
        (((w0 >> 24) & 0xFF) | (w1 << 8)) & m,
        (w1 >> 4) & m,
        (w1 >> 16) & m,
        (((w1 >> 28) & 0xF) | (w2 << 4)) & m,
        (w2 >> 8) & m,
        (w2 >> 20) & m], dim=-1)
    vals = vals.reshape(w.shape[:-1] + (-1,))[..., :tail]
    return vals.to(dtype) + torch.tensor(lo, dtype=dtype, device=w.device)


def packbits_device(crops):
    """``np.packbits`` of each 0/1 uint8 tensor of ``crops`` (all on one
    device, any strides), on that device: a crop flattened in C order,
    eight values a byte, the first in the high bit, its last byte
    zero-padded. Returns the packed bytes of every crop, one after
    another, as one uint8 tensor, and each crop's byte count."""
    counts = [-(-c.numel() // 8) for c in crops]
    device = crops[0].device
    bits = torch.zeros(8 * sum(counts), dtype=torch.uint8, device=device)
    off = 0
    for c, nb in zip(crops, counts):
        bits[off:off + c.numel()].view(c.shape).copy_(c)
        off += 8 * nb
    # made on the device: an upload would wait for the copies above
    weights = (128 >> torch.arange(8, device=device)).to(torch.uint8)
    return torch.sum(bits.view(-1, 8) * weights, dim=1,
                     dtype=torch.uint8), counts


def unpackbits_device(packed, n):
    """``np.unpackbits(packed, count=n)`` on ``packed``'s device: the
    first ``n`` bits of a uint8 tensor, the high bit of each byte first,
    as uint8 0 / 1."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts) & 1).view(-1)[:n]
