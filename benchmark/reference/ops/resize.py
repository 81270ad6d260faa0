"""Bilinear resize in the separable form of ``yolact_tpu/ops/resize.py``:
:func:`resize_bilinear_np` on the host (``resize_bilinear_torch_np``) and
:func:`resize_bilinear` on a tensor's device (``resize_bilinear_torch``).

Torch's ``F.interpolate(mode='bilinear', align_corners=False)`` without
antialiasing is two matmuls with 2-banded weight matrices: half-pixel
sampling with the source coordinate clamped at 0, as ATen's
``upsample_bilinear2d``.  The values equal ``F.interpolate``'s up to the
order of the two passes' roundings; the direct-mask paste
(``detect/postprocess.py:finish_masks_direct``) uses this form, so its
binarised masks equal the JAX package's bit for bit (``F.interpolate`` put
one pixel in 1.9 million on the other side of 0.5 in
``tests/test_torch_options.py``); so do the multires targets of
``data/coco.py:pad_batch`` and ``data/device_augment.py``, which threshold
the resized soft masks at 0.5.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] interpolation matrix, torch half-pixel sampling with the
    source coordinate clamped at 0 (ATen upsample_bilinear2d)."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        src = max((i + 0.5) * scale - 0.5, 0.0)
        x0 = min(int(np.floor(src)), in_size - 1)
        x1 = min(x0 + 1, in_size - 1)
        lam = src - x0
        w[i, x0] += 1.0 - lam
        w[i, x1] += lam
    return w


@lru_cache(maxsize=64)
def _taps(in_size: int, out_size: int):
    """:func:`_weights` as its two taps a row: (first column, last column,
    their weights), the second weight 0 where the row has one column."""
    w = _weights(in_size, out_size)
    nz = w != 0
    first = nz.argmax(1)
    last = in_size - 1 - nz[:, ::-1].argmax(1)
    rows = np.arange(out_size)
    return (first, last, w[rows, first],
            np.where(last != first, w[rows, last], np.float32(0)))


def resize_bilinear_np(x: np.ndarray, size) -> np.ndarray:
    """Resize the trailing two dims of float32 ``[..., H, W]`` to ``size``
    (h, w): the two products of the 2-banded matrices (rows, then
    columns), computed as two taps a pass.  The values are the products'
    (``np.einsum`` of ``yolact_tpu/ops/resize.py``) bit for bit: the other
    terms of each sum are exact zeros."""
    h_out, w_out = size
    h_in, w_in = x.shape[-2], x.shape[-1]
    x = np.asarray(x, np.float32)
    if (h_in, w_in) == (h_out, w_out):
        return x
    i0, i1, w0, w1 = _taps(h_in, h_out)
    x = w0[:, None] * x[..., i0, :] + w1[:, None] * x[..., i1, :]
    i0, i1, w0, w1 = _taps(w_in, w_out)
    return np.ascontiguousarray(x[..., i0] * w0 + x[..., i1] * w1)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Resize the trailing two dims of float32 ``[..., H, W]`` to ``size``
    (h, w) on `x`'s device: the two products of :func:`resize_bilinear_np`
    (rows, then columns)."""
    h_out, w_out = size
    h_in, w_in = x.shape[-2], x.shape[-1]
    if (h_in, w_in) == (h_out, w_out):
        return x.float()
    # non_blocking: a synchronous host-to-device copy would sync the host
    wh = torch.from_numpy(_weights(h_in, h_out)).to(x.device,
                                                    non_blocking=True)
    ww = torch.from_numpy(_weights(w_in, w_out)).to(x.device,
                                                    non_blocking=True)
    return torch.matmul(torch.matmul(wh, x.float()), ww.T)
