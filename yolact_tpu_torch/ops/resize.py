"""Host bilinear resize in the separable form of
``yolact_tpu/ops/resize.py:resize_bilinear_torch_np`` (the port's copy of
its numpy half).

Torch's ``F.interpolate(mode='bilinear', align_corners=False)`` without
antialiasing is two matmuls with 2-banded weight matrices: half-pixel
sampling with the source coordinate clamped at 0, as ATen's
``upsample_bilinear2d``.  The values equal ``F.interpolate``'s up to the
order of the two passes' roundings; the direct-mask paste
(``detect/postprocess.py:finish_masks_direct``) uses this form, so its
binarised masks equal the JAX package's bit for bit (``F.interpolate`` put
one pixel in 1.9 million on the other side of 0.5 in
``tests/test_torch_options.py``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


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


def resize_bilinear_np(x: np.ndarray, size) -> np.ndarray:
    """Resize the trailing two dims of float32 ``[..., H, W]`` to ``size``
    (h, w)."""
    h_out, w_out = size
    h_in, w_in = x.shape[-2], x.shape[-1]
    if (h_in, w_in) == (h_out, w_out):
        return np.asarray(x, np.float32)
    x = np.einsum('oh,...hw->...ow', _weights(h_in, h_out),
                  np.asarray(x, np.float32))
    return np.einsum('pw,...hw->...hp', _weights(w_in, w_out), x)
