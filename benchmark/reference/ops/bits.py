"""Bit-packed binary-mask transport.  Port of ``yolact_tpu/ops/bits.py``.

Ground-truth instance masks are 0/1 uint8 arrays padded to fixed shapes
(``[B, max_gt, S, S]`` for training: 242 MB a batch at b8, 550², max_gt
100).  The host packs 8 pixels a byte along the last axis (``np.packbits``,
MSB first) and the device unpacks with a shift and a mask: an 8x cut of the
host-to-device copy for one elementwise pass on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def packed_width(size: int) -> int:
    return -(-size // 8)


def pack_bits_last(masks: np.ndarray) -> np.ndarray:
    """Host: pack a binary array's last axis, 8 pixels a byte (MSB first)."""
    return np.packbits(np.asarray(masks) > 0, axis=-1)


def unpack_bits_last(packed: torch.Tensor, size: int) -> torch.Tensor:
    """Device: invert :func:`pack_bits_last` back to uint8 0/1.

    packed ``[..., ceil(size/8)]`` uint8 -> ``[..., size]`` uint8, on
    `packed`'s device."""
    shifts = 7 - torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)[..., :size]
