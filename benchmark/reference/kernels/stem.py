"""Frozen plain PyTorch copy of the port's space-to-depth stem conv
(``yolact_tpu_torch/kernels/stem.py``): the plain version alone, under the
kernel's name, so the reference's model runs it wherever the port would
launch the kernel."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stem_conv_s2d_plain(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W], w2 [O, C, 4, 4] -> [B, O, H, W]: the 4x4/s1 conv
    with padding (2, 1), computed in float32 and rounded once to x's dtype,
    as the kernel does.  (cuDNN's own bfloat16 conv accumulates on the
    tensor cores with its own rounding: near-zero outputs then differ by
    thousands of bf16 ulps from any float32 sum.)"""
    out = F.conv2d(F.pad(x.float(), (2, 1, 2, 1)), w2.float())
    return out.to(x.dtype)


stem_conv_s2d = stem_conv_s2d_plain
