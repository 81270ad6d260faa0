"""The space-to-depth stem conv: CUDA kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``yolact_tpu/kernels/stem.py:_kernel``
(``stem_conv_s2d_pallas``): the 4x4/s1 conv with padding (2, 1) on each
spatial axis (2 before, 1 after) over a 2x2 space-to-depth input, which
with the weight of ``models/layers.py:s2d_stem_kernel`` computes the
ResNet's 7x7/s2/p3 stem.  Layouts are the port's NCHW: ``x [B, 12, H, W]``,
``w2 [64, 12, 4, 4]`` -> ``[B, 64, H, W]``, summed in float32 and returned
in the input dtype (float32 or bfloat16).

The kernel (``csrc/stem_s2d.cu``) is a plain-FMA direct convolution: one
block per tile of 8 rows x 32 columns of output pixels and all 64 output
channels, with the input halo tile and the whole weight in shared memory.
At yolact_base 550 b8 the conv is 14.9 GFLOP against 92 MB of traffic, so
without tensor cores it is bound by float32 FMAs; cuDNN's convs reach the
tensor cores.  Only the stem's shape is taken: 12 input and 64 output
channels.

:func:`stem_conv_s2d` takes the plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolact_tpu_torch.kernels import _build

launches = 0        # kernel launches by stem_conv_s2d since import / reset

CIN, COUT = 12, 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def stem_conv_s2d_plain(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W], w2 [O, C, 4, 4] -> [B, O, H, W]: the 4x4/s1 conv
    with padding (2, 1), computed in float32 and rounded once to x's dtype,
    as the kernel does.  (cuDNN's own bfloat16 conv accumulates on the
    tensor cores with its own rounding: near-zero outputs then differ by
    thousands of bf16 ulps from any float32 sum.)"""
    out = F.conv2d(F.pad(x.float(), (2, 1, 2, 1)), w2.float())
    return out.to(x.dtype)


def _check(x: torch.Tensor, w2: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[1] != CIN:
        raise ValueError(f'stem_conv_s2d: x must be [B, {CIN}, H, W], got '
                         f'{tuple(x.shape)}')
    if tuple(w2.shape) != (COUT, CIN, 4, 4):
        raise ValueError(f'stem_conv_s2d: w2 must be [{COUT}, {CIN}, 4, 4], '
                         f'got {tuple(w2.shape)}')
    if x.dtype not in _DTYPE_CODES or w2.dtype != x.dtype:
        raise ValueError(f'stem_conv_s2d: x and w2 must both be float32 or '
                         f'bfloat16, got {x.dtype} and {w2.dtype}')
    if not (x.is_contiguous() and w2.is_contiguous()):
        raise ValueError('stem_conv_s2d: x and w2 must be contiguous')
    if x.device != w2.device:
        raise ValueError('stem_conv_s2d: x and w2 on different devices')


def stem_conv_s2d(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`stem_conv_s2d_plain` for the stem's shape;
    the CUDA kernel for CUDA tensors."""
    if x.device.type == 'cpu':
        return stem_conv_s2d_plain(x, w2)
    if x.device.type != 'cuda':
        raise ValueError(f'stem_conv_s2d: unsupported device {x.device}')
    _check(x, w2)
    b, _, h, w = x.shape
    out = torch.empty((b, COUT, h, w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    global launches
    _build.check(lib.yolact_stem_s2d_conv(
        x.data_ptr(), w2.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype],
        b, h, w, _build.stream_ptr(x.device)), 'yolact_stem_s2d_conv')
    launches += 1
    return out
