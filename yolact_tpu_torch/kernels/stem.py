"""The space-to-depth stem conv: CUDA kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``yolact_tpu/kernels/stem.py:_kernel``
(``stem_conv_s2d_pallas``): the 4x4/s1 conv with padding (2, 1) on each
spatial axis (2 before, 1 after) over a 2x2 space-to-depth input, which
with the weight of ``models/layers.py:s2d_stem_kernel`` computes the
ResNet's 7x7/s2/p3 stem.  Layouts: ``x [B, 12, H, W]`` contiguous (NCHW),
``w2 [64, 12, 4, 4]`` -> ``[B, 64, H, W]`` as a ``channels_last`` view (the
kernel writes NHWC, the layout the trunk's convolutions run in; the plain
version returns the same strides), summed in float32 and returned in the
input dtype (float32 or bfloat16).

The kernel (``csrc/stem_s2d.cu``) is an implicit GEMM on the tensor cores
(M = output pixels, N = 64 channels, K = 192 taps), with the input halo
tile and the whole weight in shared memory.  In bfloat16 (``mma.sync``
m16n8k16, float32 sums, a block per tile of 8 x 32 pixels) it is bound by
its 77.4 MB output write at yolact_base 550 b8, which it stores as whole
NHWC pixel rows in 16-byte pieces.  In float32 (``mma.sync``
m16n8k8 in TF32, a persistent block per SM walking tiles of 16 x 32) each
product is split in three, hi*hi + hi*lo + lo*hi with hi and lo TF32, so
the sums keep ~2^-21 of each product where one TF32 pass would keep 2^-11
(``tests/test_torch_stem_tf32.py`` models it).  Only the stem's shape is
taken: 12 input and 64 output channels.

:func:`stem_conv_s2d` takes the plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernel or raises.  The custom op
``torch.ops.yolact_tpu_torch.stem_s2d`` carries both for ``torch.export``
and for autograd on the card (``_build.route``).

Gradients.  On the card autograd records the op, whose backward
(``register_autograd``) is the gradient of the plain version's formulation
(pad (2, 1), float32 conv) by ``torch.nn.grad.conv2d_weight`` and
``conv2d_input``: library convs, as the JAX package's backward is XLA's conv
VJP outside any Pallas body (``yolact_tpu/kernels/stem.py:_bwd``).  Only the
gradients that are needed are computed; the image never needs one.  On the
CPU autograd runs through the plain version itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolact_tpu_torch.kernels import _build

launches = 0        # kernel launches by stem_conv_s2d since import / reset

CIN, COUT = 12, 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def stem_conv_s2d_plain(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W], w2 [O, C, 4, 4] -> [B, O, H, W] channels_last: the
    4x4/s1 conv with padding (2, 1), computed in float32 and rounded once
    to x's dtype, as the kernel does.  (cuDNN's own bfloat16 conv
    accumulates on the tensor cores with its own rounding: near-zero
    outputs then differ by thousands of bf16 ulps from any float32 sum.)"""
    out = F.conv2d(F.pad(x.float(), (2, 1, 2, 1)), w2.float())
    return out.to(x.dtype, memory_format=torch.channels_last)


def _nhwc_empty(x: torch.Tensor, cout: int) -> torch.Tensor:
    """The output of x [B, C, H, W]: [B, cout, H, W] over NHWC storage."""
    b, _, h, w = x.shape
    return x.new_empty((b, h, w, cout)).permute(0, 3, 1, 2)


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


def _launch(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The kernel on checked CUDA tensors; records nothing for autograd.
    (A traced call has no data pointer to check: the alignment is checked
    here, where the kernel launches.)"""
    if x.dtype == torch.bfloat16 and w2.data_ptr() % 16:
        raise ValueError('stem_conv_s2d: a bfloat16 w2 must be 16-byte '
                         'aligned (the kernel copies it in 16-byte pieces)')
    b, _, h, w = x.shape
    out = _nhwc_empty(x, COUT)
    if out.numel() == 0:
        return out
    lib = _build.load()
    global launches
    with _build.device_guard(x.device):
        _build.check(lib.yolact_stem_s2d_conv(
            x.data_ptr(), w2.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x.dtype], b, h, w, _build.stream_ptr(x.device)),
            'yolact_stem_s2d_conv')
    launches += 1
    return out


def stem_conv_s2d_grads(x: torch.Tensor, w2: torch.Tensor, g: torch.Tensor,
                        need_x: bool = True, need_w2: bool = True):
    """(grad_x, grad_w2) of :func:`stem_conv_s2d_plain` for the output
    gradient `g`, each in its input's dtype, None where not needed: the
    float32 conv's gradients over the padded input."""
    xp = F.pad(x.float(), (2, 1, 2, 1))
    gf = g.float()
    gx = gw = None
    if need_x:
        gx = torch.nn.grad.conv2d_input(xp.shape, w2.float(), gf)
        gx = gx[:, :, 2:-1, 2:-1].to(x.dtype)
    if need_w2:
        gw = torch.nn.grad.conv2d_weight(xp, w2.shape, gf).to(w2.dtype)
    return gx, gw


@torch.library.custom_op('yolact_tpu_torch::stem_s2d', mutates_args=(),
                         device_types='cpu')
def stem_s2d_op(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The kernel as a custom op: the plain version on the CPU."""
    return stem_conv_s2d_plain(x, w2)


@stem_s2d_op.register_kernel('cuda')
def _stem_s2d_cuda(x, w2):
    return _launch(x.contiguous(), w2.contiguous())


@stem_s2d_op.register_fake
def _stem_s2d_fake(x, w2):
    return _nhwc_empty(x, w2.shape[0])


def _stem_s2d_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _stem_s2d_backward(ctx, g):
    x, w2 = ctx.saved_tensors
    return stem_conv_s2d_grads(x, w2, g, *ctx.needs_input_grad)


stem_s2d_op.register_autograd(_stem_s2d_backward,
                              setup_context=_stem_s2d_setup)


def stem_conv_s2d(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`stem_conv_s2d_plain` for the stem's shape;
    the CUDA kernel for CUDA tensors, differentiable in x and w2."""
    how = _build.route('stem_conv_s2d', x.device, x, w2)
    if how == 'plain':
        return stem_conv_s2d_plain(x, w2)
    if x.device.type == 'cuda':
        _check(x, w2)
    if how == 'op':
        return stem_s2d_op(x, w2)
    return _launch(x, w2)
