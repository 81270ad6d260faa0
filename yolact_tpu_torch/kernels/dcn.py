"""Modulated deformable convolution (DCNv2): the sampling kernel and its
plain PyTorch version.

Port of ``yolact_tpu/kernels/dcn.py:deform_conv2d`` (forward) and its
sampler ``_bilinear_gather_block``.  The TPU package probed this gather
with four Pallas kernels (``scripts/bench_gather2.py:pallas_kernel``,
``taa_kernel``, ``taa4_kernel``, ``scripts/probe_sameshape_gather.py:
kernel``) and ships it as an XLA gather; here it is one CUDA kernel,
``csrc/dcn_im2col.cu``, that writes the modulated im2col columns.  The
GEMM stays ``torch.matmul``, as JAX leaves it to an XLA ``dot_general``.

Layouts at the public functions are the port's NCHW: ``x [B, Cin, H, W]``
(contiguous, or ``channels_last``, which the sampler reads without a
copy), ``offset [B, 2*K*K, Ho, Wo]`` float32 with channels ``2t`` (dy) and
``2t+1`` (dx) for tap ``t = i*K + j``, ``mask [B, K*K, Ho, Wo]`` (after
the sigmoid), ``weight [Cout, Cin, K, K]``.  The sampler reads x as NHWC
and the columns are JAX's layout ``[B*Ho*Wo, K*K*Cin]`` (column
``t*Cin + c``), so the GEMM ``cols @ weight[Cout, K*K*Cin]^T`` has leading
dimensions ``K*K*Cin`` and ``Cout`` (multiples of 8 at yolact_plus_base,
which cuBLAS's aligned kernels need) and lands in NHWC:
:func:`deform_conv2d` returns it as a ``channels_last`` view of
``[B, Cout, Ho, Wo]``.

Rounding follows the JAX sampler (``_bilinear_gather_block``): the corner
weights ``wy * wx * valid`` are float32 and cast to the input dtype, each
corner value times its weight is one product in that dtype, the four
products are summed in float32 in corner order (top-left, top-right,
bottom-left, bottom-right) and rounded once to the input dtype, as
``jnp.sum`` does for bfloat16, and the sum is multiplied by the mask cast
to that dtype.  Validity is tested on
the integer corner indices; an invalid corner reads the clamped pixel and
weighs it by exactly 0, as ``_bilinear_gather_rows`` does once XLA has
turned its ``* valid`` into a select.  Non-finite offsets behave as in
JAX: XLA converts a NaN floor to the integer 0, so a NaN coordinate has
corners inside the map and NaN weights (NaN columns), while an infinite
one has every corner outside (zero columns).  The sample grid is
computed in float32 (JAX builds it in the input dtype, which is exact for
maps under 256 pixels, every map of the YOLACT++ configs).

:func:`dcn_columns` and :func:`deform_conv2d` take the plain version only
for tensors on the CPU.  For CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from yolact_tpu_torch.kernels import _build

launches = 0        # kernel launches by dcn_columns since import / reset

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def out_size(size: int, k: int, stride: int, padding: int,
             dilation: int) -> int:
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def _check(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
           k: int, stride: int, padding: int, dilation: int):
    """Shapes, dtypes and layouts both versions take; returns (ho, wo)."""
    if x.dim() != 4:
        raise ValueError(f'dcn: x must be [B, Cin, H, W], got '
                         f'{tuple(x.shape)}')
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f'dcn: x dtype {x.dtype} is not float32 or bfloat16')
    if offset.dtype != torch.float32:
        raise ValueError(f'dcn: offset must be float32, got {offset.dtype}')
    if not mask.is_floating_point():
        raise ValueError(f'dcn: mask must be floating point, got {mask.dtype}')
    if min(k, stride, dilation) < 1 or padding < 0:
        raise ValueError(f'dcn: bad geometry k={k} stride={stride} '
                         f'padding={padding} dilation={dilation}')
    b, _, h, w = x.shape
    ho, wo = (out_size(n, k, stride, padding, dilation) for n in (h, w))
    if tuple(offset.shape) != (b, 2 * k * k, ho, wo):
        raise ValueError(f'dcn: offset must be {(b, 2 * k * k, ho, wo)}, got '
                         f'{tuple(offset.shape)}')
    if tuple(mask.shape) != (b, k * k, ho, wo):
        raise ValueError(f'dcn: mask must be {(b, k * k, ho, wo)}, got '
                         f'{tuple(mask.shape)}')
    if not ((x.is_contiguous()
             or x.is_contiguous(memory_format=torch.channels_last))
            and offset.is_contiguous() and mask.is_contiguous()):
        raise ValueError('dcn: x must be contiguous or channels_last, '
                         'offset and mask contiguous')
    if not (x.device == offset.device == mask.device):
        raise ValueError('dcn: inputs on different devices')
    return ho, wo


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H, W, C] contiguous: a view of a channels_last
    tensor, one copy of a contiguous one."""
    return x.permute(0, 2, 3, 1).contiguous()


def _corner_index(f: torch.Tensor, n: int) -> torch.Tensor:
    """floor(coordinate) as an integer, clamped to [-2, n] first (every
    corner beyond stays invalid, and no conversion overflows); NaN maps
    to 0, as XLA converts it."""
    return torch.nan_to_num(f, nan=0.0).clamp(-2, n).to(torch.int64)


def bilinear_sample_plain(x: torch.Tensor, ys: torch.Tensor,
                          xs: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C]; ys, xs [B, N] float32 pixel coordinates ->
    [B, N, C] in x's dtype: per-corner zero-outside bilinear samples (the
    signature of JAX's samplers)."""
    b, h, w, c = x.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1
    y0i = _corner_index(y0, h)
    x0i = _corner_index(x0, w)
    flat = x.reshape(b, h * w, c)
    out = None
    for dy, wy in ((0, wy0), (1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            yi = y0i + dy
            xi = x0i + dx
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            g = torch.gather(flat, 1, idx[:, :, None].expand(b, -1, c))
            weight = torch.where(valid, wy * wx, 0.0).to(x.dtype)
            term = (g * weight[:, :, None]).float()
            out = term if out is None else out + term
    return out.to(x.dtype)


def dcn_columns_plain(x: torch.Tensor, offset: torch.Tensor,
                      mask: torch.Tensor, k: int = 3, stride: int = 1,
                      padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """Modulated im2col columns [B*Ho*Wo, K*K*Cin] in x's dtype, column
    t*Cin + c."""
    ho, wo = _check(x, offset, mask, k, stride, padding, dilation)
    b, cin = x.shape[:2]
    kk = k * k
    dev = x.device
    tap = torch.arange(kk, device=dev)
    base_y = ((torch.arange(ho, device=dev) * stride - padding)[:, None, None]
              + (tap // k * dilation)[None, None, :]).float()  # [Ho, 1, KK]
    base_x = ((torch.arange(wo, device=dev) * stride - padding)[None, :, None]
              + (tap % k * dilation)[None, None, :]).float()  # [1, Wo, KK]
    off = offset.view(b, kk, 2, ho, wo).permute(0, 3, 4, 1, 2)
    ys = (base_y + off[..., 0]).reshape(b, ho * wo * kk)
    xs = (base_x + off[..., 1]).reshape(b, ho * wo * kk)
    cols = bilinear_sample_plain(_nhwc(x), ys, xs).view(b, ho * wo, kk, cin)
    m = mask.to(x.dtype).view(b, kk, ho * wo).transpose(1, 2)
    cols = cols * m[:, :, :, None]
    return cols.view(b * ho * wo, kk * cin)


def dcn_columns(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                k: int = 3, stride: int = 1, padding: int = 1,
                dilation: int = 1) -> torch.Tensor:
    """Same contract as :func:`dcn_columns_plain`; the CUDA kernel for
    CUDA tensors."""
    if x.device.type == 'cpu':
        return dcn_columns_plain(x, offset, mask, k, stride, padding,
                                 dilation)
    if x.device.type != 'cuda':
        raise ValueError(f'dcn_columns: unsupported device {x.device}')
    ho, wo = _check(x, offset, mask, k, stride, padding, dilation)
    b, cin, h, w = x.shape
    xh = _nhwc(x)
    mask = mask.to(x.dtype).contiguous()
    cols = torch.empty((b * ho * wo, k * k * cin), dtype=x.dtype,
                       device=x.device)
    if cols.numel() == 0:
        return cols
    lib = _build.load()
    global launches
    _build.check(lib.yolact_dcn_im2col(
        xh.data_ptr(), offset.data_ptr(), mask.data_ptr(), cols.data_ptr(),
        _DTYPE_CODES[x.dtype], b, cin, h, w, ho, wo, k, stride, padding,
        dilation, _build.stream_ptr(x.device)), 'yolact_dcn_im2col')
    launches += 1
    return cols


def _gemm(cols: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], b: int, ho: int,
          wo: int) -> torch.Tensor:
    """cols [B*Ho*Wo, K*K*Cin] @ weight [Cout, K*K*Cin]^T (float32
    accumulation, rounded to the columns' dtype), plus the bias: JAX's
    ``dot_general``.  Returns [B, Cout, Ho, Wo] as a channels_last view."""
    cout = weight.shape[0]
    w = weight.permute(0, 2, 3, 1).reshape(cout, -1).to(cols.dtype)
    out = torch.matmul(cols, w.t())
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.view(b, ho, wo, cout).permute(0, 3, 1, 2)


def deform_conv2d_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, stride: int = 1,
                        padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """DCNv2 forward -> [B, Cout, Ho, Wo] (channels_last) in x's dtype, all
    plain PyTorch."""
    k = weight.shape[-1]
    cols = dcn_columns_plain(x, offset, mask, k, stride, padding, dilation)
    return _gemm(cols, weight, bias, x.shape[0], *offset.shape[-2:])


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: int = 1, padding: int = 1,
                  dilation: int = 1) -> torch.Tensor:
    """Same contract as :func:`deform_conv2d_plain`; the columns come from
    the CUDA kernel for CUDA tensors."""
    k = weight.shape[-1]
    cols = dcn_columns(x, offset, mask, k, stride, padding, dilation)
    return _gemm(cols, weight, bias, x.shape[0], *offset.shape[-2:])
