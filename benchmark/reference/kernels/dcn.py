"""Frozen plain PyTorch copy of the port's DCNv2 forward
(``yolact_tpu_torch/kernels/dcn.py``): the plain version alone, under the
kernel's name, so the reference's model runs it wherever the port would
launch the kernel."""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference.precision import operands

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def out_size(size: int, k: int, stride: int, padding: int,
             dilation: int) -> int:
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def _check(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
           k: int, stride: int, padding: int, dilation: int,
           plain: bool = False):
    """Shapes, dtypes and layouts both versions take (`plain`: float64 x
    and offsets as well); returns (ho, wo)."""
    if x.dim() != 4:
        raise ValueError(f'dcn: x must be [B, Cin, H, W], got '
                         f'{tuple(x.shape)}')
    f64 = plain and x.dtype == offset.dtype == torch.float64
    if x.dtype not in _DTYPE_CODES and not f64:
        raise ValueError(f'dcn: x dtype {x.dtype} is not float32 or bfloat16')
    if offset.dtype != torch.float32 and not f64:
        raise ValueError(f'dcn: offset must be float32, got {offset.dtype}')
    if not mask.is_floating_point():
        raise ValueError(f'dcn: mask must be floating point, got {mask.dtype}')
    if min(k, stride, dilation) < 1 or padding < 0:
        raise ValueError(f'dcn: bad geometry k={k} stride={stride} '
                         f'padding={padding} dilation={dilation}')
    b, _, h, w = x.shape
    ho, wo = (out_size(n, k, stride, padding, dilation) for n in (h, w))
    if tuple(offset.shape) != (b, 2 * k * k, ho, wo):
        raise ValueError(f'dcn: offset must be {(b, 2 * k * k, ho, wo)}, '
                         f'got {tuple(offset.shape)}')
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
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    out = None
    for dy, wy in ((0, wy0), (1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            yi = y0i + dy
            xi = x0i + dx
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            g = torch.gather(flat, 1, idx[:, :, None].expand(b, -1, c))
            # the factors are selected, not the product: the same value,
            # and an invalid corner's inf or NaN factor sends no NaN back
            # through the product's gradient
            weight = (torch.where(valid, wy, 0.0)
                      * torch.where(valid, wx, 0.0)).to(x.dtype)
            term = (g * weight[:, :, None]).to(acc)
            out = term if out is None else out + term
    return out.to(x.dtype)


def dcn_columns_plain(x: torch.Tensor, offset: torch.Tensor,
                      mask: torch.Tensor, k: int = 3, stride: int = 1,
                      padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """Modulated im2col columns [B*Ho*Wo, K*K*Cin] in x's dtype, column
    t*Cin + c: output row i samples at ``i * stride - padding + ky *
    dilation`` plus the offset."""
    ho, wo = _check(x, offset, mask, k, stride, padding, dilation, plain=True)
    b, cin = x.shape[:2]
    kk = k * k
    dev = x.device
    tap = torch.arange(kk, device=dev)
    base_y = ((torch.arange(ho, device=dev) * stride
               - padding)[:, None, None]
              + (tap // k * dilation)[None, None, :]).to(offset.dtype)
    base_x = ((torch.arange(wo, device=dev) * stride - padding)[None, :, None]
              + (tap % k * dilation)[None, None, :]).to(offset.dtype)
    off = offset.view(b, kk, 2, ho, wo).permute(0, 3, 4, 1, 2)
    ys = (base_y + off[..., 0]).reshape(b, ho * wo * kk)
    xs = (base_x + off[..., 1]).reshape(b, ho * wo * kk)
    cols = bilinear_sample_plain(_nhwc(x), ys, xs).view(b, ho * wo, kk, cin)
    m = mask.to(x.dtype).view(b, kk, ho * wo).transpose(1, 2)
    cols = cols * m[:, :, :, None]
    return cols.view(b * ho * wo, kk * cin)


def _gemm(cols: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], b: int, ho: int,
          wo: int) -> torch.Tensor:
    """cols [B*Ho*Wo, K*K*Cin] @ weight [Cout, K*K*Cin]^T (float32
    accumulation, rounded to the columns' dtype), plus the bias: JAX's
    ``dot_general``.  Returns [B, Cout, Ho, Wo] as a channels_last view."""
    cout = weight.shape[0]
    w = weight.permute(0, 2, 3, 1).reshape(cout, -1).to(cols.dtype)
    cols, w = operands(cols, w)
    out = torch.matmul(cols, w.t())
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.view(b, ho, wo, cout).permute(0, 3, 1, 2)


def deform_conv2d_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, stride: int = 1,
                        padding: int = 1,
                        dilation: int = 1) -> torch.Tensor:
    """DCNv2 forward -> [B, Cout, Ho, Wo] (channels_last) in x's dtype, all
    plain PyTorch."""
    k = weight.shape[-1]
    cols = dcn_columns_plain(x, offset, mask, k, stride, padding, dilation)
    return _gemm(cols, weight, bias, x.shape[0], *offset.shape[-2:])


deform_conv2d = deform_conv2d_plain
