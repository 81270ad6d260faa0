"""Deformable position-sensitive RoI pooling (DCNv2), plain PyTorch.

Port of ``yolact_tpu/kernels/psroi.py`` (``deform_psroi_pool``,
``DeformRoIPooling``), which stands for the reference's CUDA kernel
``DeformablePSROIPoolForwardKernel`` and its wrappers ``DCNv2Pooling`` /
``DCNPooling``.  No YOLACT config uses it: it ships with the DCNv2
extension and is kept for component parity.  The JAX function is XLA, not
Pallas, so this is no CUDA kernel either: every tap of every output
element becomes one flat index into the ``[B*H*W*C]`` input, read by one
gather and reduced by a masked mean, as JAX's ``tap`` does; autograd gives
the gradients (the bilinear weights carry the coordinate gradient).

Semantics (the JAX module's, from the reference's ``.cu``):

* RoI coordinates are rounded to integers, the end is inclusive (+1), then
  scaled by ``spatial_scale`` and shifted by -0.5;
* a RoI is at least 0.1 px wide and high;
* taps outside ``[-0.5, dim - 0.5]`` are skipped; a bin is the mean of its
  surviving taps, 0 when none survive;
* output channel ``ctop`` at bin (ph, pw) reads input channel
  ``(ctop * G + gh) * G + gw`` with ``g* = floor(p* * G / P)``;
* the per-part translation ``trans`` is scaled by ``trans_std`` and by the
  RoI's size.

Layouts are JAX's: ``x`` NHWC, ``rois [N, 5]`` rows (batch index, x1, y1,
x2, y2) in image coordinates, ``trans [N, 2 * num_classes, part, part]``;
the result is ``[N, output_dim, P, P]`` float32.  Coordinates are float32
whatever x's dtype, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn


def deform_psroi_pool(x: torch.Tensor, rois: torch.Tensor,
                      trans: Optional[torch.Tensor], *, spatial_scale: float,
                      pooled_size: int, output_dim: int, no_trans: bool,
                      group_size: int = 1, part_size: Optional[int] = None,
                      sample_per_part: int = 4,
                      trans_std: float = 0.0) -> torch.Tensor:
    """x [B, H, W, C] with C == output_dim * group_size**2; rois [N, 5];
    trans [N, 2 * num_classes, part, part] or None (no_trans) ->
    [N, output_dim, pooled_size, pooled_size] float32."""
    _, H, W, C = x.shape
    N = rois.shape[0]
    P, S, G = pooled_size, sample_per_part, group_size
    part = P if part_size is None else part_size
    if C != output_dim * G * G:
        raise ValueError(f'C={C} != output_dim*group_size^2='
                         f'{output_dim * G * G}')
    num_classes = 1 if no_trans else trans.shape[1] // 2
    if output_dim % num_classes:
        raise ValueError('output_dim must be divisible by num_classes')
    f32 = torch.float32
    dev = x.device

    batch_ind = rois[:, 0].to(torch.int64)                       # [N]
    r = torch.round(rois[:, 1:].to(f32))
    roi_sw = r[:, 0] * spatial_scale - 0.5
    roi_sh = r[:, 1] * spatial_scale - 0.5
    roi_ew = (r[:, 2] + 1.0) * spatial_scale - 0.5
    roi_eh = (r[:, 3] + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp(roi_ew - roi_sw, min=0.1)
    roi_h = torch.clamp(roi_eh - roi_sh, min=0.1)
    bin_w, bin_h = roi_w / P, roi_h / P
    sub_w, sub_h = bin_w / S, bin_h / S

    # static per-bin tables, computed as JAX's numpy does
    p_idx = np.arange(P)
    part_hw = torch.as_tensor(np.floor(p_idx / P * part).astype(np.int64),
                              device=dev)                        # [P]
    g_idx = torch.as_tensor(np.clip(np.floor(p_idx * G / P), 0, G - 1)
                            .astype(np.int64), device=dev)

    if no_trans:
        tx = ty = torch.zeros((N, 1, P, P), dtype=f32, device=dev)
    else:
        t = trans.to(f32).reshape(N, num_classes, 2, part, part)
        t = t[:, :, :, part_hw[:, None], part_hw[None, :]]   # [N,cls,2,P,P]
        tx = t[:, :, 0] * trans_std
        ty = t[:, :, 1] * trans_std

    def col(v):                                                  # [N] -> 4-D
        return v[:, None, None, None]

    p_f = torch.arange(P, device=dev, dtype=f32)
    wstart = p_f[None, None, None, :] * col(bin_w) + col(roi_sw) \
        + tx * col(roi_w)                                        # [N,cls,P,P]
    hstart = p_f[None, None, :, None] * col(bin_h) + col(roi_sh) \
        + ty * col(roi_h)
    s_f = torch.arange(S, device=dev, dtype=f32)
    ws = wstart[..., None, None] + s_f * col(sub_w)[..., None, None]
    hs = hstart[..., None, None] + s_f[:, None] * col(sub_h)[..., None, None]

    valid = (ws >= -0.5) & (ws <= W - 0.5) & (hs >= -0.5) & (hs <= H - 0.5)
    ws = ws.clamp(0.0, W - 1.0)
    hs = hs.clamp(0.0, H - 1.0)

    # the class of each output channel, and its position-sensitive channel
    d_idx = torch.arange(output_dim, device=dev)
    cls_of_ctop = d_idx // (output_dim // num_classes)           # [D]
    chan = (d_idx[:, None, None] * G + g_idx[None, :, None]) * G \
        + g_idx[None, None, :]                                   # [D,P,P]
    ws, hs, valid = (v[:, cls_of_ctop] for v in (ws, hs, valid))

    x0, y0 = torch.floor(ws), torch.floor(hs)
    x1, y1 = torch.ceil(ws), torch.ceil(hs)
    dx, dy = ws - x0, hs - y0
    flat = x.reshape(-1)
    base = batch_ind[:, None, None, None, None, None] * H
    chan_b = chan[None, :, :, :, None, None]

    def tap(yi, xi, wgt):
        idx = ((base + yi.to(torch.int64)) * W + xi.to(torch.int64)) * C \
            + chan_b
        return flat[idx] * wgt.to(x.dtype)

    val = (tap(y0, x0, (1 - dx) * (1 - dy)) + tap(y1, x0, (1 - dx) * dy)
           + tap(y0, x1, dx * (1 - dy)) + tap(y1, x1, dx * dy))
    val = torch.where(valid, val.to(f32), 0.0)                  # [N,D,P,P,S,S]
    cnt = valid.flatten(4).sum(-1)                               # [N,D,P,P]
    total = val.flatten(4).sum(-1)
    return torch.where(cnt > 0, total / cnt.clamp(min=1), 0.0)


def _lecun_normal_(weight: torch.Tensor) -> None:
    """flax's Dense default: a truncated normal at +-2 std, rescaled to the
    variance 1 / fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / .87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class DeformRoIPooling(nn.Module):
    """``DCNPooling`` (JAX's ``DeformRoIPooling``): a plain no-trans PSRoI
    pass feeds a 3-layer FC that predicts a per-bin (offset, mask); a
    second, deformable pass applies them and is modulated by
    sigmoid(mask).  The FC is the reference's ``offset_mask_fc``
    Sequential (Linear, ReLU, Linear, ReLU, Linear: flax's
    ``offset_mask_fc_0/2/4``); its last Linear starts at zero, so the
    module starts as 0.5 times plain PSRoI pooling."""

    def __init__(self, spatial_scale: float, pooled_size: int,
                 output_dim: int, no_trans: bool = False, group_size: int = 1,
                 part_size: Optional[int] = None, sample_per_part: int = 4,
                 trans_std: float = 0.0, deform_fc_dim: int = 1024):
        super().__init__()
        self.no_trans = no_trans
        self.pool_kw = dict(spatial_scale=spatial_scale,
                            pooled_size=pooled_size, output_dim=output_dim,
                            group_size=group_size, part_size=part_size,
                            sample_per_part=sample_per_part,
                            trans_std=trans_std)
        if no_trans:
            return
        P = pooled_size
        self.offset_mask_fc = nn.Sequential(
            nn.Linear(output_dim * P * P, deform_fc_dim), nn.ReLU(),
            nn.Linear(deform_fc_dim, deform_fc_dim), nn.ReLU(),
            nn.Linear(deform_fc_dim, P * P * 3))
        with torch.no_grad():
            for i in (0, 2):
                _lecun_normal_(self.offset_mask_fc[i].weight)
                self.offset_mask_fc[i].bias.zero_()
            self.offset_mask_fc[4].weight.zero_()
            self.offset_mask_fc[4].bias.zero_()

    def forward(self, x: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        roi = deform_psroi_pool(x, rois, None, no_trans=True, **self.pool_kw)
        if self.no_trans:
            return roi
        n, P = rois.shape[0], self.pool_kw['pooled_size']
        h = self.offset_mask_fc(roi.reshape(n, -1)).reshape(n, 3, P, P)
        out = deform_psroi_pool(x, rois, h[:, :2], no_trans=False,
                                **self.pool_kw)
        return out * torch.sigmoid(h[:, 2:3])
