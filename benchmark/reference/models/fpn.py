"""Feature Pyramid Network, NCHW.  Port of ``yolact_tpu/models/fpn.py``.

1x1 lateral convs with top-down accumulation, 3x3 pred convs (+ReLU), then
stride-2 3x3 downsample convs (or stride-2 subsampling).  The reference
stores the lateral and pred convs reversed: ``lat_layers[i]`` is applied to
level ``n-1-i``.  The FPN only upsamples, so ``F.interpolate`` (bilinear,
``align_corners=False``) equals the JAX package's ``jax.image.resize``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.config import FPNConfig
from benchmark.reference.models.layers import Conv2d, max_pool


class FPN(nn.Module):
    def __init__(self, cfg: FPNConfig, in_channels: Sequence[int]):
        super().__init__()
        self.cfg = cfg
        nf = cfg.num_features
        pad = 1 if cfg.pad else 0
        self.lat_layers = nn.ModuleList(
            Conv2d(c, nf, 1) for c in reversed(in_channels))
        self.pred_layers = nn.ModuleList(
            Conv2d(nf, nf, 3, padding=pad) for _ in in_channels)
        self.downsample_layers = nn.ModuleList(
            Conv2d(nf, nf, 3, stride=2, padding=1)
            for _ in range(cfg.num_downsample if cfg.use_conv_downsample
                           else 0))

    def forward(self, convouts: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        fc = self.cfg
        if fc.interpolation_mode not in ('bilinear', 'nearest'):
            raise NotImplementedError(
                f'resize mode {fc.interpolation_mode!r}')
        kw = ({'align_corners': False}
              if fc.interpolation_mode == 'bilinear' else {})
        n = len(convouts)
        out: List[torch.Tensor] = [None] * n
        x = None
        for i in range(n):
            j = n - 1 - i
            lat = self.lat_layers[i](convouts[j])
            if x is not None:
                x = F.interpolate(x, size=tuple(convouts[j].shape[2:]),
                                  mode=fc.interpolation_mode, **kw) + lat
            else:
                x = lat
            out[j] = x

        for i in range(n):
            j = n - 1 - i
            y = self.pred_layers[i](out[j])
            out[j] = F.relu(y) if fc.relu_pred_layers else y

        cur = len(out)
        if fc.use_conv_downsample:
            for layer in self.downsample_layers:
                out.append(layer(out[-1]))
        else:
            for _ in range(fc.num_downsample):
                # x[:, :, ::2, ::2], a 1x1 stride-2 window
                out.append(max_pool(out[-1], 1, 2))

        if fc.relu_downsample_layers:
            # reference quirk: the relu'd downsample outputs overwrite
            # pyramid slots 0..num_downsample-1
            for i in range(len(out) - cur):
                out[i] = F.relu(out[cur + i])
        return tuple(out)
