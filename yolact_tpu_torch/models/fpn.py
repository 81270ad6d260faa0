"""Feature Pyramid Network, NCHW.  Port of ``yolact_tpu/models/fpn.py``.

1x1 lateral convs with top-down accumulation, 3x3 pred convs (+ReLU), then
stride-2 3x3 downsample convs (or stride-2 subsampling).  The reference
stores the lateral and pred convs reversed: ``lat_layers[i]`` is applied to
level ``n-1-i``.  The FPN only upsamples, so ``F.interpolate`` (bilinear,
``align_corners=False``) equals the JAX package's ``jax.image.resize``.

The wiring is ``forward_rows``, which runs on a rank's rows of each level
under a spatial split (``parallel/mesh.py``), or on whole maps: the resize
to each lateral's global size reads its source rows across ranks
(``models/layers.py:resize_rows``), the 3x3 convs fetch their halos, and
the stride-2 subsampling of an FPN without downsample convs, a 1x1
stride-2 pool, fetches its rows.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolact_tpu_torch.config import FPNConfig
from yolact_tpu_torch.models.layers import (Conv2d, conv_rows, height,
                                            max_pool_rows, resize_rows)
from yolact_tpu_torch.parallel.mesh import Rows


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
        return self.forward_rows(convouts, [None] * len(convouts))[0]

    def forward_rows(self, convouts: Sequence[torch.Tensor],
                     rows: Sequence[Optional[Rows]]
                     ) -> Tuple[Tuple[torch.Tensor, ...],
                                Tuple[Optional[Rows], ...]]:
        """:meth:`forward` on a rank's rows of each level (`rows`: each
        level's :class:`Rows`, or None for whole maps), with each output's
        rows."""
        fc = self.cfg
        n = len(convouts)
        out: List[torch.Tensor] = [None] * n
        out_rows: List[Optional[Rows]] = list(rows)
        x = None
        for i in range(n):
            j = n - 1 - i
            lat, r = conv_rows(self.lat_layers[i], convouts[j], rows[j])
            if x is not None:
                size = (height(convouts[j], rows[j]), convouts[j].shape[3])
                x = resize_rows(x, out_rows[j + 1], size,
                                fc.interpolation_mode)[0] + lat
            else:
                x = lat
            out[j], out_rows[j] = x, r

        for i in range(n):
            j = n - 1 - i
            y, out_rows[j] = conv_rows(self.pred_layers[i], out[j],
                                       out_rows[j])
            out[j] = F.relu(y) if fc.relu_pred_layers else y

        cur = len(out)
        if fc.use_conv_downsample:
            for layer in self.downsample_layers:
                y, r = conv_rows(layer, out[-1], out_rows[-1])
                out.append(y)
                out_rows.append(r)
        else:
            for _ in range(fc.num_downsample):
                # x[:, :, ::2, ::2], a 1x1 stride-2 window
                y, r = max_pool_rows(out[-1], out_rows[-1], 1, 2)
                out.append(y)
                out_rows.append(r)

        if fc.relu_downsample_layers:
            # reference quirk: the relu'd downsample outputs overwrite
            # pyramid slots 0..num_downsample-1
            for i in range(len(out) - cur):
                out[i] = F.relu(out[cur + i])
                out_rows[i] = out_rows[cur + i]
        return tuple(out), tuple(out_rows)
