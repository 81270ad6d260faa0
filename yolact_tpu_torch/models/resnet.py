"""ResNet backbone (bottleneck blocks, batch norm), NCHW.

Port of ``yolact_tpu/models/resnet.py`` (``Bottleneck``, ``_stage_plan``,
``ResNetBackbone``) with the reference's parameter names
(``layers.{stage}.{block}.conv1.weight``, ``...downsample.0.weight``).
Atrous stages and SSD-style extra stages are kept.  DCNv2 stages are
YOLACT++ (ROADMAP A7) and group norm is ResNet-GN (ROADMAP A8): both
raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolact_tpu_torch.models.layers import BatchNorm2d, max_pool

EXPANSION = 4


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 with identity or projection
    residual."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False,
                               dilation=dilation)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * EXPANSION, 1, bias=False,
                               dilation=dilation)
        self.bn3 = BatchNorm2d(planes * EXPANSION)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * EXPANSION, 1, stride=stride,
                      bias=False, dilation=dilation),
            BatchNorm2d(planes * EXPANSION)) if has_downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


def _stage_plan(layers: Sequence[int], dcn_layers: Sequence[int],
                dcn_interval: int, atrous_layers: Sequence[int],
                extra_stages: int) -> Tuple[Tuple[dict, ...], ...]:
    """Static plan of all bottleneck blocks, as the JAX package's
    ``_stage_plan`` (dilation accumulates over atrous stages)."""
    plans = []
    inplanes = 64
    dilation = 1
    all_planes = [64, 128, 256, 512] + [1024 // EXPANSION] * extra_stages
    all_blocks = list(layers) + [1] * extra_stages
    all_dcn = list(dcn_layers) + [0] * (len(all_blocks) - len(dcn_layers))

    for stage_idx, (planes, blocks) in enumerate(zip(all_planes, all_blocks)):
        stride = 1 if stage_idx == 0 else 2
        dcn_budget = all_dcn[stage_idx]
        has_ds = stride != 1 or inplanes != planes * EXPANSION
        if has_ds and stage_idx in atrous_layers:
            dilation += 1
            stride = 1
        stage = [dict(inplanes=inplanes, planes=planes, stride=stride,
                      dilation=dilation, use_dcn=dcn_budget >= blocks,
                      has_downsample=has_ds)]
        inplanes = planes * EXPANSION
        for i in range(1, blocks):
            # the reference gives the accumulated dilation ONLY to block 0;
            # blocks i > 0 use the Bottleneck default dilation=1
            stage.append(dict(
                inplanes=inplanes, planes=planes, stride=1, dilation=1,
                use_dcn=((i + dcn_budget) >= blocks) and i % dcn_interval == 0,
                has_downsample=False))
        plans.append(tuple(stage))
    return tuple(plans)


class ResNetBackbone(nn.Module):
    """Returns one feature map per stage (C2..C5 [+ extra stages])."""

    def __init__(self, layers: Sequence[int],
                 dcn_layers: Sequence[int] = (0, 0, 0, 0),
                 dcn_interval: int = 1, atrous_layers: Sequence[int] = (),
                 num_stages: Optional[int] = None):
        super().__init__()
        extra = max(0, (num_stages or len(layers)) - len(layers))
        plans = _stage_plan(layers, dcn_layers, dcn_interval, atrous_layers,
                            extra)
        if any(blk['use_dcn'] for stage in plans for blk in stage):
            raise NotImplementedError(
                'DCNv2 backbone stages (YOLACT++) are not ported yet '
                '(ROADMAP A7)')
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.layers = nn.ModuleList(
            nn.Sequential(*[Bottleneck(**{k: v for k, v in blk.items()
                                          if k != 'use_dcn'})
                            for blk in stage])
            for stage in plans)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool(x, 3, 2, 1)
        outs = []
        for stage in self.layers:
            x = stage(x)
            outs.append(x)
        return tuple(outs)
