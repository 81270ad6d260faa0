"""DarkNet-53 backbone (YOLOv3, Redmon & Farhadi, arXiv:1804.02767), NCHW.

The plain form of dbolya/yolact ``backbone.py:222-318``
(``darknetconvlayer``, ``DarkNetBlock``, ``DarkNetBackbone``), with its
parameter names: ``_preconv.{0,1}`` (conv, batch norm), ``layers.{s}.0.{0,1}``
(the stage-opening stride-2 conv) and ``layers.{s}.{b}.conv{1,2}.{0,1}``
(the residual blocks), so that one state dict loads into this trunk and
into the port's.  Every conv is 3x3 or 1x1 without bias, followed by batch
norm and LeakyReLU(0.1).  Departures from dbolya/yolact:

* the activation is ``F.leaky_relu(x, 0.1)`` after the batch norm, not an
  in-place ``nn.LeakyReLU`` module at index 2 of each unit's
  ``Sequential`` (it holds no parameter, so the names are the same);
* batch norm is ``models/layers.py:BatchNorm2d`` (float32 statistics;
  ``bn_train`` runs it on the batch's, as the other families do);
* the SSD-style stages past the fifth (``add_layer``) are built from
  ``num_stages``: 1024-channel stages of one block, as ``add_layer``'s
  default ``conv_channels=1024`` gives;
* ``use_kernels`` and ``remat`` are accepted for the family's call
  signature and change nothing (no DarkNet layer has a kernel, and the
  JAX package applies ``train_remat`` to ResNets only); there is no
  ``backbone_modules`` / ``init_backbone`` (weights come from a seed);
* each block's last batch norm starts at weight ``RESIDUAL_BN_INIT``
  (0.45), not 1.  The benchmark's seeded weights keep every batch norm's
  own values (``benchmark/weights.py:init_state_dict``).  At 1 the 23
  residual branches pile up until the trunk barely depends on its frame:
  the conf logits change between two frames by 0.03 of their spread over
  priors (float32 at 550, 16 seeds), ResNet-101's by 0.12, so a stale
  answer or one dropped frame reads as correct.  At 0.45 the change is
  0.12.  A state dict loaded over the module replaces it.

The backbone family ``'darknet'`` (``config.backbone_family``):
:func:`build_backbone`, :func:`out_channels`, :func:`feature_sizes_1d`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models.layers import BatchNorm2d, Conv2d
from benchmark.reference.ops.anchors import conv_out

EXPANSION = 2
LEAKY_SLOPE = 0.1
# each residual branch's last batch-norm weight until a state dict is
# loaded (the module docstring)
RESIDUAL_BN_INIT = 0.45


class DarkConv(nn.Sequential):
    """``darknetconvlayer``: conv (no bias) -> batch norm ->
    LeakyReLU(0.1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0):
        super().__init__(
            Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                   padding=padding, bias=False),
            BatchNorm2d(out_channels))

    def forward(self, x: torch.Tensor, bn_train: bool = False
                ) -> torch.Tensor:
        return F.leaky_relu(self[1](self[0](x), bn_train), LEAKY_SLOPE)


class DarkBlock(nn.Module):
    """``DarkNetBlock``: a 1x1 squeeze to `channels`, a 3x3 expand back to
    ``EXPANSION * channels``, and the identity residual."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = DarkConv(channels * EXPANSION, channels, 1)
        self.conv2 = DarkConv(channels, channels * EXPANSION, 3, padding=1)
        with torch.no_grad():
            self.conv2[1].weight.fill_(RESIDUAL_BN_INIT)

    def forward(self, x: torch.Tensor, bn_train: bool = False
                ) -> torch.Tensor:
        return self.conv2(self.conv1(x, bn_train), bn_train) + x


class DarkNetBackbone(nn.Module):
    """``DarkNetBackbone``: a 3x3/s1 conv to 32 channels, then one stage a
    count of `layers`, each a stride-2 3x3 conv to twice its base channels
    (32, 64, 128, 256, 512) and that many :class:`DarkBlock`; stages past
    ``len(layers)`` up to `num_stages` are ``add_layer``'s (512 base
    channels, one block).  Returns one feature map a stage."""

    def __init__(self, layers: Sequence[int] = (1, 2, 8, 8, 4),
                 num_stages: Optional[int] = None):
        super().__init__()
        extra = max(0, (num_stages or len(layers)) - len(layers))
        channels = (32, 64, 128, 256, 512)[:len(layers)] + (512,) * extra
        blocks = tuple(layers) + (1,) * extra
        self._preconv = DarkConv(3, 32, 3, padding=1)
        self.layers = nn.ModuleList()
        cin = 32
        for ch, n in zip(channels, blocks):
            self.layers.append(nn.ModuleList(
                [DarkConv(cin, ch * EXPANSION, 3, stride=2, padding=1)]
                + [DarkBlock(ch) for _ in range(n)]))
            cin = ch * EXPANSION

    def forward(self, x: torch.Tensor, use_kernels: bool = True,
                bn_train: bool = False,
                remat: str = 'none') -> Tuple[torch.Tensor, ...]:
        x = self._preconv(x, bn_train)
        outs = []
        for stage in self.layers:
            for unit in stage:
                x = unit(x, bn_train)
            outs.append(x)
        return tuple(outs)


def build_backbone(cfg) -> DarkNetBackbone:
    """The DarkNet of ``cfg.backbone``: ``args[0]`` the blocks a stage,
    and as many stages as the selected layers reach."""
    bb = cfg.backbone
    layers = tuple(bb.args[0])
    return DarkNetBackbone(layers, num_stages=max(
        max(bb.selected_layers) + 1, len(layers)))


def out_channels(bb) -> Tuple[int, ...]:
    """Per-stage output channels: 64, 128, 256, 512, 1024 (expansion 2,
    ``backbone.py:252``), then 1024 a stage ``add_layer`` appends."""
    base = [64, 128, 256, 512, 1024]
    n_extra = max(bb.selected_layers) + 1 - len(base)
    return tuple(base + [1024] * max(0, n_extra))


def feature_sizes_1d(cfg, img: int) -> List[int]:
    """The size along one side after each stage, for an `img`-pixel side:
    the stride-1 pre-conv keeps it, each stage's 3x3/s2/p1 conv halves
    it, rounding up."""
    bb = cfg.backbone
    sizes = []
    for _ in range(max(max(bb.selected_layers) + 1, len(bb.args[0]))):
        img = conv_out(img, 3, 2, 1)
        sizes.append(img)
    return sizes
