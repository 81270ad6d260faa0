"""DarkNet-53 backbone (YOLOv3), NCHW.

Port of ``yolact_tpu/models/darknet.py`` with the reference's parameter
names (``backbone.py:222-318``), which JAX's importer reads
(``yolact_tpu/convert/torch_import.py:150-175``): ``_preconv.{0,1}`` (conv,
batch norm), ``layers.{s}.0.{0,1}`` (the stage-opening stride-2 conv) and
``layers.{s}.{b}.conv{1,2}.{0,1}`` (the residual blocks).

Each module's wiring is its ``forward_rows``, which runs on a rank's rows
of a map split by height over a spatial mesh (``parallel/mesh.py``), the
convs fetching their halos (``models/layers.py:conv_rows``), or on the
whole map (``rows`` None, which ``forward`` passes).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolact_tpu_torch.models.layers import BatchNorm2d, Conv2d, conv_rows
from yolact_tpu_torch.parallel.mesh import Rows


class DarkConv(nn.Sequential):
    """conv (no bias) -> batch norm -> LeakyReLU(0.1), as the reference's
    ``Sequential`` (so its parameters are ``0.weight`` and ``1.*``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0):
        super().__init__(
            Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                   padding=padding, bias=False),
            BatchNorm2d(out_channels))

    def forward(self, x: torch.Tensor, bn_train: bool = False
                ) -> torch.Tensor:
        return self.forward_rows(x, None, bn_train)[0]

    def forward_rows(self, x: torch.Tensor, rows: Optional[Rows],
                     bn_train: bool = False
                     ) -> Tuple[torch.Tensor, Optional[Rows]]:
        y, r = conv_rows(self[0], x, rows)
        return F.leaky_relu(self[1](y, bn_train, r), 0.1), r


class DarkBlock(nn.Module):
    """Residual 1x1 squeeze -> 3x3 expand block, expansion 2."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = DarkConv(channels * 2, channels, 1)
        self.conv2 = DarkConv(channels, channels * 2, 3, padding=1)

    def forward(self, x: torch.Tensor, bn_train: bool = False
                ) -> torch.Tensor:
        return self.forward_rows(x, None, bn_train)[0]

    def forward_rows(self, x: torch.Tensor, rows: Optional[Rows],
                     bn_train: bool = False
                     ) -> Tuple[torch.Tensor, Optional[Rows]]:
        y, r = self.conv1.forward_rows(x, rows, bn_train)
        y, r = self.conv2.forward_rows(y, r, bn_train)
        return y + x, r


class DarkNetBackbone(nn.Module):
    """Returns one feature map per stage.  Each stage opens with a stride-2
    3x3 conv that doubles its base channels (32, 64, 128, 256, 512), then
    ``n`` residual blocks; stages beyond ``layers`` (``num_stages``) are
    512-channel stages of one block.  ``use_kernels`` and ``remat`` are
    accepted for the ResNet call signature and change nothing (JAX applies
    ``train_remat`` to ResNets only)."""

    def __init__(self, layers: Sequence[int] = (1, 2, 8, 8, 4),
                 num_stages: Optional[int] = None):
        super().__init__()
        extra = max(0, (num_stages or len(layers)) - len(layers))
        channels = (32, 64, 128, 256, 512)[:len(layers)] + (512,) * extra
        blocks = tuple(layers) + (1,) * extra
        self._preconv = DarkConv(3, 32, 3, padding=1)
        stages = []
        cin = 32
        for ch, n in zip(channels, blocks):
            stages.append(nn.ModuleList(
                [DarkConv(cin, ch * 2, 3, stride=2, padding=1)]
                + [DarkBlock(ch) for _ in range(n)]))
            cin = ch * 2
        self.layers = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor, use_kernels: bool = True,
                bn_train: bool = False,
                remat: str = 'none') -> Tuple[torch.Tensor, ...]:
        return self.forward_rows(x, None, use_kernels, bn_train, remat)[0]

    def forward_rows(self, x: torch.Tensor, rows: Optional[Rows],
                     use_kernels: bool = True, bn_train: bool = False,
                     remat: str = 'none'
                     ) -> Tuple[Tuple[torch.Tensor, ...],
                                Tuple[Optional[Rows], ...]]:
        """:meth:`forward` on a rank's rows of the input (`rows`; None:
        the whole input), with each output's rows."""
        x, r = self._preconv.forward_rows(x, rows, bn_train)
        outs, heights = [], []
        for stage in self.layers:
            for block in stage:
                x, r = block.forward_rows(x, r, bn_train)
            outs.append(x)
            heights.append(r)
        return tuple(outs), tuple(heights)
