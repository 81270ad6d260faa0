"""Prototype network and prediction head, NCHW.

Port of ``yolact_tpu/models/heads.py`` (``ProtoNet``, ``PredictionHead``,
``FastMaskIoUNet``).  Parameter names are the reference's
(``proto_net.{i}``, ``upfeature.{i}``, ``bbox_layer``, ``conf_layer``,
``mask_layer``, ``maskiou_net.{i}``, ...).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from yolact_tpu_torch.config import YolactConfig
from yolact_tpu_torch.models.layers import Conv2d, make_net


def _activation(name: str):
    return {
        'tanh': torch.tanh,
        'sigmoid': torch.sigmoid,
        'relu': F.relu,
        'softmax': lambda x: torch.softmax(x, dim=-1),
        'none': lambda x: x,
    }[name]


class ProtoNet(nn.Sequential):
    """Mask prototype network.  An ``nn.Sequential`` of the make_net spec
    (so its parameters are ``proto_net.{i}``), followed by the prototype
    activation.  NCHW in, NCHW out."""

    def __init__(self, cfg: YolactConfig, in_channels: int):
        if cfg.mask_proto_use_grid or cfg.mask_proto_bias:
            raise NotImplementedError(
                'mask_proto_use_grid / mask_proto_bias are not ported')
        net, _ = make_net(in_channels, cfg.mask_proto_net,
                          include_last_relu=False)
        super().__init__(*net)
        self.activation = cfg.mask_proto_prototype_activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _activation(self.activation)(super().forward(x))


def _flatten(y: torch.Tensor, last: int) -> torch.Tensor:
    """[B, A*last, H, W] conv output -> [B, H*W*A, last], the JAX NHWC
    flatten order."""
    return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, last)


# PredictionHead options of other configs that the port does not build yet
_UNPORTED_HEAD_OPTIONS = ('use_prediction_module', 'use_yolo_regressors',
                          'mask_proto_coeff_gate', 'use_mask_scoring',
                          'use_instance_coeff',
                          'mask_proto_split_prototypes_by_head')


class PredictionHead(nn.Module):
    """Head producing (loc, conf, mask-coeff) per anchor."""

    def __init__(self, cfg: YolactConfig, in_channels: int, num_priors: int):
        super().__init__()
        unported = [n for n in _UNPORTED_HEAD_OPTIONS if getattr(cfg, n)]
        if unported:
            raise NotImplementedError(f'head options not ported: {unported}')
        self.cfg = cfg
        self.mask_dim = cfg.mask_dim

        ch = in_channels
        self.upfeature = None
        if cfg.extra_head_net is not None:
            self.upfeature, ch = make_net(ch, cfg.extra_head_net,
                                          include_last_relu=True)

        def extra(n_layers):
            mods = []
            for _ in range(n_layers):
                mods += [Conv2d(ch, ch, 3, padding=1), nn.ReLU()]
            return nn.Sequential(*mods)

        self.bbox_extra, self.conf_extra, self.mask_extra = (
            extra(n) for n in cfg.extra_layers)

        hp = cfg.head_layer_params_dict
        k, p = hp.get('kernel_size', 3), hp.get('padding', 0)
        self.bbox_layer = Conv2d(ch, num_priors * 4, k, padding=p)
        self.conf_layer = Conv2d(ch, num_priors * cfg.num_classes, k,
                                 padding=p)
        if cfg.eval_mask_branch:
            self.mask_layer = Conv2d(ch, num_priors * self.mask_dim, k,
                                     padding=p)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if self.upfeature is not None:
            x = self.upfeature(x)
        bbox = _flatten(self.bbox_layer(self.bbox_extra(x)), 4)
        conf = _flatten(self.conf_layer(self.conf_extra(x)), cfg.num_classes)
        if cfg.eval_mask_branch:
            mask = _activation(cfg.mask_proto_coeff_activation)(
                _flatten(self.mask_layer(self.mask_extra(x)), self.mask_dim))
        else:
            # box-only mode: zero coefficients keep the output shapes
            mask = bbox.new_zeros((bbox.shape[0], bbox.shape[1],
                                   self.mask_dim))
        return {'loc': bbox, 'conf': conf, 'mask': mask}


class FastMaskIoUNet(nn.Module):
    """YOLACT++ mask scorer: a small convnet over assembled masks, then a
    global max.  Input [N, 1, H, W], output [N, num_classes - 1].  Its
    parameters are ``maskiou_net.{i}``."""

    def __init__(self, cfg: YolactConfig):
        super().__init__()
        spec = tuple(cfg.maskiou_net) + ((cfg.num_classes - 1, 1, ()),)
        self.maskiou_net, _ = make_net(1, spec, include_last_relu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maskiou_net(x).amax(dim=(2, 3))
