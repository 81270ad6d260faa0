"""Prototype network and prediction head, NCHW.

Port of ``yolact_tpu/models/heads.py`` (``ProtoNet``, ``PredictionHead``,
``FastMaskIoUNet``).  Parameter names are the reference's
(``proto_net.{i}``, ``upfeature.{i}``, ``block``, ``conv``, ``bn``,
``bbox_layer``, ``conf_layer``, ``mask_layer``, ``gate_layer``,
``score_layer``, ``inst_layer``, ``maskiou_net.{i}``, ...).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.config import MaskType, YolactConfig
from benchmark.reference.models.layers import BatchNorm2d, Conv2d, make_net
from benchmark.reference.models.resnet import Bottleneck


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
    activation.  NCHW in, NCHW out.  ``mask_proto_bias`` appends a channel
    of ones after the activation."""

    def __init__(self, cfg: YolactConfig, in_channels: int):
        if cfg.mask_proto_use_grid:
            raise NotImplementedError('mask_proto_use_grid')
        net, _ = make_net(in_channels, cfg.mask_proto_net,
                          include_last_relu=False)
        super().__init__(*net)
        self.activation = cfg.mask_proto_prototype_activation
        self.bias = cfg.mask_proto_bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _activation(self.activation)(super().forward(x))
        if self.bias:
            x = torch.cat([x, x.new_ones((x.shape[0], 1) + x.shape[2:])],
                          dim=1)
        return x


def _flatten(y: torch.Tensor, last: int) -> torch.Tensor:
    """[B, A*last, H, W] conv output -> [B, H*W*A, last], the JAX NHWC
    flatten order."""
    return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, last)


class PredictionHead(nn.Module):
    """Head producing (loc, conf, mask) per anchor, plus ``score``
    (``use_mask_scoring``) and ``inst`` (``use_instance_coeff``).

    ``use_prediction_module`` is DSSD's module (c): a bottleneck
    (``block``) plus a 1x1 conv and batch norm (``conv``, ``bn``), summed
    after a ReLU of the second, with batch statistics in training.
    ``use_yolo_regressors`` squashes the box centre to (-0.5, 0.5) of a
    cell and divides by the conv grid.  The mask output is the sigmoid of
    ``mask_size^2`` values for direct masks; for lincomb the coefficient
    activation, times the sigmoid of ``gate_layer`` with
    ``mask_proto_coeff_gate``.  With ``mask_proto_split_prototypes_by_head``
    head ``head_index`` predicts ``mask_dim / num_heads`` coefficients and
    pads them into its slice of the full ``mask_dim``."""

    def __init__(self, cfg: YolactConfig, in_channels: int, num_priors: int):
        super().__init__()
        self.cfg = cfg
        self.split = (cfg.mask_proto_split_prototypes_by_head
                      and cfg.mask_type == MaskType.LINCOMB)
        self.mask_dim = cfg.mask_dim // cfg.num_heads if self.split \
            else cfg.mask_dim

        ch = in_channels
        self.upfeature = None
        if cfg.extra_head_net is not None:
            self.upfeature, ch = make_net(ch, cfg.extra_head_net,
                                          include_last_relu=True)
        if cfg.use_prediction_module:
            self.block = Bottleneck(ch, ch // 4)
            self.conv = Conv2d(ch, ch, 1)
            self.bn = BatchNorm2d(ch)
            for m in self.modules():
                if isinstance(m, BatchNorm2d):
                    m.shared = cfg.share_prediction_module

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
            if cfg.mask_proto_coeff_gate and \
                    cfg.mask_type == MaskType.LINCOMB:
                self.gate_layer = Conv2d(ch, num_priors * self.mask_dim, 3,
                                         padding=1)
        if cfg.use_mask_scoring:
            self.score_layer = Conv2d(ch, num_priors, k, padding=p)
        if cfg.use_instance_coeff:
            self.inst_layer = Conv2d(ch, num_priors * cfg.num_instance_coeffs,
                                     k, padding=p)

    def forward(self, x: torch.Tensor, head_index: int = 0,
                bn_train: bool = False) -> Dict[str, torch.Tensor]:
        if self.upfeature is not None:
            x = self.upfeature(x)
        if self.cfg.use_prediction_module:
            a = self.block(x, bn_train=bn_train)
            x = a + F.relu(self.bn(self.conv(x), bn_train))
        maps = self._maps(x, lambda net, t: net(t))
        return self._outputs(maps, head_index, tuple(x.shape[2:]))

    def _maps(self, x: torch.Tensor, run) -> Dict[str, torch.Tensor]:
        """The raw conv outputs [B, A * n, H, W] by output name (and the
        coefficient gate's), `run(net, x)` running a layer or a net."""
        cfg = self.cfg
        maps = {'loc': run(self.bbox_layer, run(self.bbox_extra, x)),
                'conf': run(self.conf_layer, run(self.conf_extra, x))}
        if cfg.eval_mask_branch:
            maps['mask'] = run(self.mask_layer, run(self.mask_extra, x))
            if cfg.mask_type == MaskType.LINCOMB and \
                    cfg.mask_proto_coeff_gate:
                maps['gate'] = run(self.gate_layer, x)
        if cfg.use_mask_scoring:
            maps['score'] = run(self.score_layer, x)
        if cfg.use_instance_coeff:
            maps['inst'] = run(self.inst_layer, x)
        return maps

    def _outputs(self, maps: Dict[str, torch.Tensor], head_index: int,
                 hw) -> Dict[str, torch.Tensor]:
        """The head's outputs from its raw conv outputs; `hw`: the conv
        grid's (H, W)."""
        cfg = self.cfg
        bbox = _flatten(maps['loc'], 4)
        if cfg.use_yolo_regressors:
            grid = torch.tensor([hw[1], hw[0]], dtype=bbox.dtype,
                                device=bbox.device)
            xy = (torch.sigmoid(bbox[..., :2]) - 0.5) / grid
            bbox = torch.cat([xy, bbox[..., 2:]], dim=-1)
        conf = _flatten(maps['conf'], cfg.num_classes)
        if cfg.eval_mask_branch:
            mask = _flatten(maps['mask'], self.mask_dim)
            if cfg.mask_type == MaskType.DIRECT:
                mask = torch.sigmoid(mask)
            else:
                mask = _activation(cfg.mask_proto_coeff_activation)(mask)
                if cfg.mask_proto_coeff_gate:
                    mask = mask * torch.sigmoid(
                        _flatten(maps['gate'], self.mask_dim))
        else:
            # box-only mode: zero coefficients keep the output shapes
            mask = bbox.new_zeros((bbox.shape[0], bbox.shape[1],
                                   self.mask_dim))
        if self.split:
            pad = (head_index * self.mask_dim,
                   (cfg.num_heads - head_index - 1) * self.mask_dim)
            mask = F.pad(mask, pad)
        out = {'loc': bbox, 'conf': conf, 'mask': mask}
        if cfg.use_mask_scoring:
            out['score'] = _flatten(maps['score'], 1)
        if cfg.use_instance_coeff:
            out['inst'] = _flatten(maps['inst'], cfg.num_instance_coeffs)
        return out


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
