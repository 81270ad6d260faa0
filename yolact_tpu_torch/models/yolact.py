"""Top-level YOLACT model, eval forward: backbone -> FPN -> (protonet ‖ heads).

Port of ``yolact_tpu/models/yolact.py:Yolact`` for the ResNet + FPN +
lincomb configurations (``yolact_base``, and ``yolact_plus_base`` with its
DCN blocks).  With ``cfg.use_maskiou`` the model also holds the YOLACT++
mask scorer as ``maskiou_net`` (the JAX package keeps it in a separate
``MaskIoUHead`` tree); ``forward`` does not run it, ``infer`` does, on the
assembled masks.  Training outputs, prototypes-as-features and the other
backbones are not ported yet.

Input is NCHW, already preprocessed (``infer.preprocess_device``); with
``cfg.stem_s2d`` it is the 2x2 space-to-depth ``[B, 12, S/2, S/2]``
(``infer.preprocess_device_s2d``) and the trunk's first conv is the s2d
stem kernel.
Output dict, in the JAX package's layouts:
  loc    [B, P, 4]       raw box regressions
  conf   [B, P, C]       raw class logits
  mask   [B, P, Md]      mask coefficients
  priors [P, 4]          center-size anchors, float32
  proto  [B, Hp, Wp, Md] prototypes
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from yolact_tpu_torch.config import MaskType, YolactConfig, backbone_channels
from yolact_tpu_torch.models.fpn import FPN
from yolact_tpu_torch.models.heads import (FastMaskIoUNet, PredictionHead,
                                           ProtoNet)
from yolact_tpu_torch.models.resnet import DCNLayer, ResNetBackbone
from yolact_tpu_torch.ops.anchors import generate_priors


def _build_backbone(cfg: YolactConfig) -> ResNetBackbone:
    bb = cfg.backbone
    if cfg.stem_s2d and bb.type not in ('resnet', 'resnet_gn'):
        raise ValueError('stem_s2d is only supported for ResNet backbones')
    if bb.type != 'resnet':
        raise NotImplementedError(
            f'backbone type {bb.type!r} is not ported yet (ROADMAP A8)')
    layers = tuple(bb.args[0])
    return ResNetBackbone(
        layers=layers,
        dcn_layers=tuple(bb.args[1]) if len(bb.args) > 1 else (0, 0, 0, 0),
        dcn_interval=bb.args[2] if len(bb.args) > 2 else 1,
        atrous_layers=tuple(bb.args[3]) if len(bb.args) > 3 else (),
        num_stages=max(max(bb.selected_layers) + 1, len(layers)),
        stem_s2d=cfg.stem_s2d)


class Yolact(nn.Module):
    def __init__(self, cfg: YolactConfig):
        super().__init__()
        if (cfg.stem_s2d and cfg.mask_type == MaskType.LINCOMB
                and cfg.eval_mask_branch and cfg.mask_proto_src is None):
            raise ValueError('stem_s2d cannot feed the protonet the raw '
                             'image (mask_proto_src=None)')
        if cfg.mask_type != MaskType.LINCOMB or cfg.mask_proto_src is None \
                or cfg.fpn is None:
            raise NotImplementedError(
                'only FPN + lincomb configs with a feature-map protonet '
                'source (yolact_base and its variants) are ported')
        if cfg.mask_proto_prototypes_as_features:
            raise NotImplementedError(
                'mask_proto_prototypes_as_features is not ported')
        self.cfg = cfg
        self.compute_dtype = torch.float32
        self.backbone = _build_backbone(cfg)
        chans = backbone_channels(cfg.backbone)
        self.fpn = FPN(cfg.fpn, [chans[i] for i in cfg.backbone.selected_layers])
        nf = cfg.fpn.num_features
        if cfg.eval_mask_branch:
            self.proto_net = ProtoNet(cfg, nf)
        n_heads = 1 if cfg.share_prediction_module else cfg.num_heads
        self.prediction_layers = nn.ModuleList(
            PredictionHead(cfg, nf, self._priors_per_pos(i))
            for i in range(n_heads))
        self.maskiou_net = FastMaskIoUNet(cfg) if cfg.use_maskiou else None
        self._priors = {}

    def _priors_per_pos(self, idx: int) -> int:
        bb = self.cfg.backbone
        return sum(len(ars) * len(bb.pred_scales[idx])
                   for ars in bb.pred_aspect_ratios[idx])

    def set_compute_dtype(self, dtype: torch.dtype) -> 'Yolact':
        """Run the convolutions in `dtype` (the JAX ``compute_dtype``): conv
        and DCN weights are cast once here, batch-norm statistics stay
        float32, and so does the mask scorer, which JAX runs in float32 on
        float32 masks: its weights are never cast, so they keep every bit."""
        scorer = (set(self.maskiou_net.modules())
                  if self.maskiou_net is not None else set())
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, DCNLayer)) and m not in scorer:
                m.to(dtype)
        self.compute_dtype = dtype
        return self

    def priors(self, h: int, w: int, device: torch.device) -> torch.Tensor:
        key = (h, w, str(device))
        if key not in self._priors:
            self._priors[key] = torch.from_numpy(
                generate_priors(self.cfg, (h, w)).copy()).to(device)
        return self._priors[key]

    def forward(self, x: torch.Tensor,
                use_kernels: bool = True) -> Dict[str, torch.Tensor]:
        """``use_kernels=False`` runs the plain PyTorch versions of the DCN
        sampling and the s2d stem conv on the card too, to compare the
        two."""
        cfg = self.cfg
        # logical image size: a space-to-depth input is at half resolution
        scale = 2 if cfg.stem_s2d else 1
        h, w = x.shape[2] * scale, x.shape[3] * scale
        x = x.to(self.compute_dtype)
        outs = self.backbone(x, use_kernels)
        outs = self.fpn([outs[i] for i in cfg.backbone.selected_layers])

        preds = []
        for idx, head_x in enumerate(outs):
            head = self.prediction_layers[
                0 if cfg.share_prediction_module else idx]
            preds.append(head(head_x))
        pred_outs = {k: torch.cat([p[k] for p in preds], dim=1)
                     for k in preds[0]}
        pred_outs['priors'] = self.priors(h, w, x.device)
        if cfg.eval_mask_branch:
            pred_outs['proto'] = self.proto_net(
                outs[cfg.mask_proto_src]).permute(0, 2, 3, 1)
        return pred_outs
