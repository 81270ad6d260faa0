"""Top-level YOLACT model, eval forward: backbone -> FPN -> (protonet ‖ heads).

Port of ``yolact_tpu/models/yolact.py:Yolact`` for what the benchmark's
configurations use: the backbone of the config's family
(``config.backbone_family``: ``models/<type>.py``; the ResNet's options
hold DCNv2 blocks and the s2d stem), an FPN, lincomb masks from a
feature map or from the image itself (``mask_proto_src=None``, not with
the s2d stem) and direct masks (``MaskType.DIRECT``: no protonet,
``mask_size^2`` sigmoid values per prior).  With ``cfg.use_maskiou`` the model also holds the YOLACT++
mask scorer as ``maskiou_net`` (the JAX package keeps it in a separate
``MaskIoUHead`` tree); ``forward`` does not run it, ``infer`` does, on
the assembled masks.

``forward(x, train=True)`` is the training forward: batch norm on batch
statistics unless ``cfg.freeze_bn`` (the new running statistics are left
pending, ``models/layers.py:commit_batch_stats``), ``cfg.train_remat``
checkpointing of the ResNet bottlenecks, and two more outputs.  The
training-only heads ``semantic_seg_conv`` and ``class_existence_fc`` carry
the reference's names, so a reference ``.pth`` loads; the eval forward does
not run them.

Input is NCHW, already preprocessed (``infer.preprocess_device``); with
``cfg.stem_s2d`` it is the 2x2 space-to-depth ``[B, 12, S/2, S/2]``
(``infer.preprocess_device_s2d``) and the trunk's first conv is the s2d
stem kernel.
Output dict, in the JAX package's layouts:
  loc    [B, P, 4]       raw box regressions
  conf   [B, P, C]       raw class logits
  mask   [B, P, Md]      mask coefficients (direct: [B, P, mask_size^2])
  priors [P, 4]          center-size anchors, float32
  proto  [B, Hp, Wp, Md] prototypes (lincomb only)
  score  [B, P, 1]       mask scores (``use_mask_scoring``)
  inst   [B, P, Ni]      instance coefficients (``use_instance_coeff``)
and with ``train=True``:
  segm    [B, Hs, Ws, C-1] semantic-segmentation logits on the first head
                           level (``cfg.use_semantic_segmentation_loss``)
  classes [B, C-1]         class-existence logits on the last
                           (``cfg.use_class_existence_loss``)
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from benchmark.reference.config import (MaskType, YolactConfig,
                                        backbone_channels, backbone_family)
from benchmark.reference.models.fpn import FPN
from benchmark.reference.models.heads import (FastMaskIoUNet, PredictionHead,
                                              ProtoNet)
from benchmark.reference.models.layers import Conv2d, Linear, drop_batch_stats
from benchmark.reference.models.resnet import DCNLayer
from benchmark.reference.ops.anchors import generate_priors


class Yolact(nn.Module):
    def __init__(self, cfg: YolactConfig):
        super().__init__()
        lincomb = (cfg.mask_type == MaskType.LINCOMB
                   and cfg.eval_mask_branch)
        if lincomb and cfg.stem_s2d and cfg.mask_proto_src is None:
            raise ValueError('stem_s2d cannot feed the protonet the raw '
                             'image (mask_proto_src=None)')
        if cfg.fpn is None or cfg.mask_proto_prototypes_as_features:
            raise NotImplementedError('a configuration without an FPN, or '
                                      'with prototypes as features')
        self.cfg = cfg
        self.compute_dtype = torch.float32
        self.backbone = backbone_family(cfg.backbone.type).build_backbone(cfg)
        chans = backbone_channels(cfg.backbone)
        self.fpn = FPN(cfg.fpn,
                       [chans[i] for i in cfg.backbone.selected_layers])
        # every prediction level has the FPN's width
        widths = (cfg.fpn.num_features,) * cfg.num_heads
        self.proto_net = ProtoNet(cfg, cfg.proto_in_channels) if lincomb \
            else None
        n_heads = 1 if cfg.share_prediction_module else cfg.num_heads
        self.prediction_layers = nn.ModuleList(
            PredictionHead(cfg, widths[i], self._priors_per_pos(i))
            for i in range(n_heads))
        self.maskiou_net = FastMaskIoUNet(cfg) if cfg.use_maskiou else None
        if cfg.use_class_existence_loss:
            self.class_existence_fc = Linear(widths[-1], cfg.num_classes - 1)
        if cfg.use_semantic_segmentation_loss:
            self.semantic_seg_conv = Conv2d(widths[0], cfg.num_classes - 1, 1)
        self._priors = {}

    def _priors_per_pos(self, idx: int) -> int:
        bb = self.cfg.backbone
        return sum(len(ars) * len(bb.pred_scales[idx])
                   for ars in bb.pred_aspect_ratios[idx])

    def set_compute_dtype(self, dtype: torch.dtype,
                          cast_weights: bool = True) -> 'Yolact':
        """Run the convolutions in `dtype` (the JAX ``compute_dtype``): the
        forward casts its input to `dtype`, and every conv computes in its
        input's dtype (``models/layers.py:Conv2d``).  Batch-norm statistics
        stay float32, and so does the mask scorer, which JAX runs in float32
        on float32 masks: its weights are never cast, so they keep every bit.

        ``cast_weights`` (inference) casts the conv and DCN weights once,
        in place.  Training passes False: the parameters stay the float32
        master weights, each conv casts its weight at use, and the
        gradients come back in float32, as flax's ``dtype`` over float32
        params does."""
        if cast_weights:
            scorer = (set(self.maskiou_net.modules())
                      if self.maskiou_net is not None else set())
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, DCNLayer)) \
                        and m not in scorer:
                    m.to(dtype)
        self.compute_dtype = dtype
        return self

    def priors(self, h: int, w: int, device: torch.device) -> torch.Tensor:
        key = (h, w, str(device))
        if key not in self._priors:
            self._priors[key] = torch.from_numpy(
                generate_priors(self.cfg, (h, w)).copy()).to(device)
        return self._priors[key]

    def forward(self, x: torch.Tensor, use_kernels: bool = True,
                train: bool = False) -> Dict[str, torch.Tensor]:
        """``use_kernels=False`` runs the plain PyTorch versions of the DCN
        sampling and the s2d stem conv on the card too, to compare the
        two.  ``train``: see the module docstring."""
        cfg = self.cfg
        # logical image size: a space-to-depth input is at half resolution
        scale = 2 if cfg.stem_s2d else 1
        h, w = x.shape[2] * scale, x.shape[3] * scale
        x = x.to(self.compute_dtype)
        # freeze_bn keeps batch norm on its running statistics in training
        bn_train = train and not cfg.freeze_bn
        remat = cfg.train_remat if train else 'none'
        outs = self.backbone(x, use_kernels, bn_train=bn_train, remat=remat)
        if bn_train:
            # a shared head's batch norms chain their statistics over the
            # levels of this forward, from the buffers
            drop_batch_stats(self.prediction_layers)
        outs = self.fpn([outs[i] for i in cfg.backbone.selected_layers])

        proto = None
        if self.proto_net is not None:
            src = cfg.mask_proto_src
            proto = self.proto_net(x if src is None else outs[src])

        preds = [self.prediction_layers[
                     0 if cfg.share_prediction_module else idx](
                         head_x, head_index=idx, bn_train=bn_train)
                 for idx, head_x in enumerate(outs)]
        pred_outs = {k: torch.cat([p[k] for p in preds], dim=1)
                     for k in preds[0]}
        pred_outs['priors'] = self.priors(h, w, x.device)
        if proto is not None:
            pred_outs['proto'] = proto.permute(0, 2, 3, 1)
        if train:
            if cfg.use_class_existence_loss:
                pred_outs['classes'] = self.class_existence_fc(
                    outs[-1].mean(dim=(2, 3)))
            if cfg.use_semantic_segmentation_loss:
                pred_outs['segm'] = self.semantic_seg_conv(
                    outs[0]).permute(0, 2, 3, 1)
        return pred_outs
