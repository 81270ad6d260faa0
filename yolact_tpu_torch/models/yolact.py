"""Top-level YOLACT model, eval forward: backbone -> FPN -> (protonet ‖ heads).

Port of ``yolact_tpu/models/yolact.py:Yolact``: every backbone family
(ResNet, ResNet-GN, DarkNet-53, VGG-16), with an FPN or without one
(``yolact_vgg16``: the selected backbone outputs go straight to the
protonet and to one prediction head per level, each at its level's width),
lincomb masks from a feature map or from the image itself
(``mask_proto_src=None``, not with the s2d stem) and direct masks
(``MaskType.DIRECT``: no protonet, ``mask_size^2`` sigmoid values per
prior).  With ``mask_proto_prototypes_as_features`` the activated
prototypes (without the bias channel; detached under ``_no_grad``) are
resized to each head level in turn, each from the previous level's
resize as the reference does, and joined to that head's input.  With
``cfg.use_maskiou`` the model also holds the YOLACT++ mask scorer as
``maskiou_net`` (the JAX package keeps it in a separate ``MaskIoUHead``
tree); ``forward`` does not run it, ``infer`` does, on the assembled masks.

``forward(x, train=True)`` is the training forward: batch norm on batch
statistics unless ``cfg.freeze_bn`` (the new running statistics are left
pending, ``models/layers.py:commit_batch_stats``), ``cfg.train_remat``
checkpointing of the ResNet bottlenecks, and two more outputs.  The
training-only heads ``semantic_seg_conv`` and ``class_existence_fc`` carry
the reference's names, so a reference ``.pth`` loads; the eval forward does
not run them.

Spatial split (``parallel/mesh.py:make_mesh_2d``; ``rows``): the input is a
rank's rows of the data rank's images, every module runs on its rows of
its maps (each module's ``forward_rows``, which with ``rows`` None is its
whole-map forward), and the head outputs, the prototypes, the
semantic-segmentation logits and the class-existence features are
gathered to the whole height before they leave, so every space rank
returns the whole batch's outputs, as the one-device forward does.  Every
config takes it: each backbone family, with an FPN or without one, and
every mask option.  The class-existence layer and the mask scorer then
run on whole maps on every space rank alike (:data:`SPACE_REPLICATED`).
Prototypes as features are gathered a second time for the heads, with the
other gradient (:meth:`Yolact.forward`).

Input is NCHW, already preprocessed (``infer.preprocess_device``); with
``cfg.stem_s2d`` (ResNets only) it is the 2x2 space-to-depth
``[B, 12, S/2, S/2]`` (``infer.preprocess_device_s2d``) and the trunk's
first conv is the s2d stem kernel.
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

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolact_tpu_torch.config import MaskType, YolactConfig, backbone_channels
from yolact_tpu_torch.models.darknet import DarkNetBackbone
from yolact_tpu_torch.models.fpn import FPN
from yolact_tpu_torch.models.heads import (FastMaskIoUNet, PredictionHead,
                                           ProtoNet)
from yolact_tpu_torch.models.layers import (Conv2d, Linear, conv_rows,
                                            drop_batch_stats, height)
from yolact_tpu_torch.models.resnet import DCNLayer, ResNetBackbone
from yolact_tpu_torch.models.vgg import VGGBackbone
from yolact_tpu_torch.ops.anchors import generate_priors
from yolact_tpu_torch.parallel.mesh import Rows, gather_rows
from yolact_tpu_torch.utils import timer

# modules whose parameters a spatial split runs after the gather, on every
# space rank alike: their gradients are summed over the data ranks only
SPACE_REPLICATED = ('class_existence_fc', 'maskiou_net')


def head_in_channels(cfg: YolactConfig) -> Tuple[int, ...]:
    """Channels of each prediction level, in head order: the FPN's width
    on every level, or without an FPN each selected backbone output's."""
    if cfg.fpn is not None:
        return (cfg.fpn.num_features,) * cfg.num_heads
    chans = backbone_channels(cfg.backbone)
    return tuple(chans[i] for i in cfg.backbone.selected_layers)


def init_train_heads(cfg: YolactConfig, generator: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    """Seeded initial weights of the heads that only ``forward(train=True)``
    runs, under their state-dict keys, in the JAX package's init scheme:
    a xavier-uniform ``semantic_seg_conv``, flax's Dense default for
    ``class_existence_fc`` (truncated normal at 2 std, variance 1/fan_in),
    zero biases.  For weights that come without them (a JAX eval tree)."""
    widths, n = head_in_channels(cfg), cfg.num_classes - 1
    heads = {}
    if cfg.use_semantic_segmentation_loss:
        heads['semantic_seg_conv.weight'] = nn.init.xavier_uniform_(
            torch.empty(n, widths[0], 1, 1), generator=generator)
        heads['semantic_seg_conv.bias'] = torch.zeros(n)
    if cfg.use_class_existence_loss:
        std = math.sqrt(1.0 / widths[-1]) / .87962566103423978
        heads['class_existence_fc.weight'] = nn.init.trunc_normal_(
            torch.empty(n, widths[-1]), std=std, a=-2 * std, b=2 * std,
            generator=generator)
        heads['class_existence_fc.bias'] = torch.zeros(n)
    return heads


def _build_backbone(cfg: YolactConfig) -> nn.Module:
    """The backbone of ``cfg.backbone.type`` (JAX ``_build_backbone``)."""
    bb = cfg.backbone
    num_stages = max(bb.selected_layers) + 1
    if bb.type in ('resnet', 'resnet_gn'):
        layers = tuple(bb.args[0])
        return ResNetBackbone(
            layers=layers,
            dcn_layers=tuple(bb.args[1]) if len(bb.args) > 1 else (0, 0, 0, 0),
            dcn_interval=bb.args[2] if len(bb.args) > 2 else 1,
            atrous_layers=tuple(bb.args[3]) if len(bb.args) > 3 else (),
            num_stages=max(num_stages, len(layers)),
            stem_s2d=cfg.stem_s2d,
            norm='gn' if bb.type == 'resnet_gn' else 'bn')
    if cfg.stem_s2d:
        raise ValueError('stem_s2d is only supported for ResNet backbones')
    if bb.type == 'darknet':
        layers = tuple(bb.args[0])
        return DarkNetBackbone(layers, num_stages=max(num_stages, len(layers)))
    if bb.type == 'vgg':
        arch, extra_args, norm_layers = bb.args
        return VGGBackbone(arch, extra_args, tuple(norm_layers),
                           num_stages=max(num_stages, len(arch)))
    raise ValueError(f'unknown backbone type {bb.type!r}')


class Yolact(nn.Module):
    def __init__(self, cfg: YolactConfig):
        super().__init__()
        lincomb = (cfg.mask_type == MaskType.LINCOMB
                   and cfg.eval_mask_branch)
        if lincomb and cfg.stem_s2d and cfg.mask_proto_src is None:
            raise ValueError('stem_s2d cannot feed the protonet the raw '
                             'image (mask_proto_src=None)')
        # prototypes-as-features: the activated prototypes without the bias
        # channel join every head's input
        self.proto_features = 0
        if cfg.mask_type == MaskType.LINCOMB and \
                cfg.mask_proto_prototypes_as_features:
            if not lincomb:
                raise ValueError('mask_proto_prototypes_as_features needs '
                                 'the lincomb mask branch enabled')
            self.proto_features = cfg.mask_dim - int(cfg.mask_proto_bias)
        self.cfg = cfg
        self.compute_dtype = torch.float32
        self.backbone = _build_backbone(cfg)
        self.fpn = None
        if cfg.fpn is not None:
            chans = backbone_channels(cfg.backbone)
            self.fpn = FPN(cfg.fpn,
                           [chans[i] for i in cfg.backbone.selected_layers])
        widths = head_in_channels(cfg)
        self.proto_net = ProtoNet(cfg, cfg.proto_in_channels) if lincomb \
            else None
        n_heads = 1 if cfg.share_prediction_module else cfg.num_heads
        self.prediction_layers = nn.ModuleList(
            PredictionHead(cfg, widths[i] + self.proto_features,
                           self._priors_per_pos(i))
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
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, DCNLayer)) \
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
                train: bool = False,
                rows: Optional[Rows] = None) -> Dict[str, torch.Tensor]:
        """``use_kernels=False`` runs the plain PyTorch versions of the DCN
        sampling and the s2d stem conv on the card too, to compare the
        two.  ``train``: see the module docstring.  ``rows``: `x` is this
        rank's rows of an input of ``rows.height`` under a spatial split
        (the module docstring).  The trunk, the FPN and the heads are the
        spans ``backbone``, ``fpn`` and ``heads`` (``utils/timer.py``)."""
        cfg = self.cfg
        # logical image size: a space-to-depth input is at half resolution
        scale = 2 if cfg.stem_s2d else 1
        h, w = height(x, rows) * scale, x.shape[3] * scale
        # freeze_bn keeps batch norm on its running statistics in training
        bn_train = train and not cfg.freeze_bn
        remat = cfg.train_remat if train else 'none'
        with timer.span('backbone'):
            x = x.to(self.compute_dtype)
            if rows is None:
                outs = self.backbone(x, use_kernels, bn_train=bn_train,
                                     remat=remat)
                heights = (None,) * len(outs)
            else:
                outs, heights = self.backbone.forward_rows(
                    x, rows, use_kernels, bn_train=bn_train, remat=remat)
        if bn_train:
            # a shared head's batch norms chain their statistics over the
            # levels of this forward, from the buffers
            drop_batch_stats(self.prediction_layers)
        sel = cfg.backbone.selected_layers
        outs, heights = [outs[i] for i in sel], [heights[i] for i in sel]
        if self.fpn is not None:
            with timer.span('fpn'):
                outs, heights = self.fpn.forward_rows(outs, heights)
        with timer.span('heads'):
            return self._heads(x, outs, heights, rows, h, w, bn_train, train)

    def _heads(self, x, outs, heights, rows, h, w, bn_train: bool,
               train: bool) -> Dict[str, torch.Tensor]:
        """The prototypes, the prediction heads and (training) the
        class-existence and semantic-segmentation heads, on the levels
        `outs` of the input `x` (its logical size `h` x `w`)."""
        cfg = self.cfg
        proto = proto_feat = None
        if self.proto_net is not None:
            src = cfg.mask_proto_src
            if src is None:
                local, r = self.proto_net.forward_rows(x, rows)
            else:
                local, r = self.proto_net.forward_rows(outs[src],
                                                       heights[src])
            # the loss consumes the whole prototypes alike on every rank:
            # each rank keeps its own rows' gradient
            proto = gather_rows(local, r, 'shared')
            if self.proto_features:
                # as features, each rank consumes only its own rows of each
                # level: every rank's gradient of the gathered map is
                # summed into the owner's rows ('own'; the 'shared' gather
                # above would drop the other ranks' feature gradients)
                proto_feat = gather_rows(local[:, :self.proto_features], r,
                                         'own')
                if cfg.mask_proto_prototypes_as_features_no_grad:
                    proto_feat = proto_feat.detach()

        preds = []
        for idx, head_x in enumerate(outs):
            head = self.prediction_layers[
                0 if cfg.share_prediction_module else idx]
            if proto_feat is not None:
                # the reference resizes the tensor resized for the level
                # before, a progressive chain (JAX reproduces it), at each
                # level's whole size; a rank joins its rows of it
                proto_feat = F.interpolate(
                    proto_feat, size=(height(head_x, heights[idx]),
                                      head_x.shape[3]),
                    mode='bilinear', align_corners=False).to(head_x.dtype)
                feat = proto_feat if heights[idx] is None else \
                    heights[idx].take(proto_feat)
                head_x = torch.cat([head_x, feat], dim=1)
            preds.append(head(head_x, head_index=idx, bn_train=bn_train,
                              rows=heights[idx]))
        pred_outs = {k: torch.cat([p[k] for p in preds], dim=1)
                     for k in preds[0]}
        pred_outs['priors'] = self.priors(h, w, x.device)
        if proto is not None:
            pred_outs['proto'] = proto.permute(0, 2, 3, 1)
        if train:
            if cfg.use_class_existence_loss:
                last = gather_rows(outs[-1], heights[-1], 'shared')
                pred_outs['classes'] = self.class_existence_fc(
                    last.mean(dim=(2, 3)))
            if cfg.use_semantic_segmentation_loss:
                segm, r = conv_rows(self.semantic_seg_conv, outs[0],
                                    heights[0])
                pred_outs['segm'] = gather_rows(segm, r, 'shared').permute(
                    0, 2, 3, 1)
        return pred_outs
