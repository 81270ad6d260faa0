"""End-to-end inference: raw BGR frames -> padded detections and masks.

Port of ``yolact_tpu/infer.py`` (``preprocess_device``,
``preprocess_device_s2d``, ``maybe_enable_stem_s2d``, ``forward_and_detect``,
``forward_raw``, ``Pipeline``).  As in JAX, ``Pipeline`` switches to the
space-to-depth stem by itself for raw frames (``maybe_enable_stem_s2d``):
the same math on the same parameters, run by the stem kernel of
``kernels/stem.py``, which takes less device time on an H100 than cuDNN's
7x7/s2 conv and its layout transposes.  :func:`load_model` with
:func:`forward_and_detect` runs the stem the config names.  One difference
from the JAX package is deliberate:

* Frames are resized with ``F.interpolate`` (bilinear,
  ``align_corners=False``, no antialiasing), as the reference
  ``FastBaseTransform`` does.  ``jax.image.resize`` antialiases when it
  downscales, so the two differ for frames larger than ``max_size``; for
  equal or smaller frames they agree.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from yolact_tpu_torch.config import MEANS, STD, MaskType, YolactConfig
from yolact_tpu_torch.detect.detection import detect, eval_scores
from yolact_tpu_torch.detect.postprocess import (postprocess_device,
                                                 rescore_with_maskiou)
from yolact_tpu_torch.models.layers import s2d_input
from yolact_tpu_torch.models.resnet import DCNLayer
from yolact_tpu_torch.models.yolact import Yolact
from yolact_tpu_torch.ops.boxes import decode


def calc_size_preserve_ar(img_w: int, img_h: int, max_size: int):
    """Area-preserving resize target (width, height)."""
    ratio = math.sqrt(img_w / img_h)
    return int(max_size * ratio), int(max_size / ratio)


def preprocess_device(cfg: YolactConfig, img: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] BGR float [0, 255] -> normalized [B, 3, S, S] in the
    backbone's channel order, NCHW for the model."""
    x = img.float().permute(0, 3, 1, 2)
    if cfg.preserve_aspect_ratio:
        tw, th = calc_size_preserve_ar(x.shape[3], x.shape[2], cfg.max_size)
        size = (th, tw)
    else:
        size = (cfg.max_size, cfg.max_size)
    return _normalize(cfg, _resize(x, size))[
        :, ['BGR'.index(c) for c in cfg.backbone.transform.channel_order]]


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    if tuple(x.shape[2:]) != tuple(size):
        x = F.interpolate(x, size=size, mode='bilinear', align_corners=False,
                          antialias=False)
    return x


def _normalize(cfg: YolactConfig, x: torch.Tensor) -> torch.Tensor:
    """The backbone transform's normalisation of a BGR NCHW batch."""
    t = cfg.backbone.transform
    mean = torch.tensor(MEANS, dtype=torch.float32, device=x.device)
    std = torch.tensor(STD, dtype=torch.float32, device=x.device)
    if t.normalize:
        x = (x - mean[:, None, None]) / std[:, None, None]
    elif t.subtract_means:
        x = x - mean[:, None, None]
    elif t.to_float:
        x = x / 255.0
    return x


def preprocess_device_s2d(cfg: YolactConfig, img: torch.Tensor
                          ) -> torch.Tensor:
    """Space-to-depth variant of :func:`preprocess_device` for
    ``cfg.stem_s2d``: [B, H, W, 3] BGR float [0, 255] -> normalized 2x2
    space-to-depth [B, 12, S/2, S/2], still in BGR order (the stem weight
    folds the channel flip in; ``models/layers.py:s2d_stem_kernel``)."""
    # a forced stem_s2d on an unsupported config must raise, not drop the
    # last row / column (odd size) or squash an aspect-preserving input
    if cfg.max_size % 2:
        raise ValueError(f'stem_s2d needs an even max_size, '
                         f'got {cfg.max_size}')
    if cfg.preserve_aspect_ratio:
        raise ValueError('stem_s2d does not support preserve_aspect_ratio')
    x = img.float().permute(0, 3, 1, 2)
    x = _normalize(cfg, _resize(x, (cfg.max_size, cfg.max_size)))
    return s2d_input(x)


def maybe_enable_stem_s2d(cfg: YolactConfig) -> YolactConfig:
    """Turn on the space-to-depth stem when the config supports it (ResNet
    backbone, square even input, RGB transform).  Only valid for pipelines
    that run :func:`preprocess_device_s2d` on raw images."""
    if (cfg.backbone.type in ('resnet', 'resnet_gn')
            and not cfg.preserve_aspect_ratio
            and cfg.max_size % 2 == 0
            and cfg.mask_proto_src is not None
            and cfg.backbone.transform.channel_order == 'RGB'):
        return cfg.copy(stem_s2d=True)
    return cfg


def _prepare_input(cfg: YolactConfig, images: torch.Tensor,
                   preprocess: bool) -> torch.Tensor:
    """The model's input.  Raw [B, H, W, 3] BGR frames get the device
    preprocess (space-to-depth when ``cfg.stem_s2d``); already normalized
    [B, H, W, 3] input in the backbone's channel order (what the host
    ``BaseTransform`` gives) goes to NCHW, and through the exact
    space-to-depth rearrangement when ``cfg.stem_s2d``.  One place owns
    this rule, so the fast-NMS and traditional pipelines agree."""
    if preprocess:
        return preprocess_device_s2d(cfg, images) if cfg.stem_s2d \
            else preprocess_device(cfg, images)
    x = images.float().permute(0, 3, 1, 2)
    return s2d_input(x, from_rgb=True) if cfg.stem_s2d else x


class InferenceOutput(NamedTuple):
    boxes: torch.Tensor      # [B, D, 4] relative point form
    classes: torch.Tensor    # [B, D] int32 (0-based foreground)
    scores: torch.Tensor     # [B, D]
    masks: torch.Tensor      # [B, D, Hp, Wp] proto-res sigmoid masks (cropped)
    valid: torch.Tensor      # [B, D] bool
    mask_scores: Optional[torch.Tensor] = None  # [B, D] maskiou-rescored


def forward_and_detect(cfg: YolactConfig, model: Yolact,
                       images: torch.Tensor, preprocess: bool = True,
                       use_cross_class_nms: bool = False,
                       score_threshold: float = 0.0,
                       crop_masks: bool = True,
                       use_kernels: bool = True) -> InferenceOutput:
    """The whole device program: preprocess, model, fast NMS, masks and,
    for YOLACT++ configs, the maskiou re-scoring of the masks.  ``images``
    are raw [B, H, W, 3] BGR frames, or with ``preprocess=False`` an
    already normalized [B, H, W, 3] batch (see :func:`_prepare_input`).
    ``use_kernels=False`` runs every kernel's plain PyTorch version, to
    compare the two."""
    x = _prepare_input(cfg, images, preprocess)
    preds = model(x, use_kernels=use_kernels)
    dets = detect(cfg, preds, use_cross_class_nms=use_cross_class_nms,
                  use_kernels=use_kernels)
    masks, dets = postprocess_device(cfg, dets, crop_masks=crop_masks,
                                     score_threshold=score_threshold,
                                     use_kernels=use_kernels)
    mask_scores = None
    if (cfg.use_maskiou and cfg.mask_type != MaskType.DIRECT
            and cfg.eval_mask_branch):
        mask_scores = rescore_with_maskiou(model.maskiou_net, masks, dets)
    return InferenceOutput(dets.boxes, dets.classes, dets.scores, masks,
                           dets.valid, mask_scores)


def forward_raw(cfg: YolactConfig, model: Yolact, images: torch.Tensor,
                preprocess: bool = True, use_kernels: bool = True):
    """The device half of the traditional (host greedy) NMS path: returns
    (decoded boxes [B, P, 4], foreground scores [B, C-1, P], coefficients
    [B, P, Md], proto [B, Hp, Wp, Md] or None), all float32.  Scores use the
    same eval-branch transform as ``detect``."""
    x = _prepare_input(cfg, images, preprocess)
    preds = model(x, use_kernels=use_kernels)
    scores = eval_scores(cfg, preds)[..., 1:].transpose(1, 2)
    boxes = decode(preds['loc'].float(), preds['priors'].float()[None],
                   cfg.use_yolo_regressors)
    proto = preds['proto'].float() if 'proto' in preds else None
    return boxes, scores, preds['mask'].float(), proto


_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def check_device(device: Union[str, torch.device]) -> torch.device:
    """The torch device; a CUDA device that is not there raises (there is
    no CPU fallback)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but '
                           f'torch.cuda.is_available() is False')
    return device


def load_model(cfg: YolactConfig, state_dict: Dict[str, torch.Tensor],
               device: torch.device,
               compute_dtype: Optional[str] = None) -> Yolact:
    """Yolact(cfg) with the state dict (strict), its convolutions in
    ``compute_dtype`` (default ``cfg.compute_dtype``), on ``device``, in
    eval mode."""
    model = Yolact(cfg)
    model.load_state_dict(state_dict, strict=True)
    model.set_compute_dtype(_DTYPES[compute_dtype or cfg.compute_dtype])
    return model.to(device).eval()


class Pipeline:
    """Owns the model on one device and answers batches of frames.

    ``compute_dtype`` ('float32' or 'bfloat16', default ``cfg.compute_dtype``)
    is the convolution dtype; the state dict stays float32.  A CUDA device
    that is not there raises; there is no CPU fallback.  ``preprocess``:
    True takes raw [B, H, W, 3] BGR frames, and the space-to-depth stem
    where the config supports it (``maybe_enable_stem_s2d``, as JAX's
    ``Pipeline``); False the host-normalized frames of the eval loop (see
    :func:`_prepare_input`) and the stem the config names.  ``use_kernels``
    exists for comparisons: False runs the plain PyTorch versions of the
    kernels on the card."""

    def __init__(self, cfg: YolactConfig, state_dict: Dict[str, torch.Tensor],
                 device: Union[str, torch.device],
                 compute_dtype: Optional[str] = None,
                 use_cross_class_nms: bool = False,
                 score_threshold: float = 0.0,
                 crop_masks: bool = True,
                 use_kernels: bool = True,
                 preprocess: bool = True):
        if preprocess:
            cfg = maybe_enable_stem_s2d(cfg)
        self.cfg = cfg
        self.device = check_device(device)
        self.model = load_model(cfg, state_dict, self.device, compute_dtype)
        self._kw = dict(preprocess=preprocess,
                        use_cross_class_nms=use_cross_class_nms,
                        score_threshold=score_threshold,
                        crop_masks=crop_masks, use_kernels=use_kernels)

    def __call__(self, images) -> InferenceOutput:
        with torch.inference_mode():
            images = torch.as_tensor(images, device=self.device)
            return forward_and_detect(self.cfg, self.model, images, **self._kw)


def random_state_dict(cfg: YolactConfig, generator: torch.Generator
                      ) -> Dict[str, torch.Tensor]:
    """Seeded random float32 weights in the JAX package's init scheme:
    xavier-uniform conv kernels, zero biases, identity batch norm; a DCN
    layer's offset/mask conv is all zero (offsets 0, mask 0.5) and its
    weight is flax's kaiming-normal (truncated normal, variance 2/fan_in)."""
    model = Yolact(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        for m in model.modules():
            if isinstance(m, DCNLayer):
                m.conv_offset_mask.weight.zero_()
                fan_in = m.weight[0].numel()
                # flax's truncated normal at +-2 std, rescaled to unit
                # variance: std / 0.8796...
                std = math.sqrt(2.0 / fan_in) / .87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                m.bias.zero_()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
