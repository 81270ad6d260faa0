"""End-to-end inference: raw BGR frames -> padded detections and masks.

Port of ``yolact_tpu/infer.py`` (``preprocess_device``,
``preprocess_device_s2d``, ``forward_and_detect``) and of the port's
``load_model``.  :func:`load_model` with :func:`forward_and_detect` runs
the stem the config names.  One difference from the JAX package is
deliberate:

* Frames are resized with ``F.interpolate`` (bilinear,
  ``align_corners=False``, no antialiasing), as the reference
  ``FastBaseTransform`` does.  ``jax.image.resize`` antialiases when it
  downscales, so the two differ for frames larger than ``max_size``; for
  equal or smaller frames they agree.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.config import MEANS, STD, MaskType, YolactConfig
from benchmark.reference.detect.detection import detect
from benchmark.reference.detect.postprocess import (postprocess_device,
                                                    rescore_with_maskiou)
from benchmark.reference.models.layers import s2d_input
from benchmark.reference.models.yolact import Yolact


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


_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def use_float32_math(compute_dtype: str) -> None:
    """float32 means float32: for a float32 model turn off TF32 in cuDNN's
    convolutions and in cuBLAS's matmuls (PyTorch's default lets cuDNN
    round float32 inputs to a 10-bit mantissa).  The flags are the
    process's: the backward's convolutions read them when they run, so a
    scope around the forward would not hold them.  A bfloat16 model leaves
    them as they are."""
    if compute_dtype == 'float32':
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def load_model(cfg: YolactConfig, state_dict: Dict[str, torch.Tensor],
               device: torch.device,
               compute_dtype: Optional[str] = None) -> Yolact:
    """Yolact(cfg) with the state dict (strict), its convolutions in
    ``compute_dtype`` (default ``cfg.compute_dtype``; float32 turns TF32
    off, :func:`use_float32_math`), on ``device``, in eval mode."""
    compute_dtype = compute_dtype or cfg.compute_dtype
    model = Yolact(cfg)
    model.load_state_dict(state_dict, strict=True)
    model.set_compute_dtype(_DTYPES[compute_dtype])
    use_float32_math(compute_dtype)
    return model.to(device).eval()
