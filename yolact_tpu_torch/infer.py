"""End-to-end inference: raw BGR frames -> padded detections and masks.

Port of ``yolact_tpu/infer.py`` (``preprocess_device``,
``forward_and_detect``, ``Pipeline``).  Differences from the JAX package,
both deliberate:

* The stem is the plain 7x7/s2 conv.  The JAX ``Pipeline`` switches to a
  space-to-depth 4x4/s1 stem (``maybe_enable_stem_s2d``), the same math on
  the same parameters arranged for the TPU's lanes.
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

from yolact_tpu.config import MEANS, STD, YolactConfig
from yolact_tpu_torch.detect.detection import detect
from yolact_tpu_torch.detect.postprocess import postprocess_device
from yolact_tpu_torch.models.yolact import Yolact


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
    if tuple(x.shape[2:]) != size:
        x = F.interpolate(x, size=size, mode='bilinear', align_corners=False,
                          antialias=False)
    t = cfg.backbone.transform
    mean = torch.tensor(MEANS, dtype=torch.float32, device=x.device)
    std = torch.tensor(STD, dtype=torch.float32, device=x.device)
    if t.normalize:
        x = (x - mean[:, None, None]) / std[:, None, None]
    elif t.subtract_means:
        x = x - mean[:, None, None]
    elif t.to_float:
        x = x / 255.0
    # channel permutation after the BGR-space normalisation
    return x[:, ['BGR'.index(c) for c in t.channel_order]]


class InferenceOutput(NamedTuple):
    boxes: torch.Tensor      # [B, D, 4] relative point form
    classes: torch.Tensor    # [B, D] int32 (0-based foreground)
    scores: torch.Tensor     # [B, D]
    masks: torch.Tensor      # [B, D, Hp, Wp] proto-res sigmoid masks (cropped)
    valid: torch.Tensor      # [B, D] bool


def forward_and_detect(cfg: YolactConfig, model: Yolact,
                       images: torch.Tensor, preprocess: bool = True,
                       use_cross_class_nms: bool = False,
                       score_threshold: float = 0.0,
                       crop_masks: bool = True,
                       use_kernels: bool = True) -> InferenceOutput:
    """The whole device program: preprocess, model, fast NMS, masks.
    ``images`` are raw [B, H, W, 3] BGR frames, or with
    ``preprocess=False`` an already normalized NCHW batch."""
    x = preprocess_device(cfg, images) if preprocess else images
    preds = model(x)
    dets = detect(cfg, preds, use_cross_class_nms=use_cross_class_nms,
                  use_kernels=use_kernels)
    masks, dets = postprocess_device(cfg, dets, crop_masks=crop_masks,
                                     score_threshold=score_threshold,
                                     use_kernels=use_kernels)
    return InferenceOutput(dets.boxes, dets.classes, dets.scores, masks,
                           dets.valid)


_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class Pipeline:
    """Owns the model on one device and answers batches of raw frames.

    ``compute_dtype`` ('float32' or 'bfloat16', default ``cfg.compute_dtype``)
    is the convolution dtype; the state dict stays float32.  A CUDA device
    that is not there raises; there is no CPU fallback.  ``use_kernels``
    exists for comparisons: False runs the plain PyTorch versions of the
    kernels on the card."""

    def __init__(self, cfg: YolactConfig, state_dict: Dict[str, torch.Tensor],
                 device: Union[str, torch.device],
                 compute_dtype: Optional[str] = None,
                 use_cross_class_nms: bool = False,
                 score_threshold: float = 0.0,
                 crop_masks: bool = True,
                 use_kernels: bool = True):
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(f'Pipeline: device {device} requested but '
                               f'torch.cuda.is_available() is False')
        self.cfg = cfg
        self.device = device
        model = Yolact(cfg)
        model.load_state_dict(state_dict, strict=True)
        model.set_compute_dtype(_DTYPES[compute_dtype or cfg.compute_dtype])
        self.model = model.to(device).eval()
        self._kw = dict(use_cross_class_nms=use_cross_class_nms,
                        score_threshold=score_threshold,
                        crop_masks=crop_masks, use_kernels=use_kernels)

    def __call__(self, images) -> InferenceOutput:
        with torch.inference_mode():
            images = torch.as_tensor(images, device=self.device)
            return forward_and_detect(self.cfg, self.model, images, **self._kw)


def random_state_dict(cfg: YolactConfig, generator: torch.Generator
                      ) -> Dict[str, torch.Tensor]:
    """Seeded random float32 weights in the JAX package's init scheme:
    xavier-uniform conv kernels, zero biases, identity batch norm."""
    model = Yolact(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
