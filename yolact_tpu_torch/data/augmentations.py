"""Eval-time image transform: ``BaseTransform`` of
``yolact_tpu/data/augmentations.py`` and what it calls, copied for the port
(the training augmentations come with the train step).  cv2 is imported
inside the resize, so the module imports without it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from yolact_tpu_torch.config import MEANS, STD, YolactConfig


def calc_size_preserve_ar(img_w: int, img_h: int, max_size: int
                          ) -> Tuple[int, int]:
    """Area-preserving resize target (augmentations.py:131-137)."""
    ratio = math.sqrt(img_w / img_h)
    return int(max_size * ratio), int(max_size / ratio)


def _resize_and_discard(cfg: YolactConfig, image, masks, boxes, labels,
                        resize_gt=True):
    """Resize to the square (or AR-preserving) target + tiny-box discard
    (augmentations.py:129-180)."""
    import cv2
    img_h, img_w, _ = image.shape
    if cfg.preserve_aspect_ratio:
        width, height = calc_size_preserve_ar(img_w, img_h, cfg.max_size)
    else:
        width, height = cfg.max_size, cfg.max_size
    image = cv2.resize(image, (width, height))

    if resize_gt and boxes is not None:
        m = masks.transpose((1, 2, 0))
        m = cv2.resize(m, (width, height))
        if m.ndim == 2:
            m = m[None]
        else:
            m = m.transpose((2, 0, 1))
        masks = m
        boxes = boxes.copy()
        boxes[:, [0, 2]] = boxes[:, [0, 2]] * (width / img_w)
        boxes[:, [1, 3]] = boxes[:, [1, 3]] * (height / img_h)

    if boxes is not None:
        w = boxes[:, 2] - boxes[:, 0]
        h = boxes[:, 3] - boxes[:, 1]
        keep = (w > cfg.discard_box_width) * (h > cfg.discard_box_height)
        masks = masks[keep]
        boxes = boxes[keep]
        labels = dict(labels)
        labels['labels'] = labels['labels'][keep]
        labels['num_crowds'] = int((labels['labels'] < 0).sum())
    return image, masks, boxes, labels


def backbone_transform(cfg: YolactConfig, img: np.ndarray,
                       mean=MEANS, std=STD,
                       in_channel_order='BGR') -> np.ndarray:
    """Normalize + channel permute per backbone (augmentations.py:566-596).
    Input BGR float [0,255]; output float32 in backbone channel order."""
    t = cfg.backbone.transform
    img = img.astype(np.float32)
    mean = np.array(mean, dtype=np.float32)
    std = np.array(std, dtype=np.float32)
    if t.normalize:
        img = (img - mean) / std
    elif t.subtract_means:
        img = img - mean
    elif t.to_float:
        img = img / 255.0
    channel_map = {c: i for i, c in enumerate(in_channel_order)}
    perm = [channel_map[c] for c in t.channel_order]
    return img[:, :, perm].astype(np.float32)


class BaseTransform:
    """Eval-time transform (augmentations.py:601-612): resize + normalize."""

    def __init__(self, cfg: YolactConfig, mean=MEANS, std=STD):
        self.cfg = cfg
        self.mean = mean
        self.std = std

    def __call__(self, image, masks=None, boxes=None, labels=None):
        image = image.astype(np.float32)
        image, masks, boxes, labels = _resize_and_discard(
            self.cfg, image, masks, boxes, labels, resize_gt=False)
        image = backbone_transform(self.cfg, image, self.mean, self.std)
        return image, masks, boxes, labels
