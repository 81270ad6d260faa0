"""Host-side image transforms: the training augmentation ``SSDAugmentation``
and the eval-time ``BaseTransform`` of ``yolact_tpu/data/augmentations.py``
with everything they call, copied for the port, in numpy alone: the module
needs no cv2.

The JAX package calls cv2 for two things, which are written out here:

* ``cv2.resize`` (INTER_LINEAR) on float32 images and masks:
  :func:`resize_linear` computes cv2's generic separable bilinear in its
  order (per-axis source positions in float64 rounded to float32, the
  horizontal pass over the source rows, then the vertical pass, each a
  float32 ``a * w0 + b * w1``; the horizontal weights are clamped at the
  borders, the vertical ones are not, only their rows; an exact 2x
  downscale of both axes is cv2's 2x2 cell average, summed in row order),
  so it equals cv2's generic path bit for bit.  cv2 rounds otherwise on two
  paths: Intel IPP, which cv2 builds may take for 1, 3 or 4 channels
  (within 1.6e-2 on the 0-255 scale), and the vectorised 2x2 average of 1
  or 4 channels, which sums in pairs (within one float32 ulp);
* ``cv2.cvtColor`` between BGR and HSV (float32, hue in degrees):
  :func:`bgr_to_hsv` and :func:`hsv_to_bgr` follow cv2's float formulas
  (``s = d / (|v| + FLT_EPSILON)``, ``h = 60 (..) / (d + FLT_EPSILON)``, the
  six hue sectors back), within 3.1e-5 of cv2 in hue and in BGR, exact in
  saturation and value.

Everything else is the JAX package's code: the same
``np.random.RandomState`` draws in the same order, so one seed gives the
same photometric distortion, expand, crop, mirror, flip and rot90, and the
reference quirks it keeps (``yolact_tpu/data/augmentations.py:9-15``):

  * the RandomSampleCrop IoU constraint is a no-op in most modes (the
    upstream bug kept at ``augmentations.py:339-347``);
  * RandomRot90 is gated on ``augment_random_flip`` (``augmentations.py:679``),
    not on ``augment_random_rot90``;
  * the tiny-box discard threshold (4/550) is compared against *absolute*
    pixel sizes after resize (``augmentations.py:170-178``), so it only
    drops degenerate boxes.

All functions operate jointly on (image BGR float [H,W,3], masks [N,H,W],
boxes absolute-or-relative point form [N,4], labels dict with 'labels' and
'num_crowds').
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from yolact_tpu_torch.config import MEANS, STD, YolactConfig

_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)
# cv2's HSV->BGR table: the (b, g, r) entries of (v, p, q, t) per sector
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """cv2 INTER_LINEAR along one axis: (first source index, second source
    index, their float32 weights) per output position.  The position is
    ``(d + 0.5) * scale - 0.5`` in float64 rounded to float32, with cv2's
    ``scale = 1 / (dst / src)``; `clamp_weights` (the horizontal pass)
    pins positions outside the source to its edge pixel with weight 1."""
    pos = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5)\
        .astype(np.float32)
    first = np.floor(pos)
    frac = pos - first
    first = first.astype(np.int64)
    if clamp_weights:
        frac[(first < 0) | (first >= src - 1)] = 0
    return (np.clip(first, 0, src - 1), np.clip(first + 1, 0, src - 1),
            np.float32(1) - frac, frac)


def _lerp(a: np.ndarray, taps, axis: int) -> np.ndarray:
    i0, i1, w0, w1 = taps
    shape = [1] * a.ndim
    shape[axis] = -1
    return (np.take(a, i0, axis) * w0.reshape(shape)
            + np.take(a, i1, axis) * w1.reshape(shape))


def resize_linear(a: np.ndarray, width: int, height: int,
                  axis: int = 0) -> np.ndarray:
    """Bilinear resize of float32 `a`'s axes ``(axis, axis + 1)`` to
    ``(height, width)`` in cv2.resize's INTER_LINEAR order (see the module
    docstring): ``axis=0`` for an [H, W, C] image, ``axis=1`` for [N, H, W]
    masks."""
    a = np.asarray(a, np.float32)
    h, w = a.shape[axis], a.shape[axis + 1]
    if (h, w) == (height, width):
        return a.copy()
    if (h, w) == (2 * height, 2 * width):       # cv2 takes INTER_AREA here
        def cell(p, q):
            index = [slice(None)] * a.ndim
            index[axis] = slice(p, None, 2)
            index[axis + 1] = slice(q, None, 2)
            return a[tuple(index)]
        return (((cell(0, 0) + cell(0, 1)) + cell(1, 0)) + cell(1, 1)) \
            * np.float32(0.25)
    out =_lerp(a, _linear_taps(w, width, True), axis + 1)
    return _lerp(out, _linear_taps(h, height, False), axis)


def bgr_to_hsv(image: np.ndarray) -> np.ndarray:
    """float32 BGR [..., 3] -> HSV with hue in degrees [0, 360), cv2's
    ``COLOR_BGR2HSV`` float formula."""
    image = np.asarray(image, np.float32)
    b, g, r = image[..., 0], image[..., 1], image[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    d = v - np.minimum(np.minimum(r, g), b)
    s = d / (np.abs(v) + _FLT_EPSILON)
    k = (60.0 / (d.astype(np.float64) + _FLT_EPSILON)).astype(np.float32)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + np.float32(120),
                          (r - g) * k + np.float32(240)))
    h = np.where(h < 0, h + np.float32(360), h)
    return np.stack([h, s, v], -1).astype(np.float32)


def hsv_to_bgr(image: np.ndarray) -> np.ndarray:
    """The inverse, cv2's ``COLOR_HSV2BGR`` float formula: hue wrapped
    into six sectors, each output channel one of v, v(1-s), v(1-sf),
    v(1-s(1-f))."""
    image = np.asarray(image, np.float32)
    h = image[..., 0] * np.float32(6.0 / 360.0)
    s, v = image[..., 1], image[..., 2]
    h = h - np.float32(6) * np.floor(h / np.float32(6))
    sector = np.floor(h).astype(np.int64)
    h = h - sector
    outside = (sector < 0) | (sector >= 6)
    sector = np.where(outside, 0, sector)
    h = np.where(outside, np.float32(0), h).astype(np.float32)
    one = np.float32(1)
    table = np.stack([v, v * (one - s), v * (one - s * h),
                      v * (one - s * (one - h))], -1)
    out = np.take_along_axis(table, _HSV_SECTORS[sector], -1)
    return np.where((s == 0)[..., None], v[..., None], out).astype(np.float32)


def calc_size_preserve_ar(img_w: int, img_h: int, max_size: int
                          ) -> Tuple[int, int]:
    """Area-preserving resize target (augmentations.py:131-137)."""
    ratio = math.sqrt(img_w / img_h)
    return int(max_size * ratio), int(max_size / ratio)


def _photometric_distort(rng, image):
    """PhotometricDistort (augmentations.py:504-525): brightness, then either
    [contrast, HSV jitter] or [HSV jitter, contrast]."""
    image = image.copy()
    if rng.randint(2):
        image += rng.uniform(-32, 32)

    order_first = bool(rng.randint(2))

    def contrast(im):
        if rng.randint(2):
            im *= rng.uniform(0.5, 1.5)
        return im

    def hsv_jitter(im):
        im = bgr_to_hsv(im)
        if rng.randint(2):
            im[:, :, 1] *= rng.uniform(0.5, 1.5)
        if rng.randint(2):
            im[:, :, 0] += rng.uniform(-18.0, 18.0)
            im[:, :, 0][im[:, :, 0] > 360.0] -= 360.0
            im[:, :, 0][im[:, :, 0] < 0.0] += 360.0
        return hsv_to_bgr(im)

    if order_first:
        image = hsv_jitter(contrast(image))
    else:
        image = contrast(hsv_jitter(image))
    return image


def _expand(rng, image, masks, boxes, mean):
    """Zoom-out onto a mean-filled canvas (augmentations.py:408-440)."""
    if rng.randint(2):
        return image, masks, boxes
    height, width, depth = image.shape
    ratio = rng.uniform(1, 4)
    left = rng.uniform(0, width * ratio - width)
    top = rng.uniform(0, height * ratio - height)

    eh, ew = int(height * ratio), int(width * ratio)
    expand_image = np.zeros((eh, ew, depth), dtype=image.dtype)
    expand_image[:, :, :] = mean
    expand_image[int(top):int(top + height),
                 int(left):int(left + width)] = image

    expand_masks = np.zeros((masks.shape[0], eh, ew), dtype=masks.dtype)
    expand_masks[:, int(top):int(top + height),
                 int(left):int(left + width)] = masks

    boxes = boxes.copy()
    boxes[:, :2] += (int(left), int(top))
    boxes[:, 2:] += (int(left), int(top))
    return expand_image, expand_masks, boxes


_CROP_MODES = (None, (0.1, None), (0.3, None), (0.7, None), (0.9, None),
               (None, None))


def _np_jaccard(box_a, box_b):
    max_xy = np.minimum(box_a[:, 2:], box_b[2:])
    min_xy = np.maximum(box_a[:, :2], box_b[:2])
    inter = np.clip(max_xy - min_xy, 0, None)
    inter = inter[:, 0] * inter[:, 1]
    area_a = (box_a[:, 2] - box_a[:, 0]) * (box_a[:, 3] - box_a[:, 1])
    area_b = (box_b[2] - box_b[0]) * (box_b[3] - box_b[1])
    return inter / (area_a + area_b - inter)


def _random_sample_crop(rng, image, masks, boxes, labels):
    """IoU-mode patch sampling with crowd handling
    (augmentations.py:279-405, including the kept upstream bug)."""
    height, width, _ = image.shape
    while True:
        mode = _CROP_MODES[rng.randint(len(_CROP_MODES))]
        if mode is None:
            return image, masks, boxes, labels
        min_iou, max_iou = mode
        min_iou = -np.inf if min_iou is None else min_iou
        max_iou = np.inf if max_iou is None else max_iou

        for _ in range(50):
            w = rng.uniform(0.3 * width, width)
            h = rng.uniform(0.3 * height, height)
            if h / w < 0.5 or h / w > 2:
                continue
            left = rng.uniform(width - w)
            top = rng.uniform(height - h)
            rect = np.array([int(left), int(top), int(left + w), int(top + h)])

            overlap = _np_jaccard(boxes, rect)
            # Kept reference bug: this condition is almost never triggered.
            if overlap.min() < min_iou and max_iou < overlap.max():
                continue

            centers = (boxes[:, :2] + boxes[:, 2:]) / 2.0
            m1 = (rect[0] < centers[:, 0]) * (rect[1] < centers[:, 1])
            m2 = (rect[2] > centers[:, 0]) * (rect[3] > centers[:, 1])
            keep = m1 * m2

            num_crowds = labels['num_crowds']
            crowd_mask = np.zeros(keep.shape, dtype=np.int32)
            if num_crowds > 0:
                crowd_mask[-num_crowds:] = 1
            if not keep.any() or np.sum(1 - crowd_mask[keep]) == 0:
                continue

            image_out = image[rect[1]:rect[3], rect[0]:rect[2], :]
            masks_out = masks[keep, rect[1]:rect[3], rect[0]:rect[2]].copy()
            boxes_out = boxes[keep, :].copy()
            labels = dict(labels)
            labels['labels'] = labels['labels'][keep]
            if num_crowds > 0:
                labels['num_crowds'] = int(np.sum(crowd_mask[keep]))

            boxes_out[:, :2] = np.maximum(boxes_out[:, :2], rect[:2]) - rect[:2]
            boxes_out[:, 2:] = np.minimum(boxes_out[:, 2:], rect[2:]) - rect[:2]
            return image_out, masks_out, boxes_out, labels


def _random_mirror(rng, image, masks, boxes):
    if rng.randint(2):
        _, width, _ = image.shape
        image = image[:, ::-1]
        masks = masks[:, :, ::-1]
        boxes = boxes.copy()
        boxes[:, 0::2] = width - boxes[:, 2::-2]
    return image, masks, boxes


def _random_flip(rng, image, masks, boxes):
    if rng.randint(2):
        height, _, _ = image.shape
        image = image[::-1, :]
        masks = masks[:, ::-1, :]
        boxes = boxes.copy()
        boxes[:, 1::2] = height - boxes[:, 3::-2]
    return image, masks, boxes


def _random_rot90(rng, image, masks, boxes):
    old_height, old_width, _ = image.shape
    k = rng.randint(4)
    image = np.rot90(image, k)
    masks = np.array([np.rot90(mask, k) for mask in masks]) \
        if len(masks) else masks.reshape((0,) + image.shape[:2])
    boxes = boxes.copy()
    for _ in range(k):
        boxes = np.array([[b[1], old_width - 1 - b[2], b[3],
                           old_width - 1 - b[0]] for b in boxes]) \
            if len(boxes) else boxes
        old_width, old_height = old_height, old_width
    return image, masks, boxes


def _resize_and_discard(cfg: YolactConfig, image, masks, boxes, labels,
                        resize_gt=True):
    """Resize to the square (or AR-preserving) target + tiny-box discard
    (augmentations.py:129-180)."""
    img_h, img_w, _ = image.shape
    if cfg.preserve_aspect_ratio:
        width, height = calc_size_preserve_ar(img_w, img_h, cfg.max_size)
    else:
        width, height = cfg.max_size, cfg.max_size
    image = resize_linear(image, width, height)

    if resize_gt and boxes is not None:
        masks = resize_linear(masks, width, height, axis=1)
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


def _pad_to(image, masks, width, height, mean, pad_gt=True):
    """Top-left pad onto a mean canvas (augmentations.py:98-127)."""
    im_h, im_w, depth = image.shape
    out = np.zeros((height, width, depth), dtype=image.dtype)
    out[:, :, :] = mean
    out[:im_h, :im_w] = image
    if pad_gt and masks is not None:
        m = np.zeros((masks.shape[0], height, width), dtype=masks.dtype)
        m[:, :im_h, :im_w] = masks
        masks = m
    return out, masks


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


class SSDAugmentation:
    """Training augmentation pipeline (augmentations.py:667-688).  Unseeded
    unless given `rng`, as the JAX package's trainer builds it."""

    def __init__(self, cfg: YolactConfig, mean=MEANS, std=STD,
                 rng: Optional[np.random.RandomState] = None):
        self.cfg = cfg
        self.mean = mean
        self.std = std
        self.rng = rng or np.random.RandomState()

    def __call__(self, image, masks, boxes, labels):
        cfg, rng = self.cfg, self.rng
        image = image.astype(np.float32)
        height, width, _ = image.shape
        boxes = boxes.copy()
        boxes[:, [0, 2]] *= width
        boxes[:, [1, 3]] *= height

        if cfg.augment_photometric_distort:
            image = _photometric_distort(rng, image)
        if cfg.augment_expand:
            image, masks, boxes = _expand(rng, image, masks, boxes, self.mean)
        if cfg.augment_random_sample_crop:
            image, masks, boxes, labels = _random_sample_crop(
                rng, image, masks, boxes, labels)
        if cfg.augment_random_mirror:
            image, masks, boxes = _random_mirror(rng, image, masks, boxes)
        if cfg.augment_random_flip:
            image, masks, boxes = _random_flip(rng, image, masks, boxes)
            # reference quirk: rot90 is gated on the flip flag too
            image, masks, boxes = _random_rot90(rng, image, masks, boxes)

        image, masks, boxes, labels = _resize_and_discard(
            cfg, image, masks, boxes, labels)
        if not cfg.preserve_aspect_ratio:
            image, masks = _pad_to(image, masks, cfg.max_size, cfg.max_size,
                                   self.mean)

        height, width, _ = image.shape
        boxes = boxes.copy()
        boxes[:, [0, 2]] /= width
        boxes[:, [1, 3]] /= height

        image = backbone_transform(self.cfg, image, self.mean, self.std)
        return image, masks, boxes, labels


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
