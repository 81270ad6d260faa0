"""Frozen plain copies of the port's host-side batch making for device
augmentation (``yolact_tpu_torch/data/augmentations.py``: ``resize_linear``
and ``RawResize``; ``data/coco.py:pad_batch`` without the ``multires``
targets): the reference makes the training batch again from the raw frames.
The loader's transports (bit-packed masks, the image rounded to uint8) are
a lossless packing and the rounding, which :func:`raw_batch` applies as the
loader does."""

from __future__ import annotations

import numpy as np


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


def pad_batch(imgs, targets, masks, num_crowds, max_gt: int = 100):
    """Fixed-shape batch: pads or truncates gt to `max_gt` per image
    (image [B, S, S, 3] float32, gt_boxes [B, max_gt, 4], gt_labels [B,
    max_gt] int32 with -1 for crowds and -2 for padding, gt_masks [B,
    max_gt, S, S] uint8 at 0.5, num_gts, num_crowds).  Truncation drops
    crowd annotations first, then the highest-index gts."""
    B = len(imgs)
    S = imgs[0].shape[0]
    out_img = np.stack(imgs).astype(np.float32)
    boxes = np.zeros((B, max_gt, 4), np.float32)
    labels = np.full((B, max_gt), -2, np.int32)
    out_masks = np.zeros((B, max_gt, S, S), np.uint8)
    n_gts = np.zeros(B, np.int32)
    n_crowds = np.zeros(B, np.int32)
    for i in range(B):
        t = np.asarray(targets[i], np.float32)
        m = np.asarray(masks[i])
        nc = int(num_crowds[i])
        n = len(t)
        if n > max_gt:
            n_keep_crowds = max(0, max_gt - (n - nc))
            drop = nc - n_keep_crowds
            if drop > 0:
                t = t[:n - drop]
                m = m[:n - drop]
                nc = n_keep_crowds
            if len(t) > max_gt:
                t = t[:max_gt]
                m = m[:max_gt]
            n = len(t)
        boxes[i, :n] = t[:, :4]
        labels[i, :n] = t[:, 4].astype(np.int32)
        out_masks[i, :n] = (m > 0.5).astype(np.uint8)
        n_gts[i] = n
        n_crowds[i] = nc
    return dict(image=out_img, gt_boxes=boxes, gt_labels=labels,
                gt_masks=out_masks, num_gts=n_gts, num_crowds=n_crowds)


def raw_batch(frames, cfg, max_gt: int) -> dict:
    """`frames`: (raw BGR uint8 image [H, W, 3], relative boxes [k, 4],
    masks [k, H, W] uint8, labels [k] with the crowd at -1) of a batch ->
    the padded batch the loader ships for device augmentation: each image
    and its masks resized to S x S (``RawResize``), padded (``pad_batch``),
    the image rounded and clipped to uint8 (``pack_images``)."""
    s = cfg.max_size
    imgs, targets, masks, crowds = [], [], [], []
    for frame, boxes, m, labels in frames:
        imgs.append(resize_linear(frame.astype(np.float32), s, s))
        masks.append(resize_linear(m.astype(np.float32), s, s, axis=1))
        targets.append(np.hstack([boxes, labels[:, None]]).astype(np.float32))
        crowds.append(int((labels < 0).sum()))
    batch = pad_batch(imgs, targets, masks, crowds, max_gt)
    batch['image'] = np.clip(np.round(batch['image']), 0, 255).astype(np.uint8)
    return batch
