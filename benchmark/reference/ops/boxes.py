"""Box geometry on tensors.  Port of ``yolact_tpu/ops/boxes.py``.

Boxes are ``[..., 4]`` in point form ``(x1, y1, x2, y2)`` or center-size
form ``(cx, cy, w, h)``, relative [0, 1] coordinates unless noted.  The
float operations are the JAX package's, in the same order, so results
agree to the last bit where both sides round the same way.
"""

from __future__ import annotations

from typing import Optional

import torch

# SSD encode/decode variances
VARIANCES = (0.1, 0.2)


def point_form(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    xy, wh = boxes[..., :2], boxes[..., 2:]
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


def center_size(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    lo, hi = boxes[..., :2], boxes[..., 2:]
    return torch.cat([(hi + lo) / 2, hi - lo], dim=-1)


def intersect(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection area: [..., A, 4] x [..., B, 4] -> [..., A, B]."""
    w = (torch.minimum(box_a[..., :, None, 2], box_b[..., None, :, 2])
         - torch.maximum(box_a[..., :, None, 0], box_b[..., None, :, 0])
         ).clamp(min=0)
    h = (torch.minimum(box_a[..., :, None, 3], box_b[..., None, :, 3])
         - torch.maximum(box_a[..., :, None, 1], box_b[..., None, :, 1])
         ).clamp(min=0)
    return w * h


def area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def jaccard(box_a: torch.Tensor, box_b: torch.Tensor,
            iscrowd: bool = False) -> torch.Tensor:
    """Pairwise IoU [..., A, B]; crowd mode divides by area(a) only.  The
    denominator is guarded: where it is not > 0 (zero-area pairs, or NaN
    from infinite or NaN coordinates) the IoU is 0."""
    inter = intersect(box_a, box_b)
    area_a = area(box_a)[..., :, None]
    area_b = area(box_b)[..., None, :]
    denom = area_a if iscrowd else area_a + area_b - inter
    pos = denom > 0
    return torch.where(pos, inter / torch.where(pos, denom, 1.0), 0.0)


def elemwise_box_iou(box_a: torch.Tensor, box_b: torch.Tensor
                     ) -> torch.Tensor:
    """IoU between aligned boxes [n, 4] x [n, 4] -> [n] (union clamped to
    >= 0.1, result to <= 1)."""
    max_xy = torch.minimum(box_a[..., 2:], box_b[..., 2:])
    min_xy = torch.maximum(box_a[..., :2], box_b[..., :2])
    wh = (max_xy - min_xy).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = (area(box_a) + area(box_b) - inter).clamp(min=0.1)
    return (inter / union).clamp(max=1.0)


def change(gt: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """Box2Pix -d_change metric: gt [..., G, 4] x priors [..., P, 4] (point
    form) -> [..., G, P]."""
    gt_w = (gt[..., 2] - gt[..., 0])[..., None]
    gt_h = (gt[..., 3] - gt[..., 1])[..., None]
    diff = gt[..., :, None, :] - priors[..., None, :, :]
    diff = diff / torch.stack([gt_w, gt_h, gt_w, gt_h], dim=-1)
    return -torch.sqrt((diff ** 2).sum(dim=-1))


def encode(matched: torch.Tensor, priors: torch.Tensor,
           use_yolo_regressors: bool = False) -> torch.Tensor:
    """Matched gt boxes (point form) against center-size priors -> the
    network's regression space; encode(decode(x)) == x."""
    if use_yolo_regressors:
        boxes = center_size(matched)
        return torch.cat([boxes[..., :2] - priors[..., :2],
                          torch.log(boxes[..., 2:] / priors[..., 2:])],
                         dim=-1)
    g_cxcy = ((matched[..., :2] + matched[..., 2:]) / 2 - priors[..., :2]) \
        / (VARIANCES[0] * priors[..., 2:])
    wh = (matched[..., 2:] - matched[..., :2]) / priors[..., 2:]
    # padded gt rows have wh == 0: log(0) = -inf would poison gradients
    g_wh = torch.log(wh.clamp(min=1e-12)) / VARIANCES[1]
    return torch.cat([g_cxcy, g_wh], dim=-1)


def log_sum_exp(x: torch.Tensor,
                x_max: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log-sum-exp over the last axis, stabilised by the GLOBAL max (not
    the row's), as the reference does, so OHEM scores match; the max takes
    no gradient.  `x_max`: that max where `x` is one rank's rows of the
    batch."""
    if x_max is None:
        x_max = x.detach().max()
    return torch.log(torch.exp(x - x_max).sum(dim=-1)) + x_max


def decode(loc: torch.Tensor, priors: torch.Tensor,
           use_yolo_regressors: bool = False) -> torch.Tensor:
    """Network regressions + center-size priors -> point-form boxes."""
    if use_yolo_regressors:
        boxes = torch.cat([loc[..., :2] + priors[..., :2],
                           priors[..., 2:] * torch.exp(loc[..., 2:])], dim=-1)
        return point_form(boxes)
    xy = priors[..., :2] + loc[..., :2] * VARIANCES[0] * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * VARIANCES[1])
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


def sanitize_coordinates(x1: torch.Tensor, x2: torch.Tensor, img_size: int,
                         padding: int = 0, cast: bool = True):
    """Scale relative coords to absolute, order them, pad and clamp to the
    image."""
    x1 = x1 * img_size
    x2 = x2 * img_size
    if cast:
        x1 = x1.to(torch.int32)
        x2 = x2.to(torch.int32)
    lo = torch.minimum(x1, x2)
    hi = torch.maximum(x1, x2)
    return (lo - padding).clamp(min=0), (hi + padding).clamp(max=img_size)


def crop(masks: torch.Tensor, boxes: torch.Tensor,
         padding: int = 1) -> torch.Tensor:
    """Zero mask pixels outside each box.  masks [h, w, n]; boxes [n, 4]
    relative point form.  Pixel (y, x) is kept where x1 <= x < x2 and
    y1 <= y < y2 after sanitising."""
    h, w, n = masks.shape
    x1, x2 = sanitize_coordinates(boxes[:, 0], boxes[:, 2], w, padding,
                                  cast=False)
    y1, y2 = sanitize_coordinates(boxes[:, 1], boxes[:, 3], h, padding,
                                  cast=False)
    xs = torch.arange(w, dtype=masks.dtype, device=masks.device)[None, :, None]
    ys = torch.arange(h, dtype=masks.dtype, device=masks.device)[:, None, None]
    keep = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
    return masks * keep.to(masks.dtype)
