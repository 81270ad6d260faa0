"""Anchor-GT matching, batched.  Port of ``yolact_tpu/train/matcher.py``.

Semantics of the reference ``match`` (``layers/box_utils.py:159-227``):

  1. IoU(gt, priors); each prior takes its best gt.
  2. Greedy force-match: repeatedly take the (gt, prior) pair with the
     globally highest remaining IoU, bind them (overlap pinned to 2 so it
     never thresholds out), and remove both from contention.
  3. Threshold: IoU < pos_thresh -> neutral (-1); < neg_thresh -> background.
  4. Crowd: non-positive priors whose crowd-IoU (inter/area_prior) exceeds
     ``crowd_iou_threshold`` become neutral.

Padded-GT convention (``data/coco.py:pad_batch``): ``gt_labels >= 0`` are
real objects, -1 marks crowds (at the tail), -2 marks padding.

JAX maps a per-image function over the batch and loops a fixed ``G`` trips;
here the batch dimension is written out and every trip of the greedy loop
serves all images at once.  The loop is sequential by nature: an eager loop
of ~15 small launches per trip, with no host sync inside.  Rows past an
image's last gt are padding and never match, so a caller that knows the
counts on the host (``num_gts`` of the batch, a numpy array) passes them and
the loop and the IoU matrix shrink to the largest count; the results are the
same.  Ties go to the lowest index everywhere, as JAX's ``argmax`` and
``top_k_lex``: ``torch.max`` / ``argmax`` return the first maximal value, and
the candidates come from a stable descending sort (``torch.topk`` promises
no order among equals).  The outputs carry no gradient (with
``use_prediction_matching`` the decoded predictions only enter comparisons),
so the whole function runs under ``no_grad``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from yolact_tpu_torch.config import YolactConfig
from yolact_tpu_torch.ops.boxes import (change, decode, encode, jaccard,
                                        point_form)


class MatchResult(NamedTuple):
    loc_t: torch.Tensor     # [B, P, 4] encoded regression targets
    conf_t: torch.Tensor    # [B, P] int64: 0 bg, -1 neutral, else class+1
    idx_t: torch.Tensor     # [B, P] int64 matched gt index
    gt_box_t: torch.Tensor  # [B, P, 4] matched gt box (point form)
    pos: torch.Tensor       # [B, P] bool


def _greedy_candidates(overlaps, best_overlap, best_idx, trips):
    """The IoU branch.  The loop only ever consults each gt's best
    REMAINING prior and every trip removes one prior for all gts, so a row's
    best remaining stays within its top-(G+1) candidates (IoU >= 0 > the -1
    consumption marker): the loop runs on the compacted [B, G, G+1] matrix."""
    b, g, p = overlaps.shape
    k = min(g + 1, p)
    order = torch.sort(overlaps, dim=2, descending=True, stable=True)
    sm, cand_idx = order.values[:, :, :k].clone(), order.indices[:, :, :k]
    rows = torch.arange(b, device=overlaps.device)
    for _ in range(trips):
        best_per_gt, best_k = sm.max(dim=2)                 # [B, G]
        top, j = best_per_gt.max(dim=1)                     # [B]
        i = cand_idx[rows, j, best_k[rows, j]]              # its best prior
        live = top > -0.5                                   # skip padded rows
        gone = (cand_idx == i[:, None, None]) & live[:, None, None]
        sm = torch.where(gone, -1.0, sm)
        sm[rows, j] = torch.where(live[:, None], -1.0, sm[rows, j])
        best_overlap[rows, i] = torch.where(live, 2.0, best_overlap[rows, i])
        best_idx[rows, i] = torch.where(live, j, best_idx[rows, i])
    return best_overlap, best_idx


def _greedy_full(overlaps, best_overlap, best_idx, trips, num_truth):
    """The ``use_change_matching`` branch: change values are unbounded below
    (they can sit under the -1 consumption marker), so the reference loop
    runs op for op on the full [B, G, P] matrix, num_truth trips per image,
    including its quirk that a consumed (-1) entry can outrank live ones."""
    ov = overlaps.clone()
    rows = torch.arange(ov.shape[0], device=ov.device)
    for t in range(trips):
        j = ov.amax(dim=2).argmax(dim=1)                    # [B]
        i = ov[rows, j].argmax(dim=1)                       # [B]
        live = t < num_truth
        cols = ov[rows, :, i]                               # [B, G]
        ov[rows, :, i] = torch.where(live[:, None], -1.0, cols)
        ov[rows, j] = torch.where(live[:, None], -1.0, ov[rows, j])
        best_overlap[rows, i] = torch.where(live, 2.0, best_overlap[rows, i])
        best_idx[rows, i] = torch.where(live, j, best_idx[rows, i])
    return best_overlap, best_idx


@torch.no_grad()
def match(cfg: YolactConfig, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
          priors: torch.Tensor, loc_pred: Optional[torch.Tensor] = None,
          num_gts: Optional[Sequence[int]] = None) -> MatchResult:
    """gt_boxes [B, G, 4] point form, gt_labels [B, G] integers, priors
    [P, 4] center-size; `loc_pred` [B, P, 4] under
    ``cfg.use_prediction_matching``.  `num_gts`: per-image counts of
    non-padding rows, known on the host (optional, see the module
    docstring)."""
    if num_gts is not None:
        g = max(1, min(int(max(num_gts)), gt_boxes.shape[1]))
        gt_boxes, gt_labels = gt_boxes[:, :g], gt_labels[:, :g]
    gt_boxes = gt_boxes.float()
    gt_labels = gt_labels.long()
    b, g = gt_labels.shape
    is_truth = gt_labels >= 0
    is_crowd = gt_labels == -1

    if cfg.use_prediction_matching:
        decoded = decode(loc_pred.float(), priors[None],
                         cfg.use_yolo_regressors)            # [B, P, 4]
    else:
        decoded = point_form(priors)[None]                   # [1, P, 4]

    if cfg.use_change_matching:
        overlaps = change(gt_boxes, decoded).expand(b, g, -1)
        overlaps = torch.where(is_truth[:, :, None], overlaps, -torch.inf)
        best_overlap, best_idx = overlaps.max(dim=1)         # [B, P]
        best_overlap, best_idx = _greedy_full(
            overlaps, best_overlap, best_idx, g, is_truth.sum(dim=1))
    else:
        overlaps = jaccard(gt_boxes, decoded).expand(b, g, -1)
        overlaps = torch.where(is_truth[:, :, None], overlaps, -1.0)
        best_overlap, best_idx = overlaps.max(dim=1)
        best_overlap, best_idx = _greedy_candidates(
            overlaps, best_overlap, best_idx, g)

    matches = torch.gather(gt_boxes, 1, best_idx[:, :, None].expand(-1, -1, 4))
    conf = torch.gather(gt_labels, 1, best_idx) + 1
    conf = torch.where(best_overlap < cfg.positive_iou_threshold, -1, conf)
    conf = torch.where(best_overlap < cfg.negative_iou_threshold, 0, conf)

    if cfg.crowd_iou_threshold < 1:
        crowd = jaccard(decoded, gt_boxes, iscrowd=True)      # [B, P, G]
        crowd = torch.where(is_crowd[:, None, :], crowd, 0.0)
        best_crowd = crowd.amax(dim=2)
        conf = torch.where(
            (conf <= 0) & (best_crowd > cfg.crowd_iou_threshold), -1, conf)

    loc = encode(matches, priors[None], cfg.use_yolo_regressors)
    return MatchResult(loc, conf, best_idx, matches, conf > 0)
