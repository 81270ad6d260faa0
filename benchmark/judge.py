"""How ``correct`` is decided for detections: the program's answers held
against the frozen plain reference on the same frames and weights.

The reference (``reference/``, float32, TF32 off) computes the whole of
``forward_and_detect`` again from the raw frames: preprocessing, trunk,
FPN, heads, its own detection and mask assembly, and for YOLACT++ the
mask scorer.  Two kinds of numbers are read, over every valid detection
of every judged batch:

* each program detection is judged by what it says.  Of the reference's
  priors, the one that explains it best is taken (the least of the
  largest gap in its four box coordinates and in its score for the
  detection's class); then ``box_gap`` (relative coordinates),
  ``score_gap``, ``mask_gap`` (the mean absolute gap, over the pixels of
  its crop, between its mask and the reference's mask of that prior:
  sigmoid over the reference's prototypes and coefficients, cropped to
  the detection's own box, so that a box a rounding away from a pixel
  edge does not move a whole row; the box is judged by ``box_gap``),
  ``mask_px_gap`` (the largest pixel's gap), ``score_logit_gap`` (the
  score gap as a gap of log-odds, ``log(s / (1 - s))``, where rounding
  of the logits shows at every score alike) and, for YOLACT++,
  ``mask_score_gap`` (the reference's score times its mask scorer's IoU
  of that mask) and ``scorer_gap``: the program's mask score against
  its own score times the reference's mask scorer on its own mask, the
  scorer judged on the inputs it was handed (the masks and scores are
  judged above).  A YOLACT++ answer with no mask scores reads a
  ``scorer_gap`` of 1 a detection, past any limit.  Each is summarised
  by its largest (``_max``), 99th percentile (``_p99``) and median
  (``_p50``);
* ``unmatched_share``: the detections of either side scoring at least
  ``SCORE_FLOOR`` that have no detection of the same image and class on
  the other side with every box coordinate within ``MATCH_TOL``, over all
  such detections of both sides, leaving out those whose fast-NMS
  decision rounding can turn (``nms_flips`` counts them): a detection
  that overlaps another reference prior (not the one that explains it)
  of the same class by an IoU within
  ``IOU_EPS`` of the NMS threshold or above it, where that prior scores
  within ``SCORE_EPS`` of it, or higher with the IoU within ``IOU_EPS``
  of the threshold.  A detection left out or made up moves the share.
"""

from __future__ import annotations

from typing import Dict, List

import torch

# a tenth over conf_thresh (0.05): twice the widest score gap of bf16
SCORE_FLOOR = 0.06
MATCH_TOL = 0.05
# an NMS decision rounding can turn: an overlap this near the threshold
# with a box scoring this near or higher (bf16 moves boxes by ~4e-4 and
# scores by ~1e-2 at most, PERF.md)
IOU_EPS = 0.02
SCORE_EPS = 0.01
GAPS = ('box_gap', 'score_gap', 'score_logit_gap', 'mask_gap', 'mask_px_gap',
        'mask_score_gap', 'scorer_gap')
# the scores' log-odds are read within this of 0 and 1
LOGIT_EPS = 1e-6


class ReferenceTables:
    """The reference's per-prior answers for one batch of frames, and its
    own detections."""

    def __init__(self, cfg, model, frames: torch.Tensor):
        self.nms_thresh = cfg.nms_thresh
        from benchmark.reference import infer as ref
        from benchmark.reference.detect.detection import detect, eval_scores
        from benchmark.reference.detect.postprocess import (
            postprocess_device, rescore_with_maskiou)
        from benchmark.reference.ops.boxes import decode

        with torch.no_grad():
            x = ref._prepare_input(cfg, frames, True)
            preds = model(x, use_kernels=False)
            self.scores = eval_scores(cfg, preds)[..., 1:].transpose(1, 2)
            self.boxes = decode(preds['loc'].float(),
                                preds['priors'].float()[None],
                                cfg.use_yolo_regressors)
            self.coeffs = preds['mask'].float()
            self.proto = preds['proto'].float()
            dets = detect(cfg, preds)
            masks, dets = postprocess_device(cfg, dets)
            self.dets = dets
            self.maskiou = model.maskiou_net if cfg.use_maskiou else None
            self.mask_scores = (rescore_with_maskiou(self.maskiou, masks, dets)
                                if self.maskiou is not None else None)


def _prior_masks(tables: ReferenceTables, b: int, prior: torch.Tensor,
                 boxes: torch.Tensor):
    """The reference's masks of `prior` cropped to `boxes` [n, 4], and the
    crops ([n, Hp, Wp] each)."""
    from benchmark.reference.kernels.mask_assembly import \
        assemble_masks_plain
    from benchmark.reference.ops.boxes import crop
    masks = assemble_masks_plain(tables.proto[b:b + 1],
                                 tables.coeffs[b, prior][None],
                                 boxes[None])[0]
    hp, wp = masks.shape[1:]
    ones = masks.new_ones((hp, wp, len(prior)))
    return masks, crop(ones, boxes).permute(2, 0, 1)


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.clamp(LOGIT_EPS, 1 - LOGIT_EPS)
    return torch.log(p) - torch.log1p(-p)


def _unmatched(a_boxes, a_classes, a_keep, b_boxes, b_classes, b_valid):
    """[n] bool: the `a_keep` detections of one image with no valid `b`
    detection of the same class and every box coordinate within
    MATCH_TOL."""
    close = ((a_boxes[:, None] - b_boxes[None]).abs().amax(-1) <= MATCH_TOL)
    same = a_classes[:, None] == b_classes[None]
    return a_keep & ~(close & same & b_valid[None]).any(1)


def _nms_flips(tables, b: int, boxes, classes, scores) -> torch.Tensor:
    """[n] bool: detections whose fast-NMS decision rounding can turn (the
    module docstring)."""
    from benchmark.reference.ops.boxes import jaccard
    iou = jaccard(boxes.float()[None], tables.boxes[b][None])[0]   # [n, P]
    gap = tables.scores[b][classes.long()] - scores[:, None]      # [n, P]
    # a detection's own prior, the one that explains it best, is no rival
    own = torch.maximum((boxes.float()[:, None] - tables.boxes[b][None])
                        .abs().amax(-1), gap.abs()).argmin(1)
    iou[torch.arange(len(own), device=own.device), own] = 0.0
    overlap = iou >= tables.nms_thresh - IOU_EPS
    near_iou = (iou - tables.nms_thresh).abs() <= IOU_EPS
    near_tie = gap.abs() <= SCORE_EPS
    return (overlap & ((near_iou & (gap >= -SCORE_EPS)) | near_tie)).any(1)


def _set_gap(out, ref, tables, b, counts) -> None:
    v = out.valid[b]
    p_keep = v & (out.scores[b] >= SCORE_FLOOR)
    r_keep = ref.valid[b] & (ref.scores[b] >= SCORE_FLOOR)
    counts['checked'] += int(p_keep.sum()) + int(r_keep.sum())
    for side, other, keep, valid in ((out, ref, p_keep, ref.valid[b]),
                                     (ref, out, r_keep, v)):
        lost = _unmatched(side.boxes[b], side.classes[b], keep,
                          other.boxes[b], other.classes[b], valid)
        if bool(lost.any()):
            flip = _nms_flips(tables, b, side.boxes[b][lost],
                              side.classes[b][lost], side.scores[b][lost])
            counts['nms_flips'] += int(flip.sum())
            counts['unmatched'] += int((~flip).sum())


def judge_batch(out, tables: ReferenceTables, gaps: Dict[str, List[float]],
                counts: Dict[str, int]) -> None:
    """Add one batch's readings: every valid program detection's gaps to
    `gaps`, and the matched-set counts to `counts`."""
    with torch.no_grad():
        ref = tables.dets
        for b in range(out.boxes.shape[0]):
            v = out.valid[b]
            _set_gap(out, ref, tables, b, counts)
            if not bool(v.any()):
                continue
            boxes, scores = out.boxes[b][v].float(), out.scores[b][v].float()
            classes = out.classes[b][v].long()
            ref_scores = tables.scores[b][classes]           # [n, P]
            box_gap = (boxes[:, None] - tables.boxes[b][None]).abs().amax(-1)
            score_gap = (scores[:, None] - ref_scores).abs()
            prior = torch.maximum(box_gap, score_gap).argmin(1)
            rows = torch.arange(len(prior), device=prior.device)
            gaps['box_gap'] += box_gap[rows, prior].tolist()
            gaps['score_gap'] += score_gap[rows, prior].tolist()
            gaps['score_logit_gap'] += (
                _logit(scores) - _logit(ref_scores[rows, prior])
            ).abs().tolist()
            ref_masks, inside = _prior_masks(tables, b, prior, boxes)
            gap = (out.masks[b][v].float() - ref_masks).abs()  # [n, Hp, Wp]
            gaps['mask_gap'] += ((gap * inside).sum((1, 2))
                                 / inside.sum((1, 2)).clamp_min(1)).tolist()
            gaps['mask_px_gap'] += gap.amax((1, 2)).tolist()
            if tables.maskiou is None:
                continue
            if out.mask_scores is None:
                gaps['scorer_gap'] += [1.0] * len(prior)
                continue
            mask_scores = out.mask_scores[b][v].float()
            iou = tables.maskiou(ref_masks[:, None])          # [n, C-1]
            want = ref_scores[rows, prior] * iou[rows, classes]
            gaps['mask_score_gap'] += (mask_scores - want).abs().tolist()
            iou = tables.maskiou(out.masks[b][v].float()[:, None])
            want = scores * iou[rows, classes]
            gaps['scorer_gap'] += (mask_scores - want).abs().tolist()


def summary(gaps: Dict[str, List[float]], counts: Dict[str, int]
            ) -> Dict[str, float]:
    """Every number the check can compare: each gap's largest, 99th
    percentile and median, the unmatched share, the detections judged."""
    from benchmark.record import quantile
    out = {'unmatched_share': counts['unmatched'] / max(1, counts['checked']),
           'set_checked': float(counts['checked']),
           'nms_flips': float(counts['nms_flips']),
           'detections': float(len(gaps['score_gap']))}
    for name in GAPS:
        values = gaps[name]
        if values:
            out[name + '_max'] = max(values)
            out[name + '_p99'] = quantile(values, 0.99)
            out[name + '_p50'] = quantile(values, 0.5)
    return out


def new_readings():
    return ({name: [] for name in GAPS},
            {'checked': 0, 'unmatched': 0, 'nms_flips': 0})
