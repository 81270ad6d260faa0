"""Custom mAP evaluator — COCOEval-parity, pycocotools-free: the port's
copy of ``yolact_tpu/eval/evaluator.py`` (host mask IoU only; the device
IoU inputs of ``prep_metrics`` come with ``eval/device_metrics.py``).

Behavioural port of the reference evaluator (``eval.py:386-581,1006-1045``):
per-class / per-IoU(0.5:0.95) score-sorted PR curves with 101-point
interpolation, greedy gt matching in score order, crowd-ignore semantics,
and the deterministic ``badhash`` image ordering.  The AP integration and
matching rules exist precisely to reproduce pycocotools' COCOeval numbers
(reference comment at eval.py:505-507).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence

import numpy as np

IOU_THRESHOLDS = tuple(x / 100 for x in range(50, 100, 5))


def badhash(x: int) -> int:
    """Deterministic image-id shuffle hash (eval.py:583-593)."""
    x = (((x >> 16) ^ x) * 0x045d9f3b) & 0xFFFFFFFF
    x = (((x >> 16) ^ x) * 0x045d9f3b) & 0xFFFFFFFF
    x = ((x >> 16) ^ x) & 0xFFFFFFFF
    return x


class APDataObject:
    """Score-sorted PR data for one (class, IoU) cell (eval.py:515-581)."""

    def __init__(self):
        self.data_points: List[tuple] = []
        self.num_gt_positives = 0

    def push(self, score: float, is_true: bool):
        self.data_points.append((score, is_true))

    def add_gt_positives(self, num_positives: int):
        self.num_gt_positives += num_positives

    def is_empty(self) -> bool:
        return len(self.data_points) == 0 and self.num_gt_positives == 0

    def get_ap(self) -> float:
        if self.num_gt_positives == 0:
            return 0
        data = sorted(self.data_points, key=lambda x: -x[0])
        flags = np.array([d[1] for d in data], bool)
        num_true = np.cumsum(flags)
        num_all = np.arange(1, len(data) + 1)
        precisions = num_true / num_all
        recalls = num_true / self.num_gt_positives

        # monotone non-increasing envelope (right-to-left max)
        precisions = np.maximum.accumulate(precisions[::-1])[::-1]

        # 101-point interpolation, nearest recall to the right
        x_range = np.arange(101) / 100
        indices = np.searchsorted(recalls, x_range, side='left')
        y = np.zeros(101)
        valid = indices < len(precisions)
        y[valid] = precisions[indices[valid]]
        return float(y.mean())


def make_ap_data(num_classes: int) -> Dict[str, list]:
    """ap_data[type][iou_idx][class_idx] (eval.py:891-895)."""
    return {
        'box': [[APDataObject() for _ in range(num_classes)]
                for _ in IOU_THRESHOLDS],
        'mask': [[APDataObject() for _ in range(num_classes)]
                 for _ in IOU_THRESHOLDS],
    }


def _np_box_iou(a: np.ndarray, b: np.ndarray, iscrowd=False) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    ix = np.clip(np.minimum(a[:, None, 2], b[None, :, 2]) -
                 np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    iy = np.clip(np.minimum(a[:, None, 3], b[None, :, 3]) -
                 np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = ix * iy
    aa = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    ab = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    denom = aa if iscrowd else aa + ab - inter
    return np.where(denom > 0, inter / np.where(denom > 0, denom, 1), 0)


def _np_mask_iou(a: np.ndarray, b: np.ndarray, iscrowd=False) -> np.ndarray:
    """a [n, h*w], b [m, h*w] float32."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    inter = a @ b.T
    aa = a.sum(axis=1)[:, None]
    ab = b.sum(axis=1)[None, :]
    denom = aa if iscrowd else aa + ab - inter
    return np.where(denom > 0, inter / np.where(denom > 0, denom, 1), 0)


def prep_metrics(ap_data, classes: Sequence[int],
                 box_scores: Sequence[float], mask_scores: Sequence[float],
                 boxes: np.ndarray, masks: np.ndarray,
                 gt_boxes: np.ndarray, gt_classes: Sequence[int],
                 gt_masks: np.ndarray, num_crowd: int) -> None:
    """Greedy AP matching for one image (eval.py:386-510).

    All coordinates absolute pixels; masks/gt_masks are [n, h, w] (bool or
    float); crowd annotations are the LAST `num_crowd` gt entries.
    """
    classes = [int(c) for c in classes]
    num_pred = len(classes)

    gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    gt_classes = [int(c) for c in gt_classes]
    n_gt_total = len(gt_classes)
    if num_crowd > 0:
        crowd_boxes, gt_boxes = gt_boxes[-num_crowd:], gt_boxes[:-num_crowd]
        crowd_classes, gt_classes = gt_classes[-num_crowd:], gt_classes[:-num_crowd]
    else:
        crowd_boxes = None
        crowd_classes = []

    boxes_f = np.asarray(boxes, np.float32).reshape(num_pred, 4)

    gt_masks = np.asarray(gt_masks, np.float32).reshape(n_gt_total, -1)
    if num_crowd > 0:
        crowd_masks, gt_masks = gt_masks[-num_crowd:], gt_masks[:-num_crowd]
    hw = int(np.prod(np.asarray(masks).shape[1:])) if num_pred else 1
    masks_f = np.asarray(masks, np.float32).reshape(num_pred, hw)
    mask_iou_cache = _np_mask_iou(masks_f, gt_masks)
    crowd_mask_iou = _np_mask_iou(masks_f, crowd_masks, iscrowd=True) \
        if num_crowd > 0 else None

    bbox_iou_cache = _np_box_iou(boxes_f, gt_boxes)
    crowd_bbox_iou = _np_box_iou(boxes_f, crowd_boxes, iscrowd=True) \
        if num_crowd > 0 else None

    box_scores = [float(s) for s in box_scores]
    mask_scores = [float(s) for s in mask_scores]
    box_indices = sorted(range(num_pred), key=lambda i: -box_scores[i])
    mask_indices = sorted(box_indices, key=lambda i: -mask_scores[i])

    num_gt = len(gt_classes)
    iou_types = [
        ('box', bbox_iou_cache, crowd_bbox_iou, box_scores, box_indices),
        ('mask', mask_iou_cache, crowd_mask_iou, mask_scores, mask_indices),
    ]

    # Vectorized greedy matching (semantics of eval.py:457-510, bit-equal).
    # One pass over all dets in score order per iou_type, with ALL 10 IoU
    # thresholds advanced simultaneously as a vector lane.  Greedy matching
    # is independent across classes (a det only matches same-class gts), so
    # a single global `used` matrix with per-det class masking reproduces
    # the reference's per-class loops exactly: each det takes, per
    # threshold, the lowest-index unused same-class gt of maximal IoU
    # strictly above the threshold (np.argmax's first-max rule == the
    # reference's `iou > max_iou_found` scan order).  Push order within
    # each APDataObject is the same filtered score order as the reference,
    # so equal-score tie-breaking in get_ap()'s stable sort is preserved.
    thr = np.asarray(IOU_THRESHOLDS, np.float64)
    T = len(IOU_THRESHOLDS)
    t_range = np.arange(T)
    classes_arr = np.asarray(classes, np.int64).reshape(-1)
    gt_classes_arr = np.asarray(gt_classes, np.int64).reshape(-1)
    crowd_classes_arr = np.asarray(crowd_classes, np.int64).reshape(-1)
    class_set = set(classes + gt_classes)
    gt_count = {c: int((gt_classes_arr == c).sum()) for c in class_set}

    for iou_type, iou_cache, crowd_cache, scores, indices in iou_types:
        idx = np.asarray(indices, np.int64)
        det_cls = classes_arr[idx]                                 # [N]
        N = len(idx)

        if num_crowd > 0 and N:
            # crowd IoU vs same-class crowd gts only, max over crowds
            crowd_ord = np.asarray(crowd_cache, np.float64)[idx]   # [N, C]
            ceq = crowd_classes_arr[None, :] == det_cls[:, None]
            crowd_max = np.where(ceq, crowd_ord, -1.0).max(axis=1)
            matched_crowd = crowd_max[None, :] > thr[:, None]      # [T, N]
        else:
            matched_crowd = np.zeros((T, N), bool)

        is_true = np.zeros((T, N), bool)
        if num_gt and N:
            iou_ord = np.asarray(iou_cache, np.float64)[idx]       # [N, G]
            eq = gt_classes_arr[None, :] == det_cls[:, None]       # [N, G]
            iou_ord = np.where(eq, iou_ord, -1.0)
            used = np.zeros((T, num_gt), bool)
            # a det whose best same-class IoU is <= the lowest threshold
            # can never match (matching is strict >) and never consumes a
            # gt at any threshold — only the rest need the sequential pass
            candidates = np.nonzero(iou_ord.max(axis=1) > thr[0])[0]
            for d in candidates:
                masked = np.where(used, -1.0, iou_ord[d][None, :])
                j = masked.argmax(axis=1)                          # [T]
                ok = masked[t_range, j] > thr                      # [T]
                used[t_range[ok], j[ok]] = True
                is_true[:, d] = ok

        keep = is_true | ~matched_crowd                            # [T, N]
        scores_ord = np.asarray([scores[i] for i in indices], np.float64)
        for _class in class_set:
            dsel = np.nonzero(det_cls == _class)[0]
            kt, tt = keep[:, dsel], is_true[:, dsel]
            if len(dsel) and kt.all() and not tt.any():
                # common case: no matches and no crowd hits for this class
                # -> every threshold pushes the identical false-positive
                # list; build the (score, False) pairs once
                pairs = list(zip(scores_ord[dsel].tolist(),
                                 (False,) * len(dsel)))
                for iou_idx in range(T):
                    ap_obj = ap_data[iou_type][iou_idx][_class]
                    ap_obj.add_gt_positives(gt_count[_class])
                    ap_obj.data_points.extend(pairs)
                continue
            for iou_idx in range(T):
                ap_obj = ap_data[iou_type][iou_idx][_class]
                ap_obj.add_gt_positives(gt_count[_class])
                k = kt[iou_idx]
                if len(dsel) and k.any():
                    ap_obj.data_points.extend(zip(
                        scores_ord[dsel[k]].tolist(),
                        tt[iou_idx][k].tolist()))


def calc_map(ap_data, class_names: Sequence[str],
             print_table: bool = True) -> Dict[str, Dict]:
    """Aggregate APs into the mAP table (eval.py:1006-1045)."""
    aps = [{'box': [], 'mask': []} for _ in IOU_THRESHOLDS]
    for _class in range(len(class_names)):
        for iou_idx in range(len(IOU_THRESHOLDS)):
            for iou_type in ('box', 'mask'):
                ap_obj = ap_data[iou_type][iou_idx][_class]
                if not ap_obj.is_empty():
                    aps[iou_idx][iou_type].append(ap_obj.get_ap())

    all_maps = {'box': OrderedDict(), 'mask': OrderedDict()}
    for iou_type in ('box', 'mask'):
        all_maps[iou_type]['all'] = 0
        for i, threshold in enumerate(IOU_THRESHOLDS):
            mAP = (sum(aps[i][iou_type]) / len(aps[i][iou_type]) * 100
                   if aps[i][iou_type] else 0)
            all_maps[iou_type][int(threshold * 100)] = mAP
        vals = all_maps[iou_type].values()
        all_maps[iou_type]['all'] = sum(vals) / (len(vals) - 1)

    if print_table:
        print_maps(all_maps)
    return {k: {j: round(u, 2) for j, u in v.items()}
            for k, v in all_maps.items()}


def print_maps(all_maps) -> None:
    make_row = lambda vals: (' %5s |' * len(vals)) % tuple(vals)
    make_sep = lambda n: ('-------+' * n)
    print()
    print(make_row([''] + [('.%d ' % x if isinstance(x, int) else x + ' ')
                           for x in all_maps['box'].keys()]))
    print(make_sep(len(all_maps['box']) + 1))
    for iou_type in ('box', 'mask'):
        print(make_row([iou_type] + ['%.2f' % x if x < 100 else '%.1f' % x
                                     for x in all_maps[iou_type].values()]))
    print(make_sep(len(all_maps['box']) + 1))
    print()
