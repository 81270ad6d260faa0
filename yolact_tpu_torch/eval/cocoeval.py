"""COCO-protocol evaluation over result JSON files (pycocotools-free): the
port's copy of ``yolact_tpu/eval/cocoeval.py``.

Standalone equivalent of the reference ``run_coco_eval.py`` (which feeds the
``--output_coco_json`` files to pycocotools' COCOeval).  This module
implements the COCOeval protocol itself — greedy matching against gt with
crowd-ignore, 10 IoU thresholds, area ranges (all/small/medium/large),
maxDets (1/10/100), 101-point precision interpolation, and the standard
12-number summary — over our own COCO index and RLE codec.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List

import numpy as np

from yolact_tpu_torch.data import rle as rle_codec

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
AREA_RANGES = {
    'all': (0, 1e10),
    'small': (0, 32 ** 2),
    'medium': (32 ** 2, 96 ** 2),
    'large': (96 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _box_iou(d: np.ndarray, g: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """xywh boxes; crowd gt use union=area(det) (maskApi bbIou semantics).
    Broadcast over the full [D, G] pair matrix (no Python pair loop)."""
    dx1, dy1, dw, dh = (d[:, i][:, None] for i in range(4))   # [D,1]
    gx1, gy1, gw, gh = (g[:, i][None, :] for i in range(4))   # [1,G]
    iw = np.minimum(dx1 + dw, gx1 + gw) - np.maximum(dx1, gx1)
    ih = np.minimum(dy1 + dh, gy1 + gh) - np.maximum(dy1, gy1)
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    union = np.where(iscrowd[None, :], dw * dh, dw * dh + gw * gh - inter)
    return np.where(inter > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def _mask_iou(d_rles: List, g_rles: List, iscrowd: np.ndarray) -> np.ndarray:
    d = np.stack([rle_codec.rle_to_mask(r).reshape(-1) for r in d_rles]) \
        .astype(np.float64) if d_rles else np.zeros((0, 1))
    g = np.stack([rle_codec.rle_to_mask(r).reshape(-1) for r in g_rles]) \
        .astype(np.float64) if g_rles else np.zeros((0, 1))
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    inter = d @ g.T
    da = d.sum(1)[:, None]
    ga = g.sum(1)[None, :]
    union = np.where(iscrowd[None, :], da, da + ga - inter)
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0)


class COCOEvalLite:
    """Evaluates detection results (list of COCO result dicts) against a gt
    instances json, reproducing pycocotools.COCOeval's accumulate/summarize.
    iou_type: 'bbox' or 'segm'."""

    def __init__(self, gt_json_path: str, results, iou_type: str = 'bbox'):
        with open(gt_json_path) as f:
            gt = json.load(f)
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        self.iou_type = iou_type
        self.imgs = {im['id']: im for im in gt['images']}
        self.cat_ids = sorted(c['id'] for c in gt.get('categories', []))

        self.gts = defaultdict(list)
        for ann in gt.get('annotations', []):
            a = dict(ann)
            if 'area' not in a:
                a['area'] = a['bbox'][2] * a['bbox'][3]
            self.gts[(a['image_id'], a['category_id'])].append(a)

        self.dts = defaultdict(list)
        for i, det in enumerate(results):
            d = dict(det)
            d['id'] = i + 1
            if 'bbox' not in d and 'segmentation' in d:
                m = rle_codec.rle_to_mask(_norm_rle(d['segmentation']))
                ys, xs = np.where(m)
                if len(xs):
                    d['bbox'] = [float(xs.min()), float(ys.min()),
                                 float(xs.max() - xs.min() + 1),
                                 float(ys.max() - ys.min() + 1)]
                else:
                    d['bbox'] = [0., 0., 0., 0.]
            d['area'] = (d['bbox'][2] * d['bbox'][3]) if iou_type == 'bbox' \
                else self._seg_area(d)
            self.dts[(d['image_id'], d['category_id'])].append(d)

        self.img_ids = sorted({k[0] for k in list(self.gts) + list(self.dts)})

    def _seg_area(self, d):
        if 'segmentation' in d:
            return float(rle_codec.area(_norm_rle(d['segmentation'])))
        return d['bbox'][2] * d['bbox'][3]

    def _gt_segm(self, ann, img):
        h, w = img['height'], img['width']
        return rle_codec.mask_to_rle(
            rle_codec.ann_to_mask(ann['segmentation'], h, w))

    def _ious(self, img_id, cat_id):
        gts = self.gts[(img_id, cat_id)]
        dts = sorted(self.dts[(img_id, cat_id)],
                     key=lambda d: -d['score'])[:max(MAX_DETS)]
        if not gts or not dts:
            return np.zeros((len(dts), len(gts))), gts, dts
        iscrowd = np.array([bool(g.get('iscrowd')) for g in gts])
        if self.iou_type == 'bbox':
            d = np.array([d['bbox'] for d in dts], np.float64)
            g = np.array([g['bbox'] for g in gts], np.float64)
            return _box_iou(d, g, iscrowd), gts, dts
        img = self.imgs[img_id]
        d_rles = [_norm_rle(d['segmentation']) for d in dts]
        g_rles = [self._gt_segm(g, img) for g in gts]
        return _mask_iou(d_rles, g_rles, iscrowd), gts, dts

    def evaluate(self) -> Dict[str, float]:
        T, R = len(IOU_THRS), len(REC_THRS)
        K = len(self.cat_ids)
        A = len(AREA_RANGES)
        M = len(MAX_DETS)
        counts = np.full((T, R, K, A, M), -1.0)
        recalls = np.full((T, K, A, M), -1.0)

        area_items = list(AREA_RANGES.items())
        for k, cat_id in enumerate(self.cat_ids):
            # per-image matches cached once per category
            per_img = []
            for img_id in self.img_ids:
                ious, gts, dts = self._ious(img_id, cat_id)
                per_img.append((ious, gts, dts))

            for a, (_aname, (amin, amax)) in enumerate(area_items):
                for m, max_det in enumerate(MAX_DETS):
                    scores_all, tps_all, n_gt = [], [], 0
                    for ious, gts, dts in per_img:
                        dts_m = dts[:max_det]
                        # closed interval [amin, amax] like pycocotools
                        # (boundary areas belong to BOTH adjacent ranges)
                        gt_ig_raw = np.array(
                            [bool(g.get('iscrowd')) or
                             g['area'] < amin or g['area'] > amax
                             for g in gts],
                            bool) if gts else np.zeros(0, bool)
                        n_gt += int((~gt_ig_raw).sum())
                        if not dts_m:
                            continue
                        # pycocotools sorts gt with ignored entries LAST so
                        # the matcher can break once it reaches them
                        gt_order = np.argsort(gt_ig_raw, kind='stable')
                        gt_ig = gt_ig_raw[gt_order]
                        gt_crowd = np.array(
                            [bool(gts[j].get('iscrowd')) for j in gt_order],
                            bool)
                        ious_s = ious[:, gt_order] if len(gts) else ious

                        tps = np.zeros((T, len(dts_m)), bool)
                        ignore = np.zeros((T, len(dts_m)), bool)
                        for t, thr in enumerate(IOU_THRS):
                            gt_used = np.zeros(len(gts), bool)
                            for di, d in enumerate(dts_m):
                                best = min(thr, 1 - 1e-10)
                                bj = -1
                                for gj in range(len(gts)):
                                    # matched gt can't match again unless
                                    # it's a crowd (pycocotools: gtm>0 and
                                    # not iscrowd -> skip) — this applies
                                    # to IGNORED matches too
                                    if gt_used[gj] and not gt_crowd[gj]:
                                        continue
                                    # matched a real gt and reached the
                                    # ignored tail: stop
                                    if bj > -1 and not gt_ig[bj] and gt_ig[gj]:
                                        break
                                    if ious_s[di, gj] < best:
                                        continue
                                    best = ious_s[di, gj]
                                    bj = gj
                                if bj == -1:
                                    # unmatched det outside the area range
                                    # is ignored, not an FP (closed
                                    # interval like pycocotools)
                                    ignore[t, di] = (d['area'] < amin or
                                                     d['area'] > amax)
                                    continue
                                gt_used[bj] = True
                                if gt_ig[bj]:
                                    ignore[t, di] = True
                                else:
                                    tps[t, di] = True
                        scores_all.append(
                            np.array([d['score'] for d in dts_m]))
                        tps_all.append((tps, ignore))

                    if n_gt == 0:
                        continue
                    if not scores_all:
                        counts[:, :, k, a, m] = 0
                        recalls[:, k, a, m] = 0
                        continue
                    scores = np.concatenate(scores_all)
                    order = np.argsort(-scores, kind='mergesort')
                    tp_cat = np.concatenate([t for t, _ in tps_all], axis=1)[:, order]
                    ig_cat = np.concatenate([i for _, i in tps_all], axis=1)[:, order]

                    for t in range(T):
                        keep = ~ig_cat[t]
                        tp = tp_cat[t][keep]
                        fp = ~tp
                        tp_cum = np.cumsum(tp)
                        fp_cum = np.cumsum(fp)
                        rc = tp_cum / n_gt
                        pr = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
                        recalls[t, k, a, m] = rc[-1] if len(rc) else 0
                        # precision envelope
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side='left')
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        counts[:, :, k, a, m][t] = q

        self.precision = counts
        self.recall = recalls
        return self.summarize()

    def _summ(self, ap=True, iou_thr=None, area='all', max_dets=100):
        a = list(AREA_RANGES).index(area)
        m = MAX_DETS.index(max_dets)
        if ap:
            s = self.precision
            if iou_thr is not None:
                t = np.where(np.isclose(IOU_THRS, iou_thr))[0]
                s = s[t]
            s = s[:, :, :, a, m]
        else:
            s = self.recall
            if iou_thr is not None:
                t = np.where(np.isclose(IOU_THRS, iou_thr))[0]
                s = s[t]
            s = s[:, :, a, m]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self, print_out: bool = True) -> Dict[str, float]:
        stats = {
            'AP': self._summ(True),
            'AP50': self._summ(True, 0.5),
            'AP75': self._summ(True, 0.75),
            'APs': self._summ(True, area='small'),
            'APm': self._summ(True, area='medium'),
            'APl': self._summ(True, area='large'),
            'AR1': self._summ(False, max_dets=1),
            'AR10': self._summ(False, max_dets=10),
            'AR100': self._summ(False),
            'ARs': self._summ(False, area='small'),
            'ARm': self._summ(False, area='medium'),
            'ARl': self._summ(False, area='large'),
        }
        if print_out:
            tname = 'bbox' if self.iou_type == 'bbox' else 'segm'
            for key, v in stats.items():
                print(f' [{tname}] {key:6s} = {v:.3f}')
        return stats


def _norm_rle(seg):
    counts = seg['counts']
    if isinstance(counts, str):
        counts = counts.encode('ascii')
    return {'size': seg['size'], 'counts': counts}
