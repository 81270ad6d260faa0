"""Traditional (greedy, per-class) NMS: the model on the device, the NMS on
the host.  Port of ``yolact_tpu/eval/traditional.py``.

The host half is a copy of the JAX package's (``traditional_nms``,
``host_assemble_masks``, ``_greedy_nms``), with semantics of
``Detect.traditional_nms`` (``detection.py:182-228``): per-class confidence
filter, greedy suppression with +1-convention pixel areas (boxes scaled by
max_size), global score sort capped at ``max_num_detections``.  The O(n^2)
suppression loop runs in the native helper (``yolact_tpu_torch/native``)
where it builds, else in numpy.  :func:`infer.forward_raw` runs on the
card; the kept detections are assembled into masks on the host (direct
masks: their patches as they are), padded to
``max_num_detections`` and, for YOLACT++ configs, re-scored by the mask
scorer on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from yolact_tpu_torch.config import MaskType, YolactConfig
from yolact_tpu_torch.detect.postprocess import select_class_maskiou
from yolact_tpu_torch.infer import (InferenceOutput, check_device,
                                    forward_raw, load_model)
from yolact_tpu_torch.native import get_native


def _greedy_nms(dets: np.ndarray, thresh: float) -> np.ndarray:
    native = get_native()
    if native is not None:
        keep = native.greedy_nms(dets, thresh)
        return np.sort(keep)  # reference returns original-order indices
    # numpy version, for a host without g++
    x1, y1, x2, y2, sc = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = sc.argsort()[::-1]
    suppressed = np.zeros(len(dets), bool)
    keep = []
    for _i in range(len(order)):
        i = order[_i]
        if suppressed[i]:
            continue
        keep.append(i)
        for _j in range(_i + 1, len(order)):
            j = order[_j]
            if suppressed[j]:
                continue
            w = max(0.0, min(x2[i], x2[j]) - max(x1[i], x1[j]) + 1)
            h = max(0.0, min(y2[i], y2[j]) - max(y1[i], y1[j]) + 1)
            inter = w * h
            if inter / (areas[i] + areas[j] - inter) >= thresh:
                suppressed[j] = True
    return np.array(sorted(keep), np.int64)


def host_assemble_masks(proto: np.ndarray, coeffs: np.ndarray,
                        boxes: np.ndarray, padding: int = 1,
                        crop: bool = True) -> np.ndarray:
    """Host mask assembly for the traditional-NMS path: sigmoid(proto @
    coeffs.T) cropped by boxes (output_utils.py:69-74), numpy."""
    hp, wp, _ = proto.shape
    n = coeffs.shape[0]
    m = proto.reshape(-1, proto.shape[-1]) @ coeffs.T          # [hp*wp, n]
    m = 1.0 / (1.0 + np.exp(-m))
    m = m.reshape(hp, wp, n)
    if n and crop:
        x1 = np.clip(np.minimum(boxes[:, 0], boxes[:, 2]) * wp - padding,
                     0, None)
        x2 = np.clip(np.maximum(boxes[:, 0], boxes[:, 2]) * wp + padding,
                     None, wp)
        y1 = np.clip(np.minimum(boxes[:, 1], boxes[:, 3]) * hp - padding,
                     0, None)
        y2 = np.clip(np.maximum(boxes[:, 1], boxes[:, 3]) * hp + padding,
                     None, hp)
        cols = np.arange(wp)[None, :, None]
        rows = np.arange(hp)[:, None, None]
        keep = ((cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2))
        m = m * keep
    return np.transpose(m, (2, 0, 1))                          # [n, hp, wp]


def traditional_nms(cfg: YolactConfig, boxes: np.ndarray, coeffs: np.ndarray,
                    scores: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """boxes [P,4] relative point form; coeffs [P,Md]; scores [C-1,P].
    Returns (boxes, coeffs, classes, scores) of the kept detections."""
    num_classes = scores.shape[0]
    boxes_px = boxes * cfg.max_size

    idx_lst, cls_lst, scr_lst = [], [], []
    for _cls in range(num_classes):
        cls_scores = scores[_cls]
        conf_mask = cls_scores > cfg.nms_conf_thresh
        idx = np.arange(len(cls_scores))[conf_mask]
        cls_scores = cls_scores[conf_mask]
        if len(cls_scores) == 0:
            continue
        preds = np.concatenate(
            [boxes_px[conf_mask], cls_scores[:, None]], axis=1
        ).astype(np.float32)
        keep = _greedy_nms(preds, cfg.nms_thresh)
        idx_lst.append(idx[keep])
        cls_lst.append(np.full(len(keep), _cls, np.int64))
        scr_lst.append(cls_scores[keep])

    if not idx_lst:
        e = np.zeros(0)
        return e.reshape(0, 4), e.reshape(0, coeffs.shape[1]), \
            e.astype(np.int64), e

    idx = np.concatenate(idx_lst)
    classes = np.concatenate(cls_lst)
    out_scores = np.concatenate(scr_lst)

    order = np.argsort(-out_scores, kind='stable')[:cfg.max_num_detections]
    idx = idx[order]
    return boxes[idx], coeffs[idx], classes[order], out_scores[order]


class TraditionalPipeline:
    """``infer.Pipeline``'s counterpart for ``--fast_nms=False``, with the
    same ``InferenceOutput`` contract: padded detections, proto-resolution
    cropped sigmoid masks (1x1 zeros without a mask branch) and, for
    YOLACT++ configs, ``mask_scores``.  Outputs are tensors on the
    pipeline's device."""

    def __init__(self, cfg: YolactConfig, state_dict: Dict[str, torch.Tensor],
                 device: Union[str, torch.device],
                 compute_dtype: Optional[str] = None,
                 score_threshold: float = 0.0, preprocess: bool = False,
                 crop_masks: bool = True, use_kernels: bool = True):
        self.cfg = cfg
        self.device = check_device(device)
        self.model = load_model(cfg, state_dict, self.device, compute_dtype)
        self.score_threshold = score_threshold
        self.preprocess = preprocess
        self.crop_masks = crop_masks
        self.use_kernels = use_kernels

    def __call__(self, images) -> InferenceOutput:
        cfg = self.cfg
        with torch.inference_mode():
            images = torch.as_tensor(images, device=self.device)
            raw = forward_raw(cfg, self.model, images, self.preprocess,
                              self.use_kernels)
        boxes, scores, coeffs = (t.cpu().numpy() for t in raw[:3])
        proto = raw[3].cpu().numpy() if raw[3] is not None else None
        B, D = boxes.shape[0], cfg.max_num_detections
        # direct masks: the mask rows are the sigmoid patches themselves
        direct = cfg.mask_type == MaskType.DIRECT
        if direct:
            hp = wp = cfg.mask_size
        else:
            hp, wp = (1, 1) if proto is None else proto.shape[1:3]
        ob = np.zeros((B, D, 4), np.float32)
        oc = np.zeros((B, D), np.int32)
        os_ = np.full((B, D), -1.0, np.float32)
        om = np.zeros((B, D, hp, wp), np.float32)
        ov = np.zeros((B, D), bool)
        for b in range(B):
            bb, cc, cls, sc = traditional_nms(cfg, boxes[b], coeffs[b],
                                              scores[b])
            n = min(len(sc), D)
            ob[b, :n] = bb[:n]
            oc[b, :n] = cls[:n]
            os_[b, :n] = sc[:n]
            ov[b, :n] = sc[:n] > self.score_threshold \
                if self.score_threshold > 0 else True
            if n and direct:
                om[b, :n] = cc[:n].reshape(n, hp, wp)
            elif n and proto is not None:
                om[b, :n] = host_assemble_masks(proto[b], cc[:n], bb[:n],
                                                crop=self.crop_masks)
        dev = self.device
        out = InferenceOutput(*(torch.from_numpy(a).to(dev)
                                for a in (ob, oc, os_, om, ov)))
        net = self.model.maskiou_net
        if net is not None and cfg.eval_mask_branch and not direct:
            # the reference re-scores in postprocess, after either NMS
            # (output_utils.py:79-88)
            with torch.inference_mode():
                iou_p = net(out.masks.reshape(B * D, 1, hp, wp))
                out = out._replace(mask_scores=out.scores * select_class_maskiou(
                    iou_p.reshape(B, D, -1), out.classes))
        return out
