"""Frozen plain copy of the port's ``detect/detection.py`` (the IoU max
in its plain version, no export branch).  Fixed-shape test-time
detection.  Port of ``yolact_tpu/detect/detection.py``.

Eval-branch scores, the ``conf > conf_thresh`` candidate filter as score
masking with a ``-1`` sentinel, box decode, fast NMS (per-class top-k,
pairwise IoU, strict-upper-triangle max) and the final top
``max_num_detections`` as padded detections with a validity mask.

The JAX ``vmap`` over images is an explicit batch dimension here, and its
one-hot-matmul row selection (a TPU trick) is a plain index gather.  The
IoU-max step runs the CUDA kernel of ``kernels/nms.py`` on the card.
Wherever JAX uses ``lax.top_k`` (lower index first on ties) this uses a
stable descending sort, so ties, padded entries included, come out in the
same order.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference.config import YolactConfig
from benchmark.reference.kernels.nms import nms_iou_max, nms_iou_max_plain
from benchmark.reference.ops.boxes import decode

class Detections(NamedTuple):
    """Padded per-image detections; `valid` marks real entries."""
    boxes: torch.Tensor    # [B, D, 4]  relative point form
    masks: torch.Tensor    # [B, D, mask_dim]  coefficients
    classes: torch.Tensor  # [B, D]  int32, 0-based foreground class
    scores: torch.Tensor   # [B, D]  float32 (-1 for padding)
    valid: torch.Tensor    # [B, D]  bool
    proto: torch.Tensor    # [B, Hp, Wp, mask_dim]


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: descending, lower index first on
    ties."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-image row gather: t [B, P, ...], idx [B, ...] -> t[b, idx[b]]."""
    b = torch.arange(t.shape[0], device=t.device)
    return t[b.view((-1,) + (1,) * (idx.dim() - 1)), idx]


def _iou_max(boxes_c: torch.Tensor, use_kernels: bool) -> torch.Tensor:
    shape = boxes_c.shape[:-1]
    flat = boxes_c.reshape(-1, shape[-1], 4)
    fn = nms_iou_max if use_kernels else nms_iou_max_plain
    return fn(flat).reshape(shape)


def _fast_nms(cfg: YolactConfig, boxes, coeffs, scores,
              second_threshold: bool, use_kernels: bool):
    """boxes [B,P,4], coeffs [B,P,Md], scores [B,C-1,P] (-1 where the prior
    failed the candidate filter)."""
    B, _, P = scores.shape
    top_k = min(cfg.nms_top_k, P)
    sorted_scores, idx = _top_k(scores, top_k)               # [B, C-1, k]
    iou_max = _iou_max(_rows(boxes, idx), use_kernels)       # [B, C-1, k]

    keep = (iou_max <= cfg.nms_thresh) & (sorted_scores > 0)
    if second_threshold:
        keep &= sorted_scores > cfg.nms_conf_thresh

    flat_scores = torch.where(keep, sorted_scores, -1.0).reshape(B, -1)
    n_out = min(cfg.max_num_detections, flat_scores.shape[1])
    out_scores, flat_idx = _top_k(flat_scores, n_out)

    classes = flat_idx // top_k
    orig_idx = torch.gather(idx.reshape(B, -1), 1, flat_idx)  # prior ids
    return (_rows(boxes, orig_idx), _rows(coeffs, orig_idx), classes,
            out_scores, out_scores > 0)


def _cc_fast_nms(cfg: YolactConfig, boxes, coeffs, scores, use_kernels: bool):
    """Class-collapsed fast NMS."""
    best_scores, classes_all = scores.max(dim=1)             # [B, P]
    sorted_scores, idx = _top_k(best_scores,
                                min(cfg.nms_top_k, best_scores.shape[1]))
    iou_max = _iou_max(_rows(boxes, idx), use_kernels)
    keep = (iou_max <= cfg.nms_thresh) & (sorted_scores > 0)

    flat_scores = torch.where(keep, sorted_scores, -1.0)
    n_out = min(cfg.max_num_detections, flat_scores.shape[1])
    out_scores, sel = _top_k(flat_scores, n_out)
    out_idx = torch.gather(idx, 1, sel)
    return (_rows(boxes, out_idx), _rows(coeffs, out_idx),
            torch.gather(classes_all, 1, out_idx), out_scores,
            out_scores > 0)


def eval_scores(cfg: YolactConfig,
                pred_outs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eval-branch score transform: raw conf logits -> per-class scores
    including the background column, float32."""
    conf = pred_outs['conf'].float()
    if cfg.use_focal_loss:
        if cfg.use_sigmoid_focal_loss:
            conf = torch.sigmoid(conf)
            if cfg.use_mask_scoring and 'score' in pred_outs:
                conf = conf * torch.sigmoid(pred_outs['score'].float())
        elif cfg.use_objectness_score:
            objness = torch.sigmoid(conf[..., 0])
            fg = objness[..., None] * torch.softmax(conf[..., 1:], dim=-1)
            conf = torch.cat([(1 - objness)[..., None], fg], dim=-1)
        else:
            conf = torch.softmax(conf, dim=-1)
    elif cfg.use_objectness_score:
        objness = torch.sigmoid(conf[..., 0])
        fg = (objness > 0.10)[..., None].to(conf.dtype) * \
            torch.softmax(conf[..., 1:], dim=-1)
        conf = torch.cat([conf[..., :1], fg], dim=-1)
    else:
        conf = torch.softmax(conf, dim=-1)
    return conf


def detect(cfg: YolactConfig, pred_outs: Dict[str, torch.Tensor],
           use_cross_class_nms: bool = False,
           second_threshold: bool = False,
           use_kernels: bool = True) -> Detections:
    """Batched fixed-shape fast-NMS detection over raw model outputs.

    ``use_kernels=False`` runs the plain PyTorch IoU max on the card too;
    it exists to compare the two paths."""
    loc = pred_outs['loc'].float()
    coeffs = pred_outs['mask'].float()
    priors = pred_outs['priors'].float()
    proto = pred_outs['proto'].float() if 'proto' in pred_outs else None

    scores_all = eval_scores(cfg, pred_outs)[..., 1:].transpose(1, 2)
    best = scores_all.max(dim=1).values                      # [B, P]
    cand = best > cfg.nms_conf_thresh
    scores_all = torch.where(cand[:, None, :], scores_all, -1.0)
    boxes = decode(loc, priors[None], cfg.use_yolo_regressors)

    def tail(b, c, s):
        if use_cross_class_nms:
            return _cc_fast_nms(cfg, b, c, s, use_kernels)
        return _fast_nms(cfg, b, c, s, second_threshold, use_kernels)

    # Candidate pruning: keep only the top-N priors by best class score
    # before the per-class sorts.  It is lossless whenever <= N priors pass
    # conf_thresh, which is checked here; otherwise the batch takes the
    # unpruned tail, so results are exact either way.  JAX decides with
    # lax.cond on the device; so does torch.cond here while torch.export
    # traces, and eager mode reads the predicate on the host (one device
    # sync per batch) and counts the tail it takes.
    n_cand = cfg.nms_candidates
    P = scores_all.shape[-1]

    def pruned(best, boxes, coeffs, scores_all):
        _, keep_idx = _top_k(best, n_cand)                   # [B, N]
        s = torch.gather(scores_all, 2,
                         keep_idx[:, None, :].expand(-1, scores_all.shape[1],
                                                     -1))
        ob, oc, cl, sc, va = tail(_rows(boxes, keep_idx),
                                  _rows(coeffs, keep_idx), s)
        # with a very small N the per-class flatten yields fewer slots than
        # the unpruned tail: pad with invalid entries so both agree in shape
        per_class = min(cfg.nms_top_k, P)
        n_out = min(cfg.max_num_detections, per_class if use_cross_class_nms
                    else scores_all.shape[1] * per_class)
        pad = n_out - sc.shape[1]
        if pad > 0:
            ob = F.pad(ob, (0, 0, 0, pad))
            oc = F.pad(oc, (0, 0, 0, pad))
            cl = F.pad(cl, (0, pad))
            sc = F.pad(sc, (0, pad), value=-1.0)
            va = F.pad(va, (0, pad))
        return ob, oc, cl, sc, va

    def full(best, boxes, coeffs, scores_all):
        return tail(boxes, coeffs, scores_all)

    operands = (best, boxes, coeffs, scores_all)
    if not (n_cand and n_cand < P):
        ob, oc, cl, sc, va = full(*operands)
    else:
        fits = cand.sum(dim=1).max() <= n_cand
        branch = pruned if bool(fits) else full
        ob, oc, cl, sc, va = branch(*operands)
    return Detections(ob, oc, cl.to(torch.int32), sc, va, proto)
