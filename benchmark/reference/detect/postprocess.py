"""Mask assembly at prototype resolution, YOLACT++ mask re-scoring and the
upsample to image size.  Port of ``yolact_tpu/detect/postprocess.py``
(``postprocess_device``, ``select_class_maskiou``, ``rescore_with_maskiou``,
``upsample_masks_device``, ``finish_masks`` for lincomb masks and
``finish_masks_direct`` for direct ones).

The standard sigmoid + crop configuration runs the fused CUDA kernel of
``kernels/mask_assembly.py`` (under the same condition as the JAX package
takes its Pallas kernel).  Other mask activations and uncropped masks are
a different computation and use the plain composition, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.config import MaskType, YolactConfig
from benchmark.reference.detect.detection import Detections
from benchmark.reference.kernels.mask_assembly import (assemble_masks,
                                                    assemble_masks_plain)
from benchmark.reference.models.heads import FastMaskIoUNet
from benchmark.reference.ops.boxes import crop
from benchmark.reference.ops.resize import resize_bilinear_np


def _threshold(dets: Detections, score_threshold: float) -> Detections:
    valid = dets.valid
    if score_threshold > 0:
        valid = valid & (dets.scores > score_threshold)
    return dets._replace(valid=valid)


def postprocess_device(cfg: YolactConfig, dets: Detections,
                       crop_masks: bool = True,
                       score_threshold: float = 0.0,
                       use_kernels: bool = True):
    """Returns (masks [B, D, Hp, Wp] activated and cropped, dets with the
    score threshold applied to `valid`).  ``use_kernels=False`` runs the
    plain PyTorch mask assembly on the card too, to compare the two."""
    proto = dets.proto            # [B, Hp, Wp, Md]
    coeffs = dets.masks           # [B, D, Md]
    B, D = coeffs.shape[:2]

    if not cfg.eval_mask_branch or \
            (proto is None and cfg.mask_type != MaskType.DIRECT):
        # box-only mode: zero 1x1 masks keep the fixed-shape outputs
        return coeffs.new_zeros((B, D, 1, 1)), _threshold(dets, score_threshold)

    if cfg.mask_type == MaskType.DIRECT:
        # direct masks: the head's mask output is the mask itself
        S = cfg.mask_size
        return coeffs.reshape(B, D, S, S), _threshold(dets, score_threshold)

    if (crop_masks and cfg.mask_proto_crop
            and cfg.mask_proto_mask_activation == 'sigmoid'):
        fn = assemble_masks if use_kernels else assemble_masks_plain
        masks = fn(proto, coeffs, dets.boxes)
    else:
        m = torch.einsum('bhwc,bdc->bhwd', proto, coeffs)
        if cfg.mask_proto_mask_activation == 'sigmoid':
            m = torch.sigmoid(m)
        elif cfg.mask_proto_mask_activation == 'relu':
            m = torch.relu(m)
        if crop_masks and cfg.mask_proto_crop:
            m = torch.stack([crop(mi, bi) for mi, bi in zip(m, dets.boxes)])
        masks = m.permute(0, 3, 1, 2)
    return masks, _threshold(dets, score_threshold)


def select_class_maskiou(iou_p: torch.Tensor,
                         classes: torch.Tensor) -> torch.Tensor:
    """[B, D, C-1] per-class maskiou -> [B, D] at each detection's class."""
    cls = classes.long().clamp(0, iou_p.shape[-1] - 1)
    return torch.gather(iou_p, -1, cls[..., None])[..., 0]


def rescore_with_maskiou(maskiou_net: FastMaskIoUNet, masks: torch.Tensor,
                         dets: Detections) -> torch.Tensor:
    """Run the mask scorer on the assembled [B, D, Hp, Wp] masks (every
    slot, padding included) and multiply its score at each detection's
    class into the detection score -> mask_scores [B, D]."""
    B, D, Hp, Wp = masks.shape
    iou_p = maskiou_net(masks.reshape(B * D, 1, Hp, Wp))
    return dets.scores * select_class_maskiou(iou_p.reshape(B, D, -1),
                                              dets.classes)


def upsample_masks_device(masks: torch.Tensor, size: Tuple[int, int],
                          binarize: bool = True) -> torch.Tensor:
    """[B, D, Hp, Wp] -> [B, D, h, w]: bilinear upsample (half-pixel
    centres, ``F.interpolate(align_corners=False)``, the reference's
    ``output_utils.py:91-94``) and, with ``binarize``, ``> 0.5``."""
    out = F.interpolate(masks.float(), size=tuple(size), mode='bilinear',
                        align_corners=False)
    return out > 0.5 if binarize else out


def finish_masks(masks: torch.Tensor, w: int, h: int) -> np.ndarray:
    """Proto-resolution lincomb masks [D, Hp, Wp] (on any device) ->
    binary [D, h, w] numpy masks at image size.  The upsample runs where
    the masks are (on the card in the eval loop); JAX's host version
    imitates this ``F.interpolate`` with a separable matmul."""
    masks = torch.as_tensor(masks)
    if masks.shape[0] == 0:
        return np.zeros((0, h, w), dtype=bool)
    return upsample_masks_device(masks[None], (h, w))[0].cpu().numpy()


def finish_masks_direct(masks, boxes_abs: np.ndarray, w: int,
                        h: int) -> np.ndarray:
    """Direct masks (``MaskType.DIRECT``) on the host: ``masks`` [D, S, S]
    sigmoid patches (tensor or array, any device), ``boxes_abs`` [D, 4]
    sanitised absolute integer boxes (``eval/evaluate.py:
    sanitize_boxes_np``) -> binary [D, h, w] numpy masks.  Each patch is
    resized to its box by the reference's bilinear (``F.interpolate``,
    half-pixel centres, ``output_utils.py:101-120``) in JAX's separable
    host form (``ops/resize.py``), binarised at 0.5 and pasted into a zero
    canvas; a box with no area is skipped, as the reference's guard
    does."""
    masks = torch.as_tensor(masks).detach().float().cpu().numpy()
    boxes_abs = np.asarray(boxes_abs)
    full = np.zeros((masks.shape[0], h, w), dtype=bool)
    for j in range(masks.shape[0]):
        x1, y1, x2, y2 = (int(v) for v in boxes_abs[j])
        mask_w, mask_h = x2 - x1, y2 - y1
        if mask_w * mask_h <= 0 or mask_w < 0:
            continue
        patch = resize_bilinear_np(masks[j:j + 1], (mask_h, mask_w))[0]
        full[j, y1:y2, x1:x2] = patch > 0.5
    return full
