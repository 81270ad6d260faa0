"""Mask assembly at prototype resolution.  Port of
``yolact_tpu/detect/postprocess.py:postprocess_device``.

The standard sigmoid + crop configuration runs the fused CUDA kernel of
``kernels/mask_assembly.py`` (under the same condition as the JAX package
takes its Pallas kernel).  Other mask activations and uncropped masks are
a different computation and use the plain composition, as in JAX.
"""

from __future__ import annotations

import torch

from yolact_tpu.config import MaskType, YolactConfig
from yolact_tpu_torch.detect.detection import Detections
from yolact_tpu_torch.kernels.mask_assembly import (assemble_masks,
                                                    assemble_masks_plain)
from yolact_tpu_torch.ops.boxes import crop


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
