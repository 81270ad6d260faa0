"""Mask IoU on the device for the mAP evaluation loop.

Port of ``yolact_tpu/eval/device_metrics.py:mask_iou_device``.  The
reference upsamples every predicted mask to the image size with torch
bilinear and computes mask IoU as one GPU product (``output_utils.py:91-94``,
``eval.py:376-384``); so does this module, and only the small ``[D, G]``
matrices leave the card.  The upsample is ``detect/postprocess.py:
upsample_masks_device``, the one the host path (``finish_masks``) runs, so
both paths binarise the same masks.

The JAX package's TPU workarounds are not ported: it upsamples into a fixed
``[canvas, canvas]`` frame with the image size as traced data (so that XLA
compiles one shape), bit-packs the gt and falls back to the host above a
1024 canvas.  Here the masks are upsampled to ``(h, w)`` itself.

The counts are exact: the product runs in float32 on 0/1 values, so each
intersection is an integer sum in float32 (exact up to 2^24 pixels, a
4096x4096 image), also when cuBLAS takes TF32, which keeps 0 and 1 exact and
accumulates in float32.  A bfloat16 or float16 product would round counts
above 256 or 2048.
"""

from __future__ import annotations

from typing import Tuple

import torch

from yolact_tpu_torch.detect.postprocess import upsample_masks_device


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den > 0, else 0 (as ``evaluator._np_mask_iou``)."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def mask_iou_device(pred_masks: torch.Tensor, gt_masks: torch.Tensor,
                    h: int, w: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (iou [D, G], crowd_iou [D, G], pred_area [D]), float32, on
    the masks' device.

    pred_masks: [D, Hp, Wp] proto-resolution sigmoid masks (cropped), on
    the card in the eval loop; gt_masks: [G, h, w] 0/1 (any dtype, any
    device: it goes to the masks' device).  Each predicted mask is
    upsampled to (h, w) and binarised at 0.5; crowd_iou = intersection /
    predicted area (the iscrowd variant)."""
    dev = pred_masks.device
    gt = torch.as_tensor(gt_masks).to(dev)
    d, g = pred_masks.shape[0], gt.shape[0]
    if tuple(gt.shape[1:]) != (h, w):
        raise ValueError(f'gt masks {tuple(gt.shape)} are not [G, {h}, {w}]')
    if d == 0:
        pm = torch.zeros((0, h * w), dtype=torch.float32, device=dev)
    else:
        pm = upsample_masks_device(pred_masks[None], (h, w))[0] \
            .reshape(d, h * w).float()
    gm = (gt.reshape(g, h * w) > 0).float()
    inter = pm @ gm.T
    pa = pm.sum(dim=1)
    ga = gm.sum(dim=1)
    iou = _ratio(inter, pa[:, None] + ga[None, :] - inter)
    crowd = _ratio(inter, pa[:, None].expand_as(inter))
    return iou, crowd, pa
