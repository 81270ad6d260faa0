"""Frozen plain PyTorch copy of the port's fast-NMS IoU max
(``yolact_tpu_torch/kernels/nms.py``): the plain version alone, under the
kernel's name, so the reference's model runs it wherever the port would
launch the kernel."""

from __future__ import annotations

import torch

from benchmark.reference.ops.boxes import jaccard


def nms_iou_max_plain(boxes: torch.Tensor) -> torch.Tensor:
    """boxes [N, K, 4] score-sorted point form -> iou_max [N, K]: the max
    IoU of each box with any earlier (higher-scoring) box of its row, 0 for
    the first.  A NaN IoU in the strict upper triangle propagates (the
    guarded IoU is never NaN; see ``csrc/fast_nms_iou.cu``)."""
    boxes = boxes.float()
    k = boxes.shape[-2]
    iou = jaccard(boxes, boxes)
    upper = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    return torch.where(upper, iou, 0.0).amax(dim=-2)


nms_iou_max = nms_iou_max_plain
