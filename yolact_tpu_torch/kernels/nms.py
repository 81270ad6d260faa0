"""Fast-NMS IoU max: CUDA kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``yolact_tpu/kernels/nms_pallas.py:_kernel``
(``nms_iou_max_pallas``), and carries the step that the JAX detection
computes as ``_triu_max(jaccard(boxes_c, boxes_c))``
(``yolact_tpu/detect/detection.py:63-64,92``).

On the card the kernel (``csrc/fast_nms_iou.cu``) moves few bytes and is
bound by the latency of its longest per-column loop of IoUs: one block per
class row keeps the row's boxes in shared memory and never writes the
``[K, K]`` IoU matrix to device memory.  The plain version materialises it
several times over.

:func:`nms_iou_max` takes the plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from yolact_tpu_torch.kernels import _build
from yolact_tpu_torch.ops.boxes import jaccard

launches = 0        # kernel launches by nms_iou_max since import / reset

# 5 floats of shared memory per box must fit the default 48 KB a block gets
MAX_K = 48 * 1024 // (5 * 4)


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


def nms_iou_max(boxes: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`nms_iou_max_plain`; the CUDA kernel for a
    CUDA tensor."""
    if boxes.device.type == 'cpu':
        return nms_iou_max_plain(boxes)
    if boxes.device.type != 'cuda':
        raise ValueError(f'nms_iou_max: unsupported device {boxes.device}')
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f'nms_iou_max: boxes must be [N, K, 4], '
                         f'got {tuple(boxes.shape)}')
    n, k, _ = boxes.shape
    if k > MAX_K:
        raise ValueError(f'nms_iou_max: K={k} exceeds the kernel limit {MAX_K}')
    boxes = boxes.to(torch.float32).contiguous()
    out = torch.empty((n, k), dtype=torch.float32, device=boxes.device)
    if n == 0 or k == 0:
        return out
    lib = _build.load()
    global launches
    _build.check(lib.yolact_fast_nms_iou_max(
        boxes.data_ptr(), out.data_ptr(), n, k,
        _build.stream_ptr(boxes.device)), 'yolact_fast_nms_iou_max')
    launches += 1
    return out
