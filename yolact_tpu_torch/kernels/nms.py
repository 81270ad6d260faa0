"""Fast-NMS IoU max: CUDA kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``yolact_tpu/kernels/nms_pallas.py:_kernel``
(``nms_iou_max_pallas``), and carries the step that the JAX detection
computes as ``_triu_max(jaccard(boxes_c, boxes_c))``
(``yolact_tpu/detect/detection.py:63-64,92``).

On the card the kernel (``csrc/fast_nms_iou.cu``) moves few bytes and is
bound by instruction issue: K (K - 1) / 2 pairs per class row, each a
chain of min/max, products and compares.  It keeps each row's boxes in
shared memory, never writes the ``[K, K]`` IoU matrix to device memory,
compares IoUs as fractions without a divide in the pair loop, and splits
each row's triangle over warps (and, at small N, blocks) by
:func:`iou_plan` so that every warp runs the same number of iterations.
The result is bit-equal to the plain version, which materialises the
matrix several times over.

:func:`nms_iou_max` takes the plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import bisect
import ctypes
import functools

import torch

from yolact_tpu_torch.kernels import _build
from yolact_tpu_torch.ops.boxes import jaccard

launches = 0        # kernel launches by nms_iou_max since import / reset

WARPS = 8           # warps per block (csrc/fast_nms_iou.cu:kWarps)
MAX_SPLITS = 4      # blocks per row at most (kMaxSplits)
# a block holds its columns' boxes and areas (20 B each) and one partial
# fraction per warp and column (64 B): 84 B a column of the widest split
# within the 227 KB a block may use
MAX_K = 2048


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


def warp_iterations(i0: int, i1: int, jlo: int, jhi: int) -> int:
    """Iterations of the kernel's pair loop for a warp that walks rows
    [i0, i1) of the columns [jlo, jhi), 32 columns at a time from
    max(jlo, i0 + 1): each group runs its rows below its last column."""
    its = 0
    jb = max(jlo, i0 + 1)
    while jb < jhi and i0 < i1:
        its += min(i1, jhi - 1, jb + 31) - i0
        jb += 32
    return its


def _row_bounds(jlo: int, jhi: int, target: int):
    """Greedy row chunks of at most `target` warp-iterations each for
    columns [jlo, jhi); None when WARPS chunks do not reach the last row
    that has a pair (jhi - 2)."""
    bounds, i0 = [0], 0
    for _ in range(WARPS):
        if i0 >= jhi - 1:
            bounds.append(jhi)
            continue
        rows = range(i0 + 1, jhi + 1)
        # the last i1 whose chunk fits the target (at least one row)
        i1 = rows[max(0, bisect.bisect_right(
            rows, target, key=lambda r: warp_iterations(i0, r, jlo, jhi)) - 1)]
        bounds.append(i1)
        i0 = i1
    bounds[-1] = jhi
    return bounds if i0 >= jhi - 1 else None


@functools.lru_cache(maxsize=64)
def iou_plan(n: int, k: int, sms: int) -> tuple:
    """How the kernel splits the [N, K] rows: (splits, column bounds,
    per split the WARPS + 1 row bounds).  A row goes to `splits` blocks
    (enough for N * splits to reach `sms`, at most MAX_SPLITS, and at least
    64 columns each), cut where the pair counts j (j - 1) / 2 balance; each
    block's rows go to WARPS warps in chunks of equal warp-iterations (the
    least maximum the greedy split reaches)."""
    splits = max(1, min(MAX_SPLITS, -(-sms // max(n, 1)), k // 64))
    pairs = k * (k - 1) // 2
    cols = [0]
    for m in range(1, splits):
        j = cols[-1]
        while j * (j - 1) * splits < 2 * m * pairs:
            j += 1
        cols.append(j)
    cols.append(k)
    rows = []
    for jlo, jhi in zip(cols, cols[1:]):
        lo, hi = 1, max(1, warp_iterations(0, jhi, jlo, jhi))
        while lo < hi:                   # least feasible target
            mid = (lo + hi) // 2
            if _row_bounds(jlo, jhi, mid) is None:
                lo = mid + 1
            else:
                hi = mid
        rows.append(tuple(_row_bounds(jlo, jhi, lo)))
    return splits, tuple(cols), tuple(rows)


@functools.lru_cache(maxsize=64)
def _plan_array(n: int, k: int, sms: int):
    """iou_plan flattened for the C entry point."""
    splits, cols, rows = iou_plan(n, k, sms)
    flat = [splits, *cols, *(r for bounds in rows for r in bounds)]
    return (ctypes.c_int * len(flat))(*flat)


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
    sms = torch.cuda.get_device_properties(boxes.device).multi_processor_count
    global launches
    _build.check(lib.yolact_fast_nms_iou_max(
        boxes.data_ptr(), out.data_ptr(), n, k, _plan_array(n, k, sms),
        _build.stream_ptr(boxes.device)), 'yolact_fast_nms_iou_max')
    launches += 1
    return out
