"""COCO run-length-encoding mask codec (pycocotools-free): the port's copy
of ``yolact_tpu/data/rle.py`` (``area`` left out: the port does not use it).

Implements the COCO compressed-RLE string format (the LEB128-style varint
encoding used by pycocotools' maskApi) plus polygon rasterisation via cv2.
The native helper (``yolact_tpu_torch/native``) runs the hot encode/decode
loops when it builds; otherwise this module uses the numpy versions.

Format notes (maskApi.c semantics):
  * masks are encoded in column-major (Fortran) order;
  * `counts` alternates runs of 0s and 1s, starting with 0s;
  * the compressed string stores each count as a base-32 varint with 5 data
    bits per char (offset 48), sign-extended, with counts[i>2] stored as a
    difference from counts[i-2].
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from yolact_tpu_torch.native import get_native

RLEObj = Dict[str, Union[str, bytes, List[int]]]


def encode_counts(counts: np.ndarray) -> bytes:
    """uint32 run lengths -> compressed RLE byte string."""
    native = get_native()
    if native is not None:
        return native.rle_encode_counts(np.asarray(counts, np.int64))
    out = bytearray()
    counts = np.asarray(counts, np.int64)
    for i, x in enumerate(counts):
        if i > 2:
            x = int(x) - int(counts[i - 2])
        else:
            x = int(x)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def decode_counts(s: Union[str, bytes]) -> np.ndarray:
    """Compressed RLE byte string -> uint32 run lengths."""
    if isinstance(s, str):
        s = s.encode('ascii')
    native = get_native()
    if native is not None:
        return native.rle_decode_counts(s)
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.uint32)


def mask_to_rle(mask: np.ndarray) -> RLEObj:
    """Binary [h, w] mask -> {'size': [h, w], 'counts': bytes}."""
    h, w = mask.shape
    flat = np.asfortranarray(mask).reshape(-1, order='F').astype(np.uint8)
    # run-length encode, first run counts zeros
    diffs = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], diffs, [flat.size]])
    counts = np.diff(bounds)
    if flat.size and flat[0] == 1:
        counts = np.concatenate([[0], counts])
    return {'size': [h, w], 'counts': encode_counts(counts.astype(np.uint32))}


def rle_to_mask(rle: RLEObj) -> np.ndarray:
    """COCO RLE object (compressed or raw counts) -> bool [h, w] mask."""
    h, w = rle['size']
    counts = rle['counts']
    if isinstance(counts, (str, bytes)):
        native = get_native()
        if native is not None:
            # one C++ pass: varint decode + memset runs straight into the
            # byte mask (no intermediate counts array / np.repeat)
            s = counts.encode('ascii') if isinstance(counts, str) else counts
            return native.rle_decode_mask(s, h, w)
        counts = decode_counts(counts)
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total > h * w:
        # match the native path (and pycocotools): silently truncating a
        # corrupt annotation would feed corrupt gt into training/eval
        raise ValueError(
            f'RLE runs exceed mask size {h}x{w} (corrupt annotation or '
            'swapped height/width)')
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if total < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - total, np.uint8)])
    return flat.reshape((h, w), order='F').astype(bool)


def polygons_to_mask(polys: Sequence[Sequence[float]], h: int, w: int
                     ) -> np.ndarray:
    """COCO polygon annotation -> bool [h, w] mask (cv2 rasterisation)."""
    import cv2
    mask = np.zeros((h, w), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polys if len(p) >= 6]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask.astype(bool)


def ann_to_mask(segm, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation (polygon list / RLE dict) -> bool [h, w]."""
    if isinstance(segm, list):
        return polygons_to_mask(segm, h, w)
    if isinstance(segm, dict):
        counts = segm.get('counts')
        if isinstance(counts, list):  # uncompressed RLE
            return rle_to_mask({'size': segm['size'], 'counts': counts})
        return rle_to_mask(segm)
    raise TypeError(type(segm))

