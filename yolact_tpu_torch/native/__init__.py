"""ctypes loader of the host helper library (RLE codec, greedy NMS): the
port's counterpart of ``yolact_tpu/native/__init__.py``.

It builds the repository's ``native/yolact_native.cpp`` with g++ on first
use into ``yolact_tpu_torch/_build/native/``, keyed on a hash of the
source, and loads it with ``ctypes``.  Every caller falls back to numpy
when the source or a compiler is missing, so the port works (more slowly)
without it.  This is host code: nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), 'native', 'yolact_native.cpp')
BUILD_DIR = os.path.join(_PKG, '_build', 'native')

_lock = threading.Lock()
_native = None
_tried = False


class Native:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.rle_encode_counts.restype = ctypes.c_int64
        lib.rle_encode_counts.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_char_p]
        lib.rle_decode_counts.restype = ctypes.c_int64
        lib.rle_decode_counts.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32)]
        lib.rle_decode_mask.restype = ctypes.c_int32
        lib.rle_decode_mask.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.greedy_nms.restype = ctypes.c_int64
        lib.greedy_nms.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int64)]

    def rle_encode_counts(self, counts: np.ndarray) -> bytes:
        counts = np.ascontiguousarray(counts, np.int64)
        out = ctypes.create_string_buffer(8 * max(1, len(counts)))
        n = self._lib.rle_encode_counts(
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(counts), out)
        return out.raw[:n]

    def rle_decode_counts(self, s: bytes) -> np.ndarray:
        out = np.empty(max(1, len(s)), np.uint32)
        n = self._lib.rle_decode_counts(
            s, len(s), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return out[:n].copy()

    def rle_decode_mask(self, s: bytes, h: int, w: int) -> np.ndarray:
        mask = np.empty(h * w, np.uint8)
        rc = self._lib.rle_decode_mask(
            s, len(s), h, w,
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            # a silently truncated gt mask would corrupt eval unnoticed
            raise ValueError(
                f'RLE runs exceed mask size {h}x{w} (corrupt annotation '
                'or swapped height/width)')
        return mask.reshape((h, w), order='F').astype(bool)

    def greedy_nms(self, dets: np.ndarray, thresh: float) -> np.ndarray:
        """dets [n, 5] float32 (x1,y1,x2,y2,score) -> kept indices."""
        dets = np.ascontiguousarray(dets, np.float32)
        keep = np.empty(len(dets), np.int64)
        n = self._lib.greedy_nms(
            dets.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(dets), thresh,
            keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return keep[:n].copy()


def _build() -> Optional[str]:
    """The built library's path, or None without a source or a compiler."""
    if not os.path.exists(SOURCE):
        return None
    with open(SOURCE, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f'libyolact_native-{digest}.so')
    if os.path.exists(so):
        return so
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        # compile to a per-process name, then rename atomically: another
        # process never loads a half-written library
        tmp = f'{so}.{os.getpid()}.tmp'
        subprocess.run(['g++', '-O3', '-fPIC', '-std=c++17', '-shared', '-o',
                        tmp, SOURCE], check=True, capture_output=True)
        os.replace(tmp, so)
        return so
    except (subprocess.CalledProcessError, OSError):
        return None


def get_native() -> Optional[Native]:
    global _native, _tried
    if _tried:
        return _native
    with _lock:
        if not _tried:
            so = _build()
            if so is not None:
                try:
                    _native = Native(ctypes.CDLL(so))
                except OSError:
                    _native = None
            _tried = True
    return _native
