"""Build and load the port's CUDA kernels at first use.

Every ``yolact_tpu_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, which is loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The library lands in
``yolact_tpu_torch/_build/<hash>/``, keyed on a hash of the sources and
flags, so an edited ``.cu`` file rebuilds and an unchanged one is reused.

``--fmad=false`` is part of the contract, not a tuning flag: without it
nvcc may contract ``a * b - c`` into one fused multiply-add, which rounds
once instead of twice.  The IoU, crop-bound and bilinear-sample arithmetic
must round like the plain PyTorch versions, because a last-bit change there
flips an ``iou <= nms_thresh`` decision, moves a crop edge by a whole pixel
or breaks the DCN columns' bit-equality.
Products the kernels do want fused are written as explicit ``fmaf``.

Every C entry point takes its pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()`` after the launch; :func:`check` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-Xcompiler', '-fPIC')

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points: name -> argtypes
SIGNATURES = {
    # boxes [n, k, 4] f32, out [n, k] f32, n, k, the host int array of
    # kernels/nms.py:iou_plan (splits, column bounds, row bounds), stream
    'yolact_fast_nms_iou_max': (_P, _P, _I, _I, _P, _P),
    # proto [b, hp*wp, md], coeffs [b, d, md], boxes [b, d, 4], out
    # [b, d, hp*wp] (all f32), b, d, hp, wp, md, padding, stream
    'yolact_mask_assembly': (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                             ctypes.c_float, _P),
    # x [b, h, w, c] (NHWC), offset [b, 2k^2, ho, wo] f32, mask [b, k^2,
    # ho, wo], cols [b*ho*wo, k^2*c], dtype (0 f32, 1 bf16), b, c, h, w, ho,
    # wo, k, stride, pad, dil, stream
    'yolact_dcn_im2col': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _P),
    # x [b, 12, h, w], w2 [64, 12, 4, 4], out [b, 64, h, w], dtype (0 f32,
    # 1 bf16), b, h, w, stream
    'yolact_stem_s2d_conv': (_P, _P, _P, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None


def _find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which('nvcc')
    home_nvcc = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                             'bin', 'nvcc')
    if nvcc is None and os.path.exists(home_nvcc):
        nvcc = home_nvcc
    if nvcc is None:
        raise RuntimeError(
            'yolact_tpu_torch kernels need nvcc (CUDA toolkit) to build '
            f'csrc/*.cu; none found on PATH or at {home_nvcc}')
    return nvcc


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, '*.cu')))
    if not srcs:
        raise RuntimeError(f'no CUDA sources found in {CSRC}')
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run(procs) -> None:
    """Wait for every nvcc process; raise with the output of a failed one."""
    failed = []
    for proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{" ".join(proc.args)} ({proc.returncode}):\n'
                          f'{out}\n{err}')
    if failed:
        raise RuntimeError('nvcc failed: ' + '\n'.join(failed))


def _compile(srcs, out_path: str) -> None:
    nvcc = _find_nvcc()
    out_dir = os.path.dirname(out_path)
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + '.o')
                for src in srcs]
        _run([subprocess.Popen([nvcc, *NVCC_FLAGS, '-c', '-o', obj, src],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
              for src, obj in zip(srcs, objs)])
        lib = os.path.join(tmp, 'lib.so')
        _run([subprocess.Popen([nvcc, *NVCC_FLAGS, '-shared', '-o', lib,
                                *objs], stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)])
        os.replace(lib, out_path)   # atomic: concurrent builds agree


def load() -> ctypes.CDLL:
    """The kernel library, built on first call.  Raises when there is no
    CUDA device or no nvcc; never falls back."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError('yolact_tpu_torch kernels need a CUDA device; '
                               'torch.cuda.is_available() is False')
        srcs = _sources()
        path = os.path.join(BUILD_DIR, _digest(srcs), 'libyolact_kernels.so')
        if not os.path.exists(path):
            _compile(srcs, path)
        lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError {err}')


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
