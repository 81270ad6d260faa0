#!/usr/bin/env python3
"""Layout variants of the DCN sampling kernel on one NVIDIA GPU.

    python3 probe_dcn.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Each variant is ``yolact_tpu_torch/csrc/dcn_im2col.cu`` with one change
made by text substitution, built into a library of its own and called
through the same C entry point as the kernel.  At the five DCN shapes of
yolact_plus_base (b8 bf16, finite offsets as in chip_smoke.py's timing) it
checks that every variant writes the plain version's columns and prints
each variant's device time (torch.profiler kernel events, 20 calls) beside
the kernel's store bound, and the sum over the 11 DCN blocks of a batch.

Variants: ``kernel`` (the source as it is: one thread per pixel and 8
channels, looping over the taps, unrolled by 9), ``unroll3`` (the loop
unrolled by 3), ``taps`` (one thread per pixel, tap and 8 channels, the tap
on blockIdx.y), ``rows`` (one thread per pixel, kernel row and 8 channels,
the row on blockIdx.y, looping over the row's taps), ``threads128``
(128-thread blocks) and ``regs32`` (``__launch_bounds__(256, 8)``).
"""

import ctypes
import os
import re
import subprocess
import tempfile

import torch

import chip_smoke as cs
from yolact_tpu_torch.kernels import _build, dcn

SOURCE = 'yolact_tpu_torch/csrc/dcn_im2col.cu'
LOOP = re.compile(r'#pragma unroll \d+[^\n]*\n  for \(int t = 0; t < kk; \+\+t\) \{\n'
                  r'    const int i = t / k, j = t % k;\n')
GRID = 'const dim3 grid((n_threads + kThreads - 1) / kThreads);'
BOUNDS = '__launch_bounds__(kThreads)\n'
THREADS = 'constexpr int kThreads = 256;'


def grid(ys):
    return GRID.replace(');', f', {ys});')


def variants(src):
    """{name: source}; raises if the kernel source no longer has the
    lines the substitutions rewrite."""
    for pattern in (GRID, BOUNDS, THREADS):
        if pattern not in src:
            raise RuntimeError(f'probe_dcn: {pattern!r} not in {SOURCE}')
    if not LOOP.search(src):
        raise RuntimeError(f'probe_dcn: the tap loop is not in {SOURCE}')

    def loop(text):
        return LOOP.sub(lambda _: text, src, count=1)

    return {
        'kernel': src,
        'unroll3': loop('#pragma unroll 3\n  for (int t = 0; t < kk; ++t) {\n'
                        '    const int i = t / k, j = t % k;\n'),
        'taps': loop('  {\n    const int t = blockIdx.y;\n'
                     '    const int i = t / k, j = t % k;\n')
        .replace(GRID, grid('k * k')),
        'rows': loop('#pragma unroll 3\n  for (int j = 0; j < k; ++j) {\n'
                     '    const int i = blockIdx.y, t = i * k + j;\n')
        .replace(GRID, grid('k')),
        'threads128': src.replace(THREADS, 'constexpr int kThreads = 128;'),
        'regs32': src.replace(BOUNDS, '__launch_bounds__(kThreads, 8)\n'),
    }


def build(sources, out_dir):
    """One nvcc per variant, all started together; {name: ctypes entry}."""
    nvcc = _build._find_nvcc()
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, '-Xptxas', '-v', '-shared', '-o',
             os.path.join(out_dir, f'{name}.so'), cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'probe_dcn: nvcc failed on {name}:\n{err}')
        regs = sorted({int(m) for m in re.findall(r'Used (\d+) registers', err)})
        print(f'{name}: registers {regs}')
        fn = ctypes.CDLL(os.path.join(out_dir, f'{name}.so')).yolact_dcn_im2col
        fn.argtypes = _build.SIGNATURES['yolact_dcn_im2col']
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        raise SystemExit('probe_dcn: needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    with open(SOURCE) as f:
        sources = variants(f.read())
    dev = torch.device('cuda', 0)
    gen = torch.Generator().manual_seed(7)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(sources, tmp)
        total = dict.fromkeys(fns, 0.0)
        for shape, count, cin, h, stride in cs.DCN_SHAPES:
            x, offset, mask = cs.dcn_inputs(gen, dev, 8, cin, h, stride,
                                            torch.bfloat16, finite=True)
            xh = x.permute(0, 2, 3, 1).contiguous()
            ho = offset.shape[-1]
            want = dcn.dcn_columns_plain(x, offset, mask, 3, stride)
            b_ms, _ = cs.bound(cs.nbytes(x, offset, mask, want),
                               8 * want.numel(), cs.FP32_OPS_PER_S)
            for name, fn in fns.items():
                cols = torch.empty_like(want)

                def call():
                    _build.check(fn(xh.data_ptr(), offset.data_ptr(),
                                    mask.data_ptr(), cols.data_ptr(), 1, 8,
                                    cin, h, h, ho, ho, 3, stride, 1, 1,
                                    _build.stream_ptr(dev)), name)
                call()
                torch.cuda.synchronize()
                cs.check(torch.equal(cols, want),
                         f'{name} {shape}: not the plain version\'s columns')
                ms = cs.device_times(call, 'dcn_im2col_kernel')[1]
                total[name] += count * ms
                print(f'dcn {shape} b8 bf16 (x{count} per batch) {name}: '
                      f'{ms!r} ms, {b_ms / ms!r} of the bound {b_ms!r} ms '
                      f'[{card}]')
    print('dcn sampling per yolact_plus_base b8 batch (11 blocks), ms: '
          + ', '.join(f'{k} {v!r}' for k, v in total.items()) + f' [{card}]')


if __name__ == '__main__':
    main()
