#!/usr/bin/env python3
"""Layout variants of the DCN sampling kernel on one NVIDIA GPU.

    python3 probe_dcn.py [--backward [--parent DIR]]

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

``--backward`` probes the backward kernel instead
(``yolact_tpu_torch/csrc/dcn_col2im.cu``): its registers and spills
(``nvcc -Xptxas -v``), chip_smoke.py's check against autograd through the
plain columns, its device time at the five shapes at b8 in float32 and
bfloat16 beside its bound and the plain version, and its time alone on the
inputs of one yolact_plus_base 550 b8 float32 train step (captured from
the step's own backward), with the global reductions.  ``--parent DIR``
adds the backward kernel of another tree (``DIR/yolact_tpu_torch/csrc/
dcn_col2im.cu``, e.g. an unpacked ``git archive`` of the parent commit
under ``build/``), built into a library of its own and timed beside this
tree's on the same inputs, in the order parent, this, this, parent.
"""

import argparse
import collections
import ctypes
import os
import re
import statistics
import subprocess
import tempfile

import torch

import chip_smoke as cs
from yolact_tpu_torch import get_config
from yolact_tpu_torch.infer import random_state_dict
from yolact_tpu_torch.kernels import _build, dcn
from yolact_tpu_torch.train.step import create_train_state, train_step

SOURCE = 'yolact_tpu_torch/csrc/dcn_im2col.cu'
BACKWARD_SOURCE = 'yolact_tpu_torch/csrc/dcn_col2im.cu'
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


def step_inputs(dev):
    """The dcn_col2im inputs of one yolact_plus_base 550 b8 float32 train
    step, as chip_smoke.py's phase 6 drives it (seeded weights and offset
    convs, tamed residuals, its synthetic batch)."""
    cfg = get_config('yolact_plus_base').copy(lr=1e-4, lr_warmup_init=1e-7,
                                              train_remat='dcn')
    sd = cs.seed_offsets_state_dict(
        random_state_dict(cfg, torch.Generator().manual_seed(0)),
        torch.Generator().manual_seed(3))
    state = create_train_state(cfg, device=dev, state_dict=cs.tame_residuals(sd))
    with cs.capture_col2im() as captured:
        train_step(state, cs.make_train_batch(cfg),
                   torch.Generator(device=dev).manual_seed(11))
    torch.cuda.synchronize()
    return captured


def parent_kernel(parent):
    """The parent tree's dcn_col2im built alone: a function of (g_cols, xh,
    offset, mask, dims) returning its gradients as _launch_col2im does."""
    src = os.path.join(parent, BACKWARD_SOURCE)
    with open(src) as f:
        text = f.read()
    vec_arg = 'int vec' in text
    row0_arg = 'int row0' in text
    out = os.path.join(tempfile.mkdtemp(), 'parent_col2im.so')
    subprocess.run([_build._find_nvcc(), *_build.NVCC_FLAGS, '-shared', '-o',
                    out, src], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(out).yolact_dcn_col2im
    # this tree's signature ends (..., dil, row0, vec, stream); an older
    # kernel may lack row0 (before spatial partitioning) and vec
    sig = list(_build.SIGNATURES['yolact_dcn_col2im'])
    if not row0_arg:
        del sig[-3]
    if not vec_arg:
        del sig[-2]
    fn.argtypes = sig
    fn.restype = ctypes.c_int

    def call(g_cols, xh, offset, mask, dims):
        grad_x = torch.zeros(xh.shape, dtype=torch.float32, device=xh.device)
        grad_offset = torch.empty_like(offset)
        grad_mask = torch.empty_like(mask)
        extra = ((int(dcn.col2im_vec(dims[1], xh.element_size(), g_cols, xh,
                                     grad_x)),) if vec_arg else ())
        geometry = dims if row0_arg else dims[:10]
        _build.check(fn(g_cols.data_ptr(), xh.data_ptr(), offset.data_ptr(),
                        mask.data_ptr(), grad_x.data_ptr(),
                        grad_offset.data_ptr(), grad_mask.data_ptr(),
                        int(xh.dtype == torch.bfloat16), *geometry, *extra,
                        _build.stream_ptr(xh.device)), 'parent dcn_col2im')
        return grad_x, grad_offset, grad_mask
    return call


def compare(tag, parent, inputs, card):
    """Device ms of the parent's kernel and this tree's on each input,
    parent / this / this / parent; returns the two sums (weights: how many
    launches per step each input stands for)."""
    sums = {'parent': 0.0, 'this': 0.0}
    for weight, (g_cols, xh, offset, mask, dims) in inputs:
        fns = {'parent': lambda: parent(g_cols, xh, offset, mask, dims),
               'this': lambda: dcn._launch_col2im(g_cols, xh, offset, mask,
                                                  dims)}
        ms = collections.defaultdict(list)
        for name in ('parent', 'this', 'this', 'parent'):
            ms[name].append(cs.device_times(fns[name],
                                            'dcn_col2im_kernel')[1])
        line = {k: statistics.mean(v) for k, v in ms.items()}
        for k in sums:
            sums[k] += weight * line[k]
        print(f'{tag} C{dims[1]} H{dims[2]} stride {dims[7]} '
              f'{str(xh.dtype)[6:]}: parent {ms["parent"]} ms, this '
              f'{ms["this"]} ms [{card}]')
    print(f'{tag} per step: parent {sums["parent"]!r} ms, this '
          f'{sums["this"]!r} ms [{card}]')


def backward(dev, card, parent_dir=None):
    """The --backward mode (see the module docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build._find_nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-c',
             '-o', os.path.join(tmp, 'col2im.o'), BACKWARD_SOURCE],
            capture_output=True, text=True, check=True).stderr
    for line in out.splitlines():
        if 'registers' in line or 'spill' in line:
            print(f'dcn_col2im: {line.strip()}')
    cs.col2im_vs_plain(dev)
    cs.col2im_timing(dev, card)
    captured = step_inputs(dev)
    cs.col2im_in_step(captured, card)
    if parent_dir is None:
        return
    parent = parent_kernel(parent_dir)
    gen = torch.Generator().manual_seed(13)
    for dtype in (torch.float32, torch.bfloat16):
        seeded = []
        for _, count, cin, h, stride in cs.DCN_SHAPES:
            x, offset, mask = cs.dcn_inputs(gen, dev, 8, cin, h, stride,
                                            dtype, finite=True)
            ho = offset.shape[-1]
            g_cols = torch.randn(8 * ho * ho, 9 * cin, generator=gen)\
                .to(dtype).to(dev)
            seeded.append((count, (g_cols, x.permute(0, 2, 3, 1).contiguous(),
                                   offset, mask,
                                   (8, cin, h, h, ho, ho, 3, stride, 1, 1))))
        compare(f'dcn_col2im seeded {str(dtype)[6:]}', parent, seeded, card)
        del seeded
    compare('dcn_col2im in-step', parent, [(1, c) for c in captured], card)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--backward', action='store_true',
                        help='probe csrc/dcn_col2im.cu instead')
    parser.add_argument('--parent', metavar='DIR',
                        help='with --backward: time DIR\'s dcn_col2im beside '
                        'this tree\'s')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('probe_dcn: needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    if args.backward:
        backward(torch.device('cuda', 0), card, args.parent)
        return
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
                                    cin, h, h, ho, ho, 3, stride, 1, 1, 0,
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
