#!/usr/bin/env python3
"""The mask-assembly and fast-NMS IoU-max kernels against an earlier tree's
on one NVIDIA GPU.

    python3 probe_small_kernels.py [--parent DIR] [--sass DIR] [--variants]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It prints each kernel's registers, shared memory and spills (``nvcc
-Xptxas -v``) and the fused multiply-adds in the SASS of the IoU kernel's
tie test (``cuobjdump -sass``: the source's ``fmaf`` must stay FFMA under
``--fmad=false``); ``--sass`` writes each kernel's whole SASS to a
directory.  With ``--parent`` (a checkout of an earlier commit, e.g.
``git archive`` unpacked under ``build/``) it also builds that tree's
``csrc/mask_assembly.cu`` and ``csrc/fast_nms_iou.cu`` into a library of
their own and calls them through their C entry points.

With ``--variants`` it also times, at b8, versions of the mask-assembly
kernel with one part taken out by text substitution (the products, the
split's two low passes, the sigmoid and crop, the stores, the staging of
the coefficients, the prototype copies; and an empty kernel that returns
after its set-up), each built into a library of its own, b8 and b1.

Both kernels, and the parent's, are checked against their plain versions
(mask assembly within 1e-5 with the same zero pattern, the IoU max bit for
bit) and timed at the main-path shapes, b8 and b1 (mask assembly B x 100
detections, 138 x 138, Md = 32; IoU max [B * 80, 200, 4]), in the order
parent, kernel, kernel, parent: device time by torch.profiler kernel
events over 20 calls, beside the bound chip_smoke.py computes.  Two
seconds of bf16 matrix products first bring the card to its working
clocks (a cold card reads the same kernels up to 1.4x slower); the SM
clock is printed beside each set of times.
"""

import argparse
import ctypes
import os
import re
import subprocess
import tempfile
import time

import torch

import chip_smoke as cs
from yolact_tpu_torch.kernels import _build, mask_assembly, nms

SOURCES = ('mask_assembly.cu', 'fast_nms_iou.cu')
SYMBOLS = {'mask_assembly': 'mask_assembly_kernel',
           'fast_nms_iou_max': 'fast_nms_iou_max_kernel'}


def nvcc_report(csrc, out_dir, tag):
    """Compile each source with -Xptxas -v; print its per-kernel lines and
    return {source: object path}."""
    nvcc = _build._find_nvcc()
    objs = {}
    for name in SOURCES:
        obj = os.path.join(out_dir, f'{tag}_{name}.o')
        res = subprocess.run([nvcc, *_build.NVCC_FLAGS, '-Xptxas', '-v', '-c',
                              '-o', obj, os.path.join(csrc, name)],
                             capture_output=True, text=True, check=True)
        for line in res.stderr.splitlines():
            if re.search(r'registers|spill|Compiling entry', line):
                print(f'{tag} {name}: {line.strip()}')
        objs[name] = obj
    return objs


def sass_of(obj):
    cuobjdump = os.path.join(os.path.dirname(_build._find_nvcc()), 'cuobjdump')
    return subprocess.run([cuobjdump, '-sass', obj], capture_output=True,
                          text=True, check=True).stdout


def sass_ffma(obj):
    """The IoU kernel's exact-error products in its SASS: fmaf(a, b, -p)
    compiles to FFMA Rd, Ra, Rb, -Rp when --fmad=false leaves it fused."""
    sass = sass_of(obj)
    fused = re.findall(r'FFMA (R\d+), R\d+, R\d+, -(R\d+) ;', sass)
    print(f'sass fast_nms_iou.cu: {len(fused)} FFMA a*b - p (the tie test\'s '
          f'fmaf), {len(re.findall(r"FFMA", sass))} FFMA in all')


def parent_lib(objs, out_dir):
    nvcc = _build._find_nvcc()
    lib = os.path.join(out_dir, 'libparent.so')
    subprocess.run([nvcc, *_build.NVCC_FLAGS, '-shared', '-o', lib,
                    *objs.values()], check=True)
    dll = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.yolact_mask_assembly.argtypes = _build.SIGNATURES['yolact_mask_assembly']
    dll.yolact_fast_nms_iou_max.argtypes = (P, P, I, I, P)
    return dll


MMA = ('            mma_tf32(acc[mt][nt], al, bh[nt][0], bh[nt][1]);\n'
       '            mma_tf32(acc[mt][nt], ah, bl[nt][0], bl[nt][1]);\n'
       '            mma_tf32(acc[mt][nt], ah, bh[nt][0], bh[nt][1]);\n')
EPILOGUE = 'v[e] = sigmoid(acc[mt][nt][2 * h + e]) * (keep ? 1.f : 0.f);'
STAGE = '    if (b != cur_b) {'
COPY = '      cp_async16(dst + r * ks + c, src + static_cast<size_t>(r) * md + c);'
START = '  if (async_copy && t_begin < t_end) issue(t_begin, 0);'
STORE = ('*reinterpret_cast<float4*>(dst) =\n'
         '                *reinterpret_cast<const float4*>(src);')
GRID = '  const int grid = tiles < fit ? tiles : fit;\n'


def mask_variants(src):
    """{name: mask_assembly.cu with one part taken out}."""
    for part in (MMA, EPILOGUE, STORE, STAGE, COPY, START, GRID):
        if part not in src:
            raise RuntimeError(f'probe_small_kernels: {part!r} not in the '
                               'mask-assembly source')
    return {
        'kernel': src,
        'one_pass': src.replace(MMA, MMA.split('\n')[2] + '\n'),
        'no_mma': src.replace(MMA, ''),
        'no_sigmoid_crop': src.replace(EPILOGUE,
                                       'v[e] = acc[mt][nt][2 * h + e];'),
        'no_store': src.replace(STORE, ''),
        'no_coeff_staging': src.replace(STAGE, '    if (false) {'),
        'no_proto_copy': src.replace(COPY, '      (void)dst;'),
        'empty': src.replace(START, '  return;'),
        'streaming_stores': src.replace(STORE, '__stcs(reinterpret_cast<'
                                        'float4*>(dst), *reinterpret_cast<'
                                        'const float4*>(src));'),
        # the kernel, printing its blocks per SM and grid from the host
        'occupancy': '#include <cstdio>\n' + src.replace(
            GRID, GRID + '  printf("mask_assembly: %d blocks resident, grid '
            '%d, %d B of shared memory\\n", fit, grid, shmem);\n'),
    }


def variant_fns(dev, out_dir):
    """{variant: masks(proto, coeffs, boxes)}: one nvcc per variant, all
    started together."""
    with open(os.path.join(_build.CSRC, 'mask_assembly.cu')) as f:
        sources = mask_variants(f.read())
    nvcc = _build._find_nvcc()
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f'variant_{name}.cu')
        with open(cu, 'w') as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, '-shared', '-o',
             os.path.join(out_dir, f'libvariant_{name}.so'), cu])
    fns = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f'probe_small_kernels: variant {name} did not '
                               'build')
        dll = ctypes.CDLL(os.path.join(out_dir, f'libvariant_{name}.so'))
        dll.yolact_mask_assembly.argtypes = \
            _build.SIGNATURES['yolact_mask_assembly']
        fns[name] = parent_fns(dll, dev)[0]
    return fns


def parent_fns(dll, dev):
    stream = _build.stream_ptr(dev)

    def masks(proto, coeffs, boxes):
        b, hp, wp, md = proto.shape
        d = coeffs.shape[1]
        out = torch.empty((b, d, hp, wp), device=dev)
        _build.check(dll.yolact_mask_assembly(
            proto.data_ptr(), coeffs.data_ptr(), boxes.data_ptr(),
            out.data_ptr(), b, d, hp, wp, md, 1.0, stream), 'parent masks')
        return out

    def iou(boxes):
        n, k, _ = boxes.shape
        out = torch.empty((n, k), device=dev)
        _build.check(dll.yolact_fast_nms_iou_max(
            boxes.data_ptr(), out.data_ptr(), n, k, stream), 'parent iou')
        return out
    return masks, iou


def sm_clock():
    return subprocess.run(['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()


def warm_up(dev, seconds=2.0):
    a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a @ a
        torch.cuda.synchronize()


def check(name, tag, got, want):
    if name == 'mask_assembly':
        err = float((got - want).abs().max())
        ok = err <= 1e-5 and bool(torch.equal(got == 0, want == 0))
    else:
        err = float((got - want).abs().max())
        ok = bool(torch.equal(got, want))
    print(f'{tag} {name}: max_abs_err={err!r} ok={ok}')
    cs.check(ok, f'{tag} {name} disagrees with its plain version')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', help='checkout of an earlier commit')
    ap.add_argument('--sass', help='directory for the kernels\' SASS')
    ap.add_argument('--variants', action='store_true',
                    help='time the mask-assembly kernel with parts taken out')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('probe_small_kernels: needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device('cuda', 0)
    with tempfile.TemporaryDirectory() as tmp:
        objs = nvcc_report(_build.CSRC, tmp, 'kernel')
        sass_ffma(objs['fast_nms_iou.cu'])
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            for name, obj in objs.items():
                with open(os.path.join(args.sass, name + '.sass'), 'w') as f:
                    f.write(sass_of(obj))
        impls = {'kernel': (mask_assembly.assemble_masks, nms.nms_iou_max)}
        if args.parent:
            pobjs = nvcc_report(os.path.join(args.parent, 'yolact_tpu_torch',
                                             'csrc'), tmp, 'parent')
            impls['parent'] = parent_fns(parent_lib(pobjs, tmp), dev)
        _build.load()
        warm_up(dev)
        if args.variants:
            fns = variant_fns(dev, tmp)
            for batch in (8, 1):
                gen = torch.Generator().manual_seed(1)
                margs = cs.mask_inputs(gen, dev, batch, 100)
                want = mask_assembly.assemble_masks_plain(*margs)
                check('mask_assembly', f'b{batch} variant kernel',
                      fns['kernel'](*margs), want)
                del want
                times = {name: cs.device_times(lambda f=fn: f(*margs),
                                               SYMBOLS['mask_assembly'])[1]
                         for name, fn in fns.items()}
                print(f'b{batch} mask_assembly variants: device ms '
                      '(torch.profiler kernel events, 20 calls) ' + ', '.join(
                          f'{k} {v!r}' for k, v in times.items())
                      + f' [{card}; SM clock, power: {sm_clock()}]')
        gen = torch.Generator().manual_seed(1)
        for batch in (8, 1):
            margs = cs.mask_inputs(gen, dev, batch, 100)
            boxes = cs.iou_inputs(gen, dev, batch * 80, 200)
            plain = {'mask_assembly': mask_assembly.assemble_masks_plain(*margs),
                     'fast_nms_iou_max': nms.nms_iou_max_plain(boxes)}
            bounds = cs.small_kernel_bounds(margs, boxes)
            calls = {}
            for tag, (masks, iou) in impls.items():
                calls[tag] = {'mask_assembly': lambda m=masks: m(*margs),
                              'fast_nms_iou_max': lambda f=iou: f(boxes)}
                for name, fn in calls[tag].items():
                    check(name, f'b{batch} {tag}', fn(), plain[name])
            order = (['parent', 'kernel', 'kernel', 'parent'] if args.parent
                     else ['kernel', 'kernel'])
            for name in SYMBOLS:
                times = [(tag, cs.device_times(calls[tag][name],
                                               SYMBOLS[name])[1])
                         for tag in order]
                b_ms, b_by = bounds[name]
                print(f'b{batch} {name}: device ms (torch.profiler kernel '
                      f'events, 20 calls) ' + ', '.join(
                          f'{t} {ms!r}' for t, ms in times)
                      + f'; bound {b_ms!r} by {b_by} [{card}; SM clock, '
                      f'power: {sm_clock()}]')


if __name__ == '__main__':
    main()
