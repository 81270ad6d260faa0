#!/usr/bin/env python3
"""The stem kernel's float32 branch on one NVIDIA GPU.

    python3 probe_stem.py [--sensitivity]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Each variant is ``yolact_tpu_torch/csrc/stem_s2d.cu`` with one part taken
out by text substitution, built into a library of its own and called
through the same C entry point: ``kernel`` (the source as it is),
``two_products`` (no lo*hi product: the sums lose the input's lo half),
``no_stores`` (the output stores skipped) and ``no_staging`` (the next
tile's halo not loaded: the tile reuses a stale one).  At yolact_base 550
b8 (``[8,12,275,275]`` float32, TF32 off) it prints each variant's
registers, its error against the plain version (the variants that drop a
part are wrong by design) and its device time (torch.profiler kernel
events, 20 calls; the kernel first and last), beside the plain version
(a float32 conv of the padded input) and cuDNN's float32 4x4 and 7x7/s2
convs of the same function.

``--sensitivity`` also measures how far chip_smoke.py's yolact_base train
check (three 550 b8 float32 steps, kernels against plain versions, the
first-step gradient of conv1 within 1e-3 of its largest entry) moves when
the plain stem's float32 output alone is multiplied by 1 + eps N(0, 1), for
eps of about one ulp and more, and with the stem kernel, under batch
statistics and with frozen batch norm.
"""

import argparse
import ctypes
import os
import subprocess
import tempfile

import torch
import torch.nn.functional as F

import chip_smoke as cs
from yolact_tpu_torch import get_config
from yolact_tpu_torch.infer import random_state_dict
from yolact_tpu_torch.kernels import _build, stem

SOURCE = 'yolact_tpu_torch/csrc/stem_s2d.cu'
LO_HI = ('for (int m = 0; m < 4; ++m) mma_tf32(acc[m][n], alo[m], bh[n][0], '
         'bh[n][1]);')
STORE = '*reinterpret_cast<float2*>(dst + n * 8) ='
STAGE = ('      f32_stage_halo(x, halo_base + (buf ^ 1) * kF32HaloBytes, next, '
         'h, w);')


def variants(src):
    """{name: source}; raises if the source no longer has the lines the
    substitutions rewrite."""
    for line in (LO_HI, STORE, STAGE):
        if line not in src:
            raise RuntimeError(f'probe_stem: {line!r} not in {SOURCE}')
    return {'kernel': src,
            'two_products': src.replace(LO_HI, ';'),
            'no_stores': src.replace(STORE, 'if (acc[m][n][2 * half] == '
                                     '-1.5e38f) ' + STORE),
            'no_staging': src.replace(STAGE, '      if (next < 0) '
                                      + STAGE.strip())}


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
            raise RuntimeError(f'probe_stem: nvcc failed on {name}:\n{err}')
        lines = err.splitlines()
        at = [i for i, l in enumerate(lines) if 'stem_s2d_tf32_kernel' in l]
        regs = [l.strip() for l in lines[at[0]:at[0] + 4]
                if 'registers' in l or 'spill' in l] if at else []
        print(f'{name}: {regs}')
        fn = ctypes.CDLL(os.path.join(out_dir, f'{name}.so'))\
            .yolact_stem_s2d_conv
        fn.argtypes = _build.SIGNATURES['yolact_stem_s2d_conv']
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def timing(dev, card):
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(8, 12, 275, 275, generator=gen).to(dev)
    w2 = (torch.randn(64, 12, 4, 4, generator=gen) * 0.1).to(dev)
    x3 = torch.randn(8, 3, 550, 550, generator=gen).to(dev)
    w7 = (torch.randn(64, 3, 7, 7, generator=gen) * 0.1).to(dev)
    want = stem.stem_conv_s2d_plain(x, w2)
    top = float(want.abs().max())
    with open(SOURCE) as f:
        sources = variants(f.read())
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(sources, tmp)
        for name in list(fns) + ['kernel']:
            out = torch.empty_like(want)

            def call(fn=fns[name], out=out):
                _build.check(fn(x.data_ptr(), w2.data_ptr(), out.data_ptr(),
                                0, 8, 275, 275, _build.stream_ptr(dev)), name)
            call()
            torch.cuda.synchronize()
            err = float((out - want).abs().max()) / top
            ms = cs.device_times(call, 'stem_s2d_tf32_kernel')[1]
            print(f'stem f32 b8 {name}: {ms!r} ms, max_abs_err / max|plain| '
                  f'{err!r} (torch.profiler kernel events, 20 calls) [{card}]')
    for name, fn in (('plain', lambda: stem.stem_conv_s2d_plain(x, w2)),
                     ('cuDNN 4x4', lambda: F.conv2d(x, w2, padding=2)),
                     ('cuDNN 7x7/s2',
                      lambda: F.conv2d(x3, w7, stride=2, padding=3))):
        print(f'stem f32 b8 {name}: {cs.device_times(fn)[0]!r} ms (all the '
              f'call\'s kernels) [{card}]')


def sensitivity(dev, card):
    sd = cs.tame_residuals(cs.seed_offsets_state_dict(
        random_state_dict(get_config('yolact_base'),
                          torch.Generator().manual_seed(0)),
        torch.Generator().manual_seed(3)))
    names = ('backbone.conv1.weight',)
    plain = stem.stem_conv_s2d_plain

    def perturbed(eps):
        def conv(x, w2):
            out = plain(x, w2)
            noise = torch.randn(out.shape, device=out.device,
                                generator=torch.Generator(device=out.device)
                                .manual_seed(1))
            return out * (1 + eps * noise)
        return conv

    for frozen in (False, True):
        cfg = get_config('yolact_base').copy(lr=1e-4, lr_warmup_init=1e-7,
                                             stem_s2d=True, freeze_bn=frozen)
        batch = cs.make_train_batch(cfg)

        def run(use_kernels):
            with cs.deterministic_library():
                _, losses, grads, _ = cs.run_train_steps(
                    cfg, sd, batch, dev, use_kernels, names)
            return losses, grads[names[0]]

        ref = run(False)
        bn = 'frozen batch norm' if frozen else 'batch statistics'
        for tag, conv, kernels in (
                [('plain again', plain, False)]
                + [(f'plain stem x (1 + {eps} N(0,1))', perturbed(eps), False)
                   for eps in (6e-8, 2e-7, 1e-6)]
                + [('stem kernel', plain, True)]):
            stem.stem_conv_s2d_plain = conv
            try:
                losses, grad = run(kernels)
            finally:
                stem.stem_conv_s2d_plain = plain
            rel = float((grad - ref[1]).abs().max() / ref[1].abs().max())
            loss = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in
                       zip(losses, ref[0]) for k in ('B', 'M', 'C', 'S'))
            print(f'yolact_base 550 b8 f32, {bn}, {tag} against the plain '
                  f'versions: first-step conv1 gradient max_abs_err / max '
                  f'{rel!r} (criterion 1e-3), largest loss difference '
                  f'{loss!r} relative [{card}]')


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--sensitivity', action='store_true',
                        help='also the train check\'s sensitivity')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('probe_stem: needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    _build.load()
    timing(dev, card)
    if args.sensitivity:
        sensitivity(dev, card)


if __name__ == '__main__':
    main()
