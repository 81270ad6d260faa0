#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (yolact_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It imports nothing of JAX.  Phases, each of which
raises on failure:

1. device: the card's name and power limit (nvidia-smi); exit 1 without CUDA
2. build: the three kernels compiled from yolact_tpu_torch/csrc/*.cu
3. kernels vs their plain PyTorch versions on the card at main-path shapes;
   the DCN sampling at the five yolact_plus_base DCN shapes, in bf16 at b8
   and in f32 at b1, with integer, fractional, far out-of-bounds and
   non-finite offsets
4. the two paths, each at 550x550 with seeded random weights, b1 and b8 in
   bf16 and b1 in f32 (TF32 off), with the kernels and with the plain
   versions, for (a) a dense conf head (most priors pass conf_thresh: the
   unpruned NMS fallback) and (b) a background-biased one (a few hundred
   pass: the pruned NMS tail):
   - Pipeline(yolact_base): the NMS and mask-assembly kernels;
   - Pipeline(yolact_plus_base): ResNet-101 with 11 DCN blocks, whose
     offset convs get seeded non-zero weights (the zero init would put
     every sample on the grid), 57,744 priors, and the maskiou re-scoring;
     all three kernels.
   Each path's launch counts are set to 0 just before its kernel-path runs
   and must be above 0 just after
5. timing with CUDA events over 100 calls: median and p90 ms per batch at
   b1 / b8 bf16 for both paths, and each kernel's call time against its
   plain version

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from yolact_tpu_torch import get_config
from yolact_tpu_torch.detect import detection
from yolact_tpu_torch.infer import Pipeline, random_state_dict
from yolact_tpu_torch.kernels import _build, dcn, mask_assembly, nms
from yolact_tpu_torch.ops.anchors import proto_size

KERNELS = {
    'fast_nms_iou_max': dict(
        source='yolact_tpu_torch/csrc/fast_nms_iou.cu', module=nms,
        replaces='yolact_tpu/kernels/nms_pallas.py:23', tol=1e-6),
    'mask_assembly': dict(
        source='yolact_tpu_torch/csrc/mask_assembly.cu', module=mask_assembly,
        replaces='yolact_tpu/kernels/mask_assembly.py:24', tol=1e-5),
    # f32 columns within 1e-5 (bit-equal expected); bf16 within 1 ulp
    'dcn': dict(
        source='yolact_tpu_torch/csrc/dcn_im2col.cu', module=dcn,
        replaces='scripts/bench_gather2.py:174,239,268; '
                 'scripts/probe_sameshape_gather.py:49 (the gather of '
                 'yolact_tpu/kernels/dcn.py:155 _bilinear_gather)',
        tol=1e-5),
}
# The paths driven, each with its conf-head cells (name, scale, background
# bias, the NMS tail it must take; see shape_conf) and its kernels.
PATHS = {
    'yolact_base': dict(
        cells=(('dense', 3.0, 0.0, 'full'), ('sparse', 3.0, 7.0, 'pruned')),
        kernels=('fast_nms_iou_max', 'mask_assembly')),
    'yolact_plus_base': dict(
        cells=(('dense', 3.0, 0.0, 'full'), ('sparse', 3.0, 7.75, 'pruned')),
        kernels=('fast_nms_iou_max', 'mask_assembly', 'dcn')),
}
# The DCN blocks of yolact_plus_base at 550x550: (blocks, Cin, H, stride);
# 3x3, padding 1, dilation 1 everywhere
DCN_SHAPES = (('layers.1 block 0', 128, 138, 2),
              ('layers.1 block 3', 128, 69, 1),
              ('layers.2 block 0', 256, 69, 2),
              ('layers.2 blocks 3-21', 256, 35, 1),
              ('layers.3 block 0', 512, 35, 2))
RUNS = 100     # timed calls per measurement: p90 has 10 samples beyond it


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def time_ms(fn, runs=RUNS, warmup=5):
    """Median and 90th percentile over `runs` of one call's device time,
    by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), float(np.percentile(times, 90))


# ---- phase 3 inputs ------------------------------------------------------

def mask_inputs(gen, dev, b, d, hw=138, md=32):
    proto = torch.rand(b, hw, hw, md, generator=gen)
    coeffs = torch.tanh(torch.randn(b, d, md, generator=gen))
    xy1 = torch.rand(b, d, 2, generator=gen) * 0.7
    wh = torch.rand(b, d, 2, generator=gen) * 0.5
    boxes = torch.cat([xy1, xy1 + wh], -1)
    boxes[:, 0] = boxes[:, 0, [2, 3, 0, 1]]               # inverted
    boxes[:, 1] = torch.tensor([-0.3, -0.2, 1.4, 1.1])    # outside [0, 1]
    boxes[:, 2] = 0.5                                     # zero area
    boxes[:, 3] = torch.tensor([2, 3, 9, 7]) / hw          # on pixel edges
    return [t.to(dev) for t in (proto, coeffs, boxes)]


def iou_inputs(gen, dev, n, k):
    xy1 = torch.rand(n, k, 2, generator=gen) * 0.6
    wh = torch.rand(n, k, 2, generator=gen) * 0.3 + 0.02
    boxes = torch.cat([xy1, xy1 + wh], -1)
    boxes[:, 1] = boxes[:, 0]                             # IoU exactly 1
    boxes[:, 2, 2:] = boxes[:, 2, :2]                     # zero area
    boxes[:, 3] = torch.tensor([0.1, 0.1, float('inf'), float('inf')])
    boxes[:, 4] = torch.tensor([float('nan'), 0.1, 0.3, 0.3])
    return boxes.to(dev)


def dcn_inputs(gen, dev, b, cin, h, stride, dtype, finite=False):
    """x, offsets and mask of one DCN block.  Offsets mix, per element,
    integers, fractions of a few pixels, far out-of-bounds values (up to
    3 map sizes, both signs) and small ones; unless `finite`, some are NaN
    or infinite."""
    ho = dcn.out_size(h, 3, stride, 1, 1)
    shape = (b, 18, ho, ho)
    kind = torch.randint(0, 4, shape, generator=gen)
    offset = torch.where(
        kind == 0, torch.randint(-4, 5, shape, generator=gen).float(),
        torch.where(kind == 1, torch.randn(shape, generator=gen) * 2,
                    torch.where(kind == 2,
                                (torch.rand(shape, generator=gen) * 2 - 1)
                                * 3 * h,
                                torch.randn(shape, generator=gen) * 0.3)))
    if not finite:     # taps 0-3 of the first pixel: NaN, 0, 0, NaN samples
        nan, inf = float('nan'), float('inf')
        offset[0, :8, 0, 0] = torch.tensor(
            [nan, 0.5, 0.5, inf, -inf, 0.5, 0.5, nan])
    x = torch.randn(b, cin, h, h, generator=gen).to(dtype)
    mask = torch.rand(b, 9, ho, ho, generator=gen).to(dtype)
    return x.to(dev), offset.to(dev), mask.to(dev)


def ulp_distance(a, b):
    """Largest distance in units in the last place between two bfloat16
    tensors of finite values."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7fff), i)
    return int((ordered(a) - ordered(b)).abs().max())


def dcn_vs_plain(dev):
    """The DCN sampling kernel against its plain version at the five
    yolact_plus_base shapes; returns the largest abs error."""
    gen = torch.Generator().manual_seed(2)
    worst = 0.0
    for dtype, batch in ((torch.bfloat16, 8), (torch.float32, 1)):
        for name, cin, h, stride in DCN_SHAPES:
            x, offset, mask = dcn_inputs(gen, dev, batch, cin, h, stride,
                                         dtype)
            got = dcn.dcn_columns(x, offset, mask, 3, stride)
            want = dcn.dcn_columns_plain(x, offset, mask, 3, stride)
            torch.cuda.synchronize()
            nan = want.isnan()
            same_nan = bool(torch.equal(got.isnan(), nan))
            g, w = got[~nan], want[~nan]
            err = float((g.float() - w.float()).abs().max())
            ulps = ulp_distance(g, w) if dtype == torch.bfloat16 else None
            tag = (f'dcn {name} {str(dtype)[6:]} b{batch} x{list(x.shape)} '
                   f'cols{list(got.shape)}')
            print(f'{tag}: max_abs_err={err!r} bit_equal='
                  f'{same_nan and bool(torch.equal(g, w))} same_nan={same_nan}'
                  + ('' if ulps is None else f' max_ulps={ulps}'))
            check(same_nan, f'{tag}: NaN columns differ')
            if dtype == torch.float32:
                check(err <= KERNELS['dcn']['tol'],
                      f'{tag}: disagrees with its plain version')
            else:
                check(ulps <= 1, f'{tag}: more than 1 bf16 ulp off')
            worst = max(worst, err)
            del x, offset, mask, got, want
    return worst


def kernel_vs_plain(dev):
    """Each kernel against its plain version; returns the max abs error at
    the main-path shapes per kernel."""
    gen = torch.Generator().manual_seed(0)
    errs = {}
    for b, d in ((8, 100), (2, 37)):
        args = mask_inputs(gen, dev, b, d)
        got = mask_assembly.assemble_masks(*args)
        want = mask_assembly.assemble_masks_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        same_crop = bool(torch.equal(got == 0, want == 0))
        print(f'mask_assembly B={b} D={d} 138x138 Md=32: max_abs_err={err!r} '
              f'same_crop={same_crop}')
        check(err <= KERNELS['mask_assembly']['tol'] and same_crop,
              f'mask_assembly disagrees with its plain version (B={b}, D={d})')
        errs.setdefault('mask_assembly', err)
    for n, k in ((8 * 80, 200), (8 * 80, 37)):
        boxes = iou_inputs(gen, dev, n, k)
        got = nms.nms_iou_max(boxes)
        want = nms.nms_iou_max_plain(boxes)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f'fast_nms_iou_max [{n},{k},4]: max_abs_err={err!r} '
              f'bit_equal={bool(torch.equal(got, want))}')
        check(err <= KERNELS['fast_nms_iou_max']['tol'],
              f'fast_nms_iou_max disagrees with its plain version (K={k})')
        errs.setdefault('fast_nms_iou_max', err)
    errs['dcn'] = dcn_vs_plain(dev)
    return errs


# ---- phase 4: the main path ---------------------------------------------

def shape_conf(sd, num_classes, scale, bg_bias):
    """Scale the random conf head and add `bg_bias` to its background
    logit.  Xavier-random weights leave the 81-way softmax nearly flat
    (logit std 0.47 at yolact_base), so no prior passes conf_thresh=0.05;
    a head scaled by 3 gives peaked scores like a trained one: ~18,400 of
    the 19,248 yolact_base priors pass (the unpruned NMS fallback), and a
    background bias of +7 on top leaves a few hundred (the pruned tail),
    of which tens per image survive NMS.  yolact_plus_base has three times
    the priors and needs +7.75 to stay under nms_candidates=1024.
    bench.py's +-8 bias alone would leave none here."""
    sd = dict(sd)
    w, b = ('prediction_layers.0.conf_layer.' + n for n in ('weight', 'bias'))
    sd[w] = sd[w] * scale
    bias = (sd[b] * scale).view(-1, num_classes)
    bias[:, 0] += bg_bias
    sd[b] = bias.view(-1)
    return sd


def seed_offsets_state_dict(sd, gen, w_scale=0.05, b_scale=2.0):
    """Seeded non-zero weights for every DCN offset/mask conv: the zero
    init would put every sample on a grid point and leave the kernel's
    bilinear and out-of-bounds paths unused."""
    sd = dict(sd)
    for key in [k for k in sd if 'conv_offset_mask' in k]:
        scale = w_scale if key.endswith('weight') else b_scale
        sd[key] = torch.randn(sd[key].shape, generator=gen) * scale
    return sd


def reset_launches():
    for info in KERNELS.values():
        info['module'].launches = 0


def read_launches(names):
    return {name: KERNELS[name]['module'].launches for name in names}


def check_output(tag, out, cfg, batch):
    d = cfg.max_num_detections
    check(tuple(out.boxes.shape) == (batch, d, 4),
          f'{tag}: boxes shape {tuple(out.boxes.shape)}')
    check(tuple(out.masks.shape) == (batch, d) + proto_size(cfg),
          f'{tag}: masks shape {tuple(out.masks.shape)}')
    names = ['boxes', 'scores', 'masks']
    if cfg.use_maskiou:
        check(out.mask_scores is not None and
              tuple(out.mask_scores.shape) == (batch, d),
              f'{tag}: no [{batch}, {d}] mask_scores')
        names.append('mask_scores')
    for name in names:
        check(bool(torch.isfinite(getattr(out, name)).all()),
              f'{tag}: non-finite {name}')


def compare(tag, got, want, exact):
    """Kernel path vs plain path on the same inputs.  Returns the number of
    entries whose validity or class differ."""
    diff = (got.valid != want.valid) | (got.classes != want.classes)
    n_diff = int(diff.sum())
    both = got.valid & want.valid & ~diff
    names = ['scores', 'boxes', 'masks'] + (
        ['mask_scores'] if got.mask_scores is not None else [])
    errs = {name: float((getattr(got, name) - getattr(want, name))[both]
                        .abs().max()) if bool(both.any()) else 0.0
            for name in names}
    print(f'{tag}: valid={int(got.valid.sum())} valid_or_class_diffs={n_diff} '
          + ' '.join(f'{n}_err={e!r}' for n, e in errs.items()))
    if exact:
        check(n_diff == 0, f'{tag}: valid sets or classes differ')
    tol = {'scores': 1e-5, 'boxes': 1e-5, 'masks': 1e-4, 'mask_scores': 1e-4}
    check(all(e <= tol[n] for n, e in errs.items()),
          f'{tag}: kernel and plain paths differ beyond tolerance')
    return n_diff


def main_path(name, sd, frames8, dev):
    """One path: both conf cells through Pipeline with kernels and with
    the plain versions.  Returns (launch counts of the kernel-path runs,
    bf16 valid/class differences, the sparse bf16 kernel pipeline)."""
    cfg = get_config(name)
    path = PATHS[name]
    runs = [('b1 bf16', 'bfloat16', 1), ('b8 bf16', 'bfloat16', 8),
            ('b1 f32', 'float32', 1)]
    weights = [(wname, shape_conf(sd, cfg.num_classes, scale, bias), branch)
               for wname, scale, bias, branch in path['cells']]

    plain = {}
    reset_launches()
    for wname, wsd, _ in weights:
        for rname, dtype, batch in runs:
            pipe = Pipeline(cfg, wsd, dev, dtype, use_kernels=False)
            plain[wname, rname] = pipe(frames8[:batch])
            del pipe
    torch.cuda.synchronize()
    check(not any(read_launches(KERNELS).values()),
          f'{name}: the plain path launched a kernel')

    kernel_pipes, kernel_out, branches = {}, {}, {}
    for wname, wsd, _ in weights:
        for dtype in ('bfloat16', 'float32'):
            kernel_pipes[wname, dtype] = Pipeline(cfg, wsd, dev, dtype)
    # the path's run: counts from 0, read right after
    reset_launches()
    for wname, _, _ in weights:
        before = dict(detection.branch_counts)
        for rname, dtype, batch in runs:
            kernel_out[wname, rname] = kernel_pipes[wname, dtype](
                frames8[:batch])
        branches[wname] = {k: detection.branch_counts[k] - before[k]
                           for k in before}
    torch.cuda.synchronize()
    launches = read_launches(path['kernels'])
    print(f'{name} path launches: {json.dumps(launches)}')
    for kname, n in launches.items():
        check(n > 0, f'{kname} was not launched on the {name} path')

    bf16_diffs = 0
    for wname, _, branch in weights:
        print(f'{name} {wname} weights: NMS tails taken {branches[wname]}')
        check(branches[wname][branch] == len(runs),
              f'{name} {wname} weights did not take the {branch} NMS tail')
        for rname, dtype, batch in runs:
            tag = f'{name} {wname} {rname}'
            check_output(tag, kernel_out[wname, rname], cfg, batch)
            check_output(tag + ' plain', plain[wname, rname], cfg, batch)
            n = compare(tag, kernel_out[wname, rname], plain[wname, rname],
                        exact=dtype == 'float32')
            if dtype == 'bfloat16':
                bf16_diffs += n
    check(bool(kernel_out['sparse', 'b8 bf16'].valid.any()),
          f'{name}: the sparse conf head gave no detections')
    print(f'{name} bf16 valid/class differences kernel vs plain: '
          f'{bf16_diffs}')
    return launches, kernel_pipes['sparse', 'bfloat16']


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this smoke '
              'test needs an NVIDIA GPU', file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.load()
    print(f'build (nvcc, {len(_build._sources())} kernels in parallel) and '
          f'load: {time.perf_counter() - t0:.2f} s')

    errs = kernel_vs_plain(dev)

    rng = np.random.RandomState(0)
    frames8 = torch.from_numpy(rng.randint(0, 256, (8, 550, 550, 3))
                               .astype(np.float32)).to(dev)
    pipes, launches = {}, {}
    for name in PATHS:
        t0 = time.perf_counter()
        sd = random_state_dict(get_config(name),
                               torch.Generator().manual_seed(0))
        sd = seed_offsets_state_dict(sd, torch.Generator().manual_seed(3))
        print(f'{name} weights: {time.perf_counter() - t0:.2f} s')
        launches[name], pipes[name] = main_path(name, sd, frames8, dev)
        del sd

    # ---- phase 5: timing ----
    for name, pipe in pipes.items():
        for batch in (1, 8):
            x = frames8[:batch]
            ms, p90 = time_ms(lambda: pipe(x))
            print(f'e2e {name} 550 bf16 b{batch}: median {ms!r} ms/batch '
                  f'({batch * 1000.0 / ms!r} frames/s), p90 {p90!r} ms '
                  f'({RUNS} calls, CUDA events) [{card}]')
    del pipes
    gen = torch.Generator().manual_seed(1)
    margs = mask_inputs(gen, dev, 8, 100)
    boxes = iou_inputs(gen, dev, 8 * 80, 200)
    dargs = dcn_inputs(gen, dev, 8, 256, 35, 1, torch.bfloat16, finite=True)
    timed = {
        'fast_nms_iou_max': (lambda: nms.nms_iou_max(boxes),
                             lambda: nms.nms_iou_max_plain(boxes),
                             '[640,200,4]'),
        'mask_assembly': (lambda: mask_assembly.assemble_masks(*margs),
                          lambda: mask_assembly.assemble_masks_plain(*margs),
                          'B=8 D=100 138x138 Md=32'),
        'dcn': (lambda: dcn.dcn_columns(*dargs),
                lambda: dcn.dcn_columns_plain(*dargs),
                'layers.2 x[8,256,35,35] bf16 -> cols[8,2304,1225]'),
    }
    report = []
    for name, (kern, plain, shape) in timed.items():
        plain_ms, plain_p90 = time_ms(plain)
        ms, p90 = time_ms(kern)
        print(f'kernel {name} {shape}: median {ms!r} ms (p90 {p90!r}), '
              f'plain median {plain_ms!r} ms (p90 {plain_p90!r}) '
              f'({RUNS} calls each; call time: wrapper, launch and device, '
              f'CUDA events) [{card}]')
        info = KERNELS[name]
        report.append({'name': name, 'route': 'cuda', 'source': info['source'],
                       'replaces': info['replaces'],
                       'launches': launches['yolact_plus_base'][name],
                       'max_abs_err': errs[name], 'ms': ms,
                       'plain_ms': plain_ms})

    print(json.dumps({'kernels': report}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
