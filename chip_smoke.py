#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (yolact_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It imports nothing of JAX.  Phases, each of which
raises on failure:

1. device: the card's name and power limit (nvidia-smi); exit 1 without CUDA
2. build: both kernels compiled from yolact_tpu_torch/csrc/*.cu
3. kernels vs their plain PyTorch versions on the card at main-path shapes
4. main path: Pipeline(yolact_base) at 550x550 with seeded random weights,
   b1 and b8 in bf16 and b1 in f32 (TF32 off), with the kernels and with the
   plain versions, for (a) a dense conf head (most priors pass conf_thresh:
   the unpruned NMS fallback) and (b) a background-biased one (a few
   hundred pass: the pruned NMS tail); the kernels' launch counts over the
   kernel-path runs must be above 0
5. timing with CUDA events over 100 calls: median and p90 ms per batch at
   b1 / b8 bf16, and each kernel's call time against its plain version

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
from yolact_tpu_torch.kernels import _build, mask_assembly, nms
from yolact_tpu_torch.ops.anchors import proto_size

KERNELS = {
    'fast_nms_iou_max': dict(
        source='yolact_tpu_torch/csrc/fast_nms_iou.cu',
        replaces='yolact_tpu/kernels/nms_pallas.py:23', tol=1e-6),
    'mask_assembly': dict(
        source='yolact_tpu_torch/csrc/mask_assembly.cu',
        replaces='yolact_tpu/kernels/mask_assembly.py:24', tol=1e-5),
}
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


def kernel_vs_plain(dev):
    """Each kernel against its plain version; returns the max abs error at
    the main-path shape per kernel."""
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
    return errs


# ---- phase 4: the main path ---------------------------------------------

def shape_conf(sd, num_classes, scale, bg_bias):
    """Scale the random conf head and add `bg_bias` to its background
    logit.  Xavier-random weights leave the 81-way softmax nearly flat
    (logit std 0.47 at yolact_base), so no prior passes conf_thresh=0.05;
    a head scaled by 3 gives peaked scores like a trained one: ~18,400 of
    the 19,248 priors pass (the unpruned NMS fallback), and a background
    bias of +7 on top leaves a few hundred (the pruned tail), of which
    tens per image survive NMS.
    bench.py's +-8 bias alone would leave none here."""
    sd = dict(sd)
    w, b = ('prediction_layers.0.conf_layer.' + n for n in ('weight', 'bias'))
    sd[w] = sd[w] * scale
    bias = (sd[b] * scale).view(-1, num_classes)
    bias[:, 0] += bg_bias
    sd[b] = bias.view(-1)
    return sd


def check_output(tag, out, cfg, batch):
    d = cfg.max_num_detections
    check(tuple(out.boxes.shape) == (batch, d, 4),
          f'{tag}: boxes shape {tuple(out.boxes.shape)}')
    check(tuple(out.masks.shape) == (batch, d) + proto_size(cfg),
          f'{tag}: masks shape {tuple(out.masks.shape)}')
    for name in ('boxes', 'scores', 'masks'):
        check(bool(torch.isfinite(getattr(out, name)).all()),
              f'{tag}: non-finite {name}')


def compare(tag, got, want, exact):
    """Kernel path vs plain path on the same inputs.  Returns the number of
    entries whose validity or class differ."""
    diff = (got.valid != want.valid) | (got.classes != want.classes)
    n_diff = int(diff.sum())
    both = got.valid & want.valid & ~diff
    if bool(both.any()):
        e_score = float((got.scores - want.scores)[both].abs().max())
        e_box = float((got.boxes - want.boxes)[both].abs().max())
        e_mask = float((got.masks - want.masks)[both].abs().max())
    else:
        e_score = e_box = e_mask = 0.0
    print(f'{tag}: valid={int(got.valid.sum())} valid_or_class_diffs={n_diff} '
          f'score_err={e_score!r} box_err={e_box!r} mask_err={e_mask!r}')
    if exact:
        check(n_diff == 0, f'{tag}: valid sets or classes differ')
    check(e_score <= 1e-5 and e_box <= 1e-5 and e_mask <= 1e-4,
          f'{tag}: kernel and plain paths differ beyond tolerance')
    return n_diff


def main_path(cfg, sd, frames8, dev):
    """Both weight sets through Pipeline with kernels and with the plain
    versions.  Returns (launch counts of the kernel-path runs, bf16
    valid/class differences, the sparse bf16 kernel pipeline)."""
    runs = [('b1 bf16', 'bfloat16', 1), ('b8 bf16', 'bfloat16', 8),
            ('b1 f32', 'float32', 1)]
    weights = [('dense', shape_conf(sd, cfg.num_classes, 3.0, 0.0), 'full'),
               ('sparse', shape_conf(sd, cfg.num_classes, 3.0, 7.0), 'pruned')]

    plain = {}
    nms.launches = mask_assembly.launches = 0
    for wname, wsd, _ in weights:
        for rname, dtype, batch in runs:
            pipe = Pipeline(cfg, wsd, dev, dtype, use_kernels=False)
            plain[wname, rname] = pipe(frames8[:batch])
            del pipe
    torch.cuda.synchronize()
    check(nms.launches == 0 and mask_assembly.launches == 0,
          'the plain path launched a kernel')

    kernel_pipes, kernel_out, branches = {}, {}, {}
    for wname, wsd, _ in weights:
        for dtype in ('bfloat16', 'float32'):
            kernel_pipes[wname, dtype] = Pipeline(cfg, wsd, dev, dtype)
    # the main path's run: counts from 0, read right after
    nms.launches = mask_assembly.launches = 0
    for wname, _, _ in weights:
        before = dict(detection.branch_counts)
        for rname, dtype, batch in runs:
            kernel_out[wname, rname] = kernel_pipes[wname, dtype](
                frames8[:batch])
        branches[wname] = {k: detection.branch_counts[k] - before[k]
                           for k in before}
    torch.cuda.synchronize()
    launches = {'fast_nms_iou_max': nms.launches,
                'mask_assembly': mask_assembly.launches}
    print(f'main path launches: {json.dumps(launches)}')
    for name, n in launches.items():
        check(n > 0, f'{name} was not launched on the main path')

    bf16_diffs = 0
    for wname, _, branch in weights:
        print(f'{wname} weights: NMS tails taken {branches[wname]}')
        check(branches[wname][branch] == len(runs),
              f'{wname} weights did not take the {branch} NMS tail')
        for rname, dtype, batch in runs:
            tag = f'{wname} {rname}'
            check_output(tag, kernel_out[wname, rname], cfg, batch)
            check_output(tag + ' plain', plain[wname, rname], cfg, batch)
            n = compare(tag, kernel_out[wname, rname], plain[wname, rname],
                        exact=dtype == 'float32')
            if dtype == 'bfloat16':
                bf16_diffs += n
    check(bool(kernel_out['sparse', 'b8 bf16'].valid.any()),
          'the sparse conf head gave no detections')
    return launches, bf16_diffs, kernel_pipes['sparse', 'bfloat16']


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
    print(f'build (nvcc, both kernels) and load: '
          f'{time.perf_counter() - t0:.2f} s')

    errs = kernel_vs_plain(dev)

    cfg = get_config('yolact_base')
    t0 = time.perf_counter()
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    frames8 = torch.from_numpy(rng.randint(0, 256, (8, 550, 550, 3))
                               .astype(np.float32)).to(dev)
    print(f'weights and frames: {time.perf_counter() - t0:.2f} s')
    launches, bf16_diffs, pipe = main_path(cfg, sd, frames8, dev)
    print(f'bf16 valid/class differences kernel vs plain: {bf16_diffs}')

    # ---- phase 5: timing ----
    for batch in (1, 8):
        x = frames8[:batch]
        ms, p90 = time_ms(lambda: pipe(x))
        print(f'e2e yolact_base 550 bf16 b{batch}: median {ms!r} ms/batch '
              f'({batch * 1000.0 / ms!r} frames/s), p90 {p90!r} ms '
              f'({RUNS} calls, CUDA events) [{card}]')
    gen = torch.Generator().manual_seed(1)
    margs = mask_inputs(gen, dev, 8, 100)
    boxes = iou_inputs(gen, dev, 8 * 80, 200)
    timed = {
        'fast_nms_iou_max': (lambda: nms.nms_iou_max(boxes),
                             lambda: nms.nms_iou_max_plain(boxes),
                             '[640,200,4]'),
        'mask_assembly': (lambda: mask_assembly.assemble_masks(*margs),
                          lambda: mask_assembly.assemble_masks_plain(*margs),
                          'B=8 D=100 138x138 Md=32'),
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
                       'launches': launches[name], 'max_abs_err': errs[name],
                       'ms': ms, 'plain_ms': plain_ms})

    print(json.dumps({'kernels': report}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
