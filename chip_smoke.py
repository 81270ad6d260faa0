#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (yolact_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It imports nothing of JAX or of the JAX package.
Phases, each of which raises on failure:

1. device: the card's name and power limit (nvidia-smi); exit 1 without CUDA
2. build: the four kernels compiled from yolact_tpu_torch/csrc/*.cu
3. kernels vs their plain PyTorch versions on the card at main-path shapes:
   mask assembly at b8 and b1 (B x 100, 138x138, Md 32), a ragged D and a
   NaN coefficient row, within 1e-5 with the same zeros and NaNs (its max
   error printed); the IoU max bit for bit at [640,200], [80,200], K = 37,
   rows of near ties and of identical boxes; the DCN sampling at the five yolact_plus_base DCN shapes and one with
   Cin % 8 != 0, in bf16 at b8 and in f32 at b1, with integer, fractional,
   far out-of-bounds and non-finite offsets, bit for bit, from NCHW and
   channels_last inputs; the s2d stem conv at the yolact_base shapes (bf16
   b8, f32 b1) and an odd one: f32 within 1e-5 of max|out|, bf16 within
   one bf16 ulp of |plain| plus 1e-5 of max|plain|
4. the three paths, each at 550x550 with seeded random weights, b1 and b8
   in bf16 and b1 in f32 (TF32 off), with the kernels and with the plain
   versions, for (a) a dense conf head (most priors pass conf_thresh: the
   unpruned NMS fallback) and (b) a background-biased one (a few hundred
   pass: the pruned NMS tail):
   - yolact_base through the plain 7x7/s2 stem (load_model and
     forward_and_detect): the NMS and mask-assembly kernels;
   - Pipeline(yolact_base), which takes the space-to-depth stem for raw
     frames: the stem kernel as well, held against the plain-stem path
     (exactly in f32, as matched sets in bf16);
   - Pipeline(yolact_plus_base): ResNet-101 with 11 DCN blocks, whose
     offset convs get seeded non-zero weights (the zero init would put
     every sample on the grid), 57,744 priors, and the maskiou re-scoring;
     the NMS, mask-assembly, DCN and stem kernels.
   Each path's launch counts are set to 0 just before its kernel-path runs
   and must be above 0 just after; paths with the bf16 s2d stem are held
   against their plain versions as matched sets in bf16, exactly in f32
5. eval: evaluate_dataset over 16 seeded in-memory 550x550 frames with
   boxes and masks (no image files, no cv2), yolact_base sparse cell, b8
   bf16: fast NMS with the s2d stem (kernels, then plain versions: the same
   mAP table) and traditional NMS; launch counts checked, tables and
   frames/s printed
6. timing: median and p90 ms per batch at b1 / b8 bf16 for every path
   (CUDA events over 100 calls; the s2d A/B in the order plain, s2d, s2d,
   plain), device busy and idle share per batch (torch.profiler kernel
   events) with the top kernels, yolact_plus_base's DCN sampling and GEMM
   kernels per batch, the 11 DCN blocks at their shapes (sampling, GEMM
   against one on per-image [Cin*9, Ho*Wo] columns and a cuDNN 3x3 conv,
   the block's tail on channels_last against NCHW), and each kernel's
   device time against its plain version, its bound and, for the stem,
   cuDNN's convs (the IoU max and mask assembly at b8 and b1)

The line before the last is a JSON object with each kernel's launches,
error, times and bound; the last line is {"ok": true, "device": {...}}.
"""

import collections
import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from yolact_tpu_torch import MEANS, STD, get_config
from yolact_tpu_torch.detect import detection
from yolact_tpu_torch.eval.evaluate import evaluate_dataset
from yolact_tpu_torch.infer import (Pipeline, forward_and_detect, load_model,
                                    maybe_enable_stem_s2d, random_state_dict)
from yolact_tpu_torch.kernels import _build, dcn, mask_assembly, nms, stem
from yolact_tpu_torch.models.resnet import DCNLayer
from yolact_tpu_torch.ops.anchors import proto_size

# Each kernel with the path whose launches the kernels line reports.
KERNELS = {
    # bit-equal: `iou_max <= nms_thresh` decisions depend on the last bit
    'fast_nms_iou_max': dict(
        source='yolact_tpu_torch/csrc/fast_nms_iou.cu', module=nms,
        replaces='yolact_tpu/kernels/nms_pallas.py:23', tol=0.0,
        path='yolact_base'),
    # within 1e-5, the same zero pattern and NaNs: the kernel sums the
    # Md products on the tensor cores in split TF32 (~2^-21 relative per
    # product, another order than the plain float32 sum)
    'mask_assembly': dict(
        source='yolact_tpu_torch/csrc/mask_assembly.cu', module=mask_assembly,
        replaces='yolact_tpu/kernels/mask_assembly.py:24', tol=1e-5,
        path='yolact_base'),
    # the columns bit-equal to the plain version, NaNs included
    'dcn': dict(
        source='yolact_tpu_torch/csrc/dcn_im2col.cu', module=dcn,
        replaces='scripts/bench_gather2.py:174,239,268; '
                 'scripts/probe_sameshape_gather.py:49 (the gather of '
                 'yolact_tpu/kernels/dcn.py:155 _bilinear_gather)',
        tol=1e-5, path='yolact_plus_base'),
    # f32 within 1e-5 of max|out| (TF32 off; cuDNN may sum the 192 products
    # in another order); bf16 within one bf16 ulp of |plain| plus 1e-5 of
    # max|plain| (the tensor cores sum the exact products in another order
    # than the float32 conv rounded once; the absolute term covers outputs
    # near zero after cancellation)
    'stem_s2d': dict(
        source='yolact_tpu_torch/csrc/stem_s2d.cu', module=stem,
        replaces='yolact_tpu/kernels/stem.py:52', tol=1e-5,
        path='yolact_base_s2d'),
}
# The paths driven, each with its config, its conf-head cells (name,
# scale, background bias, the NMS tail it must take; see shape_conf) and
# its kernels.  Pipeline takes the space-to-depth stem for raw frames, as
# JAX's does: yolact_base_s2d is Pipeline(yolact_base), and yolact_base
# is the same weights through the plain 7x7/s2 stem (load_model and
# forward_and_detect, PlainStemPipeline).
PATHS = {
    'yolact_base': dict(
        config='yolact_base', plain_stem=True,
        cells=(('dense', 3.0, 0.0, 'full'), ('sparse', 3.0, 7.0, 'pruned')),
        kernels=('fast_nms_iou_max', 'mask_assembly')),
    'yolact_base_s2d': dict(
        config='yolact_base',
        cells=(('dense', 3.0, 0.0, 'full'), ('sparse', 3.0, 7.0, 'pruned')),
        kernels=('fast_nms_iou_max', 'mask_assembly', 'stem_s2d')),
    'yolact_plus_base': dict(
        config='yolact_plus_base',
        cells=(('dense', 3.0, 0.0, 'full'), ('sparse', 3.0, 7.75, 'pruned')),
        kernels=('fast_nms_iou_max', 'mask_assembly', 'dcn', 'stem_s2d')),
}
# The 11 DCN blocks of yolact_plus_base at 550x550: (blocks, how many per
# batch, Cin = Cout, H, stride); 3x3, padding 1, dilation 1 everywhere
DCN_SHAPES = (('layers.1 block 0', 1, 128, 138, 2),
              ('layers.1 block 3', 1, 128, 69, 1),
              ('layers.2 block 0', 1, 256, 69, 2),
              ('layers.2 blocks 3-21', 7, 256, 35, 1),
              ('layers.3 block 0', 1, 512, 35, 2))
# Cin % 8 != 0: the kernel's channel-by-channel path
DCN_ODD_SHAPE = ('Cin 60', 0, 60, 35, 1)
# The card's data-sheet rates (H100 SXM at 700 W): the bound of a kernel is
# the larger of its bytes over the memory rate and its operations over the
# rate of their type
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# The s2d stem conv: yolact_base 550 at b8 bf16 and b1 f32, and an odd shape
STEM_SHAPES = ((torch.bfloat16, (8, 12, 275, 275)),
               (torch.float32, (1, 12, 275, 275)),
               (torch.bfloat16, (2, 12, 37, 41)),
               (torch.float32, (2, 12, 37, 41)))
EVAL_FRAMES = 16
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


def device_ms(fn, runs=50, warmup=5):
    """Device time of one call, by CUDA events around `runs` calls launched
    back to back: the card never waits for the host, so for kernels longer
    than their launch this is the device time per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs

# ---- phase 3 inputs ------------------------------------------------------

def mask_inputs(gen, dev, b, d, hw=138, md=32, nan_row=False):
    proto = torch.rand(b, hw, hw, md, generator=gen)
    coeffs = torch.tanh(torch.randn(b, d, md, generator=gen))
    if nan_row:
        coeffs[0, 4, 1] = float('nan')                    # a NaN mask
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


def near_tie_boxes(n, k, seed=0):
    """[n, k, 4] boxes whose last column's IoU max is decided between
    two earlier boxes (positions k - 3 and k - 2, both orders) with IoUs
    equal from different fractions, one float32 ulp apart, or with equal
    float32 cross products inter_a * union_b == inter_b * union_a (the
    kernel's fmaf tie test); the rest lie right of the column box, apart
    from it.  Found by a seeded search over 200,000 boxes on a 1/1024 grid."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    col = np.array([0.25, 0.25, 0.75, 0.625], f32)
    xy = rng.randint(0, 1024, (200000, 2))
    cand = (np.concatenate([xy, xy + rng.randint(1, 512, (200000, 2))], 1)
            / 1024).astype(f32)
    ix = np.minimum(cand[:, 2], col[2]) - np.maximum(cand[:, 0], col[0])
    iy = np.minimum(cand[:, 3], col[3]) - np.maximum(cand[:, 1], col[1])
    inter = np.maximum(ix, f32(0)) * np.maximum(iy, f32(0))
    area = (cand[:, 2] - cand[:, 0]) * (cand[:, 3] - cand[:, 1])
    uni = (area + (col[2] - col[0]) * (col[3] - col[1])) - inter
    ok = (inter > 0) & (uni > 0)
    cand, inter, uni = cand[ok], inter[ok], uni[ok]
    order = np.argsort(inter / uni, kind='stable')
    cand, inter, uni = cand[order], inter[order], uni[order]
    q = inter / uni
    p1, p2 = inter[1:] * uni[:-1], inter[:-1] * uni[1:]
    exact = (inter[1:].astype(np.float64) * uni[:-1]
             - inter[:-1].astype(np.float64) * uni[1:])
    pick = np.flatnonzero(((p1 == p2) & (exact != 0))
                          | ((q[1:] == q[:-1]) & (inter[1:] != inter[:-1]))
                          | (q[1:] == np.nextafter(q[:-1], f32(np.inf))))
    # k >= 3; filler boxes with x1 <= y1 <= x2 <= y2 in [0.85, 0.95]
    boxes = np.sort(rng.rand(n, k, 4).astype(f32) * f32(0.1), -1) + f32(0.85)
    for r in range(n):
        a = pick[(r // 2) * len(pick) // ((n + 1) // 2)]     # spread over q
        boxes[r, k - 3:k - 1] = cand[[a, a + 1]] if r % 2 else cand[[a + 1, a]]
        boxes[r, k - 1] = col
    return boxes


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


def ulps(a, b):
    """Elementwise distance in units in the last place between two bfloat16
    tensors of finite values."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7fff), i)
    return (ordered(a) - ordered(b)).abs()


def bf16_ulp(t):
    """One bfloat16 ulp of |t| (8 significant bits), 0 where t is 0."""
    _, e = torch.frexp(t.float())
    return torch.where(t == 0, 0.0, torch.ldexp(torch.ones_like(t.float()),
                                                e - 8))


def dcn_vs_plain(dev):
    """The DCN sampling kernel against its plain version at the five
    yolact_plus_base shapes; returns the largest abs error."""
    gen = torch.Generator().manual_seed(2)
    worst = 0.0
    for dtype, batch in ((torch.bfloat16, 8), (torch.float32, 1)):
        for name, _, cin, h, stride in DCN_SHAPES + (DCN_ODD_SHAPE,):
            x, offset, mask = dcn_inputs(gen, dev, batch, cin, h, stride,
                                         dtype)
            got = dcn.dcn_columns(x, offset, mask, 3, stride)
            want = dcn.dcn_columns_plain(x, offset, mask, 3, stride)
            # a channels_last x is read as it lies: the same columns
            cl = dcn.dcn_columns(
                x.contiguous(memory_format=torch.channels_last), offset,
                mask, 3, stride)
            torch.cuda.synchronize()
            nan = want.isnan()
            same_nan = bool(torch.equal(got.isnan(), nan))
            g, w = got[~nan], want[~nan]
            err = float((g.float() - w.float()).abs().max())
            equal = same_nan and bool(torch.equal(g, w))
            tag = (f'dcn {name} {str(dtype)[6:]} b{batch} x{list(x.shape)} '
                   f'cols{list(got.shape)}')
            print(f'{tag}: max_abs_err={err!r} bit_equal={equal} '
                  f'same_nan={same_nan} nan_columns={int(nan.sum())}')
            check(equal, f'{tag}: not bit-equal to its plain version')
            check(bool(torch.equal(cl.nan_to_num(), got.nan_to_num())),
                  f'{tag}: a channels_last x gives other columns')
            worst = max(worst, err)
            del x, offset, mask, got, want, cl
    return worst


def stem_vs_plain(dev):
    """The s2d stem kernel against its plain version (float32 conv by cuDNN,
    TF32 off, rounded once) at STEM_SHAPES; also prints both against a
    float64 conv.  Returns the largest abs error."""
    gen = torch.Generator().manual_seed(4)
    worst = 0.0
    for dtype, shape in STEM_SHAPES:
        x = torch.randn(shape, generator=gen).to(dtype).to(dev)
        w2 = (torch.randn(64, 12, 4, 4, generator=gen) * 0.1).to(dtype).to(dev)
        got = stem.stem_conv_s2d(x, w2)
        want = stem.stem_conv_s2d_plain(x, w2)
        exact = F.conv2d(F.pad(x.double(), (2, 1, 2, 1)), w2.double())
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        top = float(want.float().abs().max())
        err = float(diff.max())
        rel = err / top
        tag = (f'stem_s2d {str(dtype)[6:]} x{list(shape)}: max_abs_err={err!r} '
               f'rel_to_max={rel!r} vs_float64: kernel '
               f'{float((got.double() - exact).abs().max())!r} plain '
               f'{float((want.double() - exact).abs().max())!r}')
        if dtype == torch.float32:
            print(tag)
            check(rel <= KERNELS['stem_s2d']['tol'],
                  f'{tag}: disagrees with its plain version')
        else:
            big = want.float().abs() >= 1e-3 * top
            over = diff > bf16_ulp(want) + KERNELS['stem_s2d']['tol'] * top
            print(f'{tag} bit_equal_share='
                  f'{float((got == want).float().mean())!r} '
                  f'max_ulps_where_|plain|>=1e-3max='
                  f'{int(ulps(got, want)[big].max())} beyond_criterion='
                  f'{int(over.sum())}')
            check(not bool(over.any()),
                  f'{tag}: beyond one bf16 ulp + 1e-5 max|plain|')
        worst = max(worst, err)
        del x, w2, got, want, exact
    return worst


def kernel_vs_plain(dev):
    """Each kernel against its plain version; returns the max abs error at
    the main-path shapes per kernel."""
    gen = torch.Generator().manual_seed(0)
    errs = {}
    # (B, D, NaN coefficient row): b8 and b1 at yolact_base, a ragged D
    for b, d, nan_row in ((8, 100, False), (1, 100, False), (2, 37, False),
                          (2, 100, True)):
        args = mask_inputs(gen, dev, b, d, nan_row=nan_row)
        got = mask_assembly.assemble_masks(*args)
        want = mask_assembly.assemble_masks_plain(*args)
        torch.cuda.synchronize()
        nan = want.isnan()
        same_nan = bool(torch.equal(got.isnan(), nan))
        err = float((got - want)[~nan].abs().max())
        same_crop = bool(torch.equal(got == 0, want == 0))
        print(f'mask_assembly B={b} D={d} 138x138 Md=32'
              f'{" NaN row" if nan_row else ""}: max_abs_err={err!r} '
              f'same_crop={same_crop} same_nan={same_nan} '
              f'nan_outputs={int(nan.sum())}')
        check(err <= KERNELS['mask_assembly']['tol'] and same_crop
              and same_nan, f'mask_assembly disagrees with its plain '
              f'version (B={b}, D={d}, NaN row {nan_row})')
        errs['mask_assembly'] = max(errs.get('mask_assembly', 0.0), err)
    print(f'mask_assembly max abs error over all shapes: '
          f'{errs["mask_assembly"]!r}')
    identical = torch.rand(8, 1, 4, generator=gen).sort(-1).values\
        .expand(8, 200, 4).contiguous()
    cases = (('b8', iou_inputs(gen, dev, 8 * 80, 200)),
             ('b1', iou_inputs(gen, dev, 80, 200)),
             ('b8 K=37', iou_inputs(gen, dev, 8 * 80, 37)),
             ('b1 near ties', torch.from_numpy(near_tie_boxes(80, 200))
              .to(dev)),
             ('identical boxes', identical.to(dev)))
    for tag, boxes in cases:
        got = nms.nms_iou_max(boxes)
        want = nms.nms_iou_max_plain(boxes)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        equal = bool(torch.equal(got, want))
        print(f'fast_nms_iou_max {tag} {list(boxes.shape)}: '
              f'max_abs_err={err!r} bit_equal={equal}')
        check(equal, f'fast_nms_iou_max is not bit-equal to its plain '
              f'version ({tag})')
        errs['fast_nms_iou_max'] = max(errs.get('fast_nms_iou_max', 0.0),
                                       err)
    errs['dcn'] = dcn_vs_plain(dev)
    errs['stem_s2d'] = stem_vs_plain(dev)
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


TOL = {'scores': 1e-5, 'boxes': 1e-5, 'masks': 1e-4, 'mask_scores': 1e-4}


def tie_slots(scores, tol):
    """[B, D] bool: detections whose score lies within `tol` of another
    detection's of the same image, where a summation order can swap ranks."""
    gap = (scores[:, :, None] - scores[:, None, :]).abs()
    gap.diagonal(dim1=1, dim2=2).fill_(float('inf'))
    return gap.amin(dim=2) <= tol


def compare(tag, got, want, exact, tol=TOL, ties_ok=False):
    """One path against another on the same inputs.  Returns the number of
    entries whose validity or class differ.  `exact` wants none;
    `ties_ok` allows them where the ranking has a near tie (scores within
    the score tolerance), prints the ties, holds the score sequences
    slot by slot and the other fields off the tied slots."""
    diff = (got.valid != want.valid) | (got.classes != want.classes)
    n_diff = int(diff.sum())
    skip = torch.zeros_like(diff)
    if ties_ok:
        skip = (tie_slots(got.scores, tol['scores'])
                | tie_slots(want.scores, tol['scores'])) & \
            (got.valid | want.valid)
    both = got.valid & want.valid & ~diff & ~skip
    names = ['scores', 'boxes', 'masks'] + (
        ['mask_scores'] if got.mask_scores is not None else [])
    errs = {name: float((getattr(got, name) - getattr(want, name))[both]
                        .abs().max()) if bool(both.any()) else 0.0
            for name in names}
    print(f'{tag}: valid={int(got.valid.sum())} valid_or_class_diffs={n_diff} '
          + ' '.join(f'{n}_err={e!r}' for n, e in errs.items()))
    if ties_ok and bool(skip.any()):
        either = got.valid | want.valid
        seq = float((got.scores - want.scores)[either].abs().max())
        print(f'{tag}: {int(skip.sum())} detections in near ties (score gap '
              f'<= {tol["scores"]!r}), {int((diff & ~skip).sum())} differing '
              f'outside them; score sequences differ by {seq!r}')
        check(seq <= tol['scores'], f'{tag}: score sequences differ')
    if exact:
        check(not bool((diff & ~skip).any()),
              f'{tag}: valid sets or classes differ')
    check(all(e <= tol[n] for n, e in errs.items()),
          f'{tag}: the two paths differ beyond tolerance')
    return n_diff


def match(tag, got, want, tol=2e-2, least=0.75):
    """Two different computations of the same detections in bf16 (the 7x7
    stem by cuDNN and the s2d stem kernel): their roundings pass through the
    bf16 trunk, move scores by up to ~1e-2 and reorder near ties, so
    detections are matched as sets.  At least `least` of the valid
    detections of each side must have one on the other of the same image
    and class, with score and box coordinates within `tol` (a wrong layout
    or weight matches next to none; the f32 comparison holds precision).
    Prints the shares at other tolerances too."""
    def rate(a, b, t):
        ok = ((a.classes[:, :, None] == b.classes[:, None, :])
              & a.valid[:, :, None] & b.valid[:, None, :]
              & ((a.scores[:, :, None] - b.scores[:, None, :]).abs() <= t)
              & ((a.boxes[:, :, None] - b.boxes[:, None, :]).abs()
                 .amax(-1) <= t))
        return float(ok.any(dim=2).sum()) / max(1, int(a.valid.sum()))
    rates = {t: (rate(got, want, t), rate(want, got, t))
             for t in (5e-3, tol, 5e-2)}
    print(f'{tag}: valid {int(got.valid.sum())} / {int(want.valid.sum())}, '
          'matched as sets: ' + ', '.join(
              f'{r[0]!r} / {r[1]!r} within {t!r}' for t, r in rates.items()))
    check(min(rates[tol]) >= least, f'{tag}: detections do not match')


def main_path(name, sd, frames8, dev):
    """One path: both conf cells through Pipeline with kernels and with
    the plain versions.  Returns (launch counts of the kernel-path runs,
    the kernel-path outputs, the sparse bf16 kernel pipeline)."""
    cfg = path_config(name)
    path = PATHS[name]
    # cuDNN may sum the stem's products in another order than the float32
    # kernel: near ties may swap
    ties_ok = cfg.stem_s2d
    runs = [('b1 bf16', 'bfloat16', 1), ('b8 bf16', 'bfloat16', 8),
            ('b1 f32', 'float32', 1)]
    weights = [(wname, shape_conf(sd, cfg.num_classes, scale, bias), branch)
               for wname, scale, bias, branch in path['cells']]

    plain = {}
    reset_launches()
    for wname, wsd, _ in weights:
        for rname, dtype, batch in runs:
            pipe = make_pipeline(name, wsd, dev, dtype, use_kernels=False)
            plain[wname, rname] = pipe(frames8[:batch])
            del pipe
    torch.cuda.synchronize()
    check(not any(read_launches(KERNELS).values()),
          f'{name}: the plain path launched a kernel')

    kernel_pipes, kernel_out, branches = {}, {}, {}
    for wname, wsd, _ in weights:
        for dtype in ('bfloat16', 'float32'):
            kernel_pipes[wname, dtype] = make_pipeline(name, wsd, dev, dtype)
            check(kernel_pipes[wname, dtype].model.backbone.stem_s2d ==
                  cfg.stem_s2d, f'{name}: the stem is not the expected one')
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
            if dtype == 'bfloat16' and cfg.stem_s2d:
                # the tensor-core stem puts about 1 in 10^4 outputs one bf16
                # ulp from its plain version, and the bf16 trunk carries
                # that on: matched as sets, as the two stems are below
                match(tag, kernel_out[wname, rname], plain[wname, rname])
                continue
            n = compare(tag, kernel_out[wname, rname], plain[wname, rname],
                        exact=dtype == 'float32', ties_ok=ties_ok)
            if dtype == 'bfloat16':
                bf16_diffs += n
    check(bool(kernel_out['sparse', 'b8 bf16'].valid.any()),
          f'{name}: the sparse conf head gave no detections')
    print(f'{name} bf16 valid/class differences kernel vs plain: '
          f'{bf16_diffs}')
    return launches, kernel_out, kernel_pipes['sparse', 'bfloat16']


def path_config(name):
    """The config a path's model runs: Pipeline's choice of stem for raw
    frames, or the plain stem."""
    cfg = get_config(PATHS[name]['config'])
    return cfg if PATHS[name].get('plain_stem') else maybe_enable_stem_s2d(cfg)


class PlainStemPipeline:
    """yolact_base through the plain 7x7/s2 stem: load_model and
    forward_and_detect, the Pipeline's parts without its choice of the s2d
    stem for raw frames."""

    def __init__(self, cfg, state_dict, device, compute_dtype,
                 use_kernels=True):
        self.cfg = cfg
        self.model = load_model(cfg, state_dict, device, compute_dtype)
        self.device = device
        self.use_kernels = use_kernels

    def __call__(self, images):
        with torch.inference_mode():
            return forward_and_detect(self.cfg, self.model,
                                      torch.as_tensor(images,
                                                      device=self.device),
                                      use_kernels=self.use_kernels)


def make_pipeline(name, state_dict, device, compute_dtype, use_kernels=True):
    if PATHS[name].get('plain_stem'):
        return PlainStemPipeline(path_config(name), state_dict, device,
                                 compute_dtype, use_kernels)
    return Pipeline(get_config(PATHS[name]['config']), state_dict, device,
                    compute_dtype, use_kernels=use_kernels)


class SyntheticEvalSet:
    """`n` seeded BGR frames of `size` x `size` pixels, each with 1-3
    objects of random foreground classes (elliptic masks inside their
    boxes), in the COCODetection item contract that evaluate_dataset reads:
    pull_item -> (frame normalized as BaseTransform does for a ResNet config
    at max_size == size, gt [k, 5] relative boxes and 0-based labels, masks
    [k, size, size], h, w, 0 crowds)."""

    def __init__(self, n, size, num_classes, seed=0):
        rng = np.random.RandomState(seed)
        self.ids = list(range(1, n + 1))
        self.items = []
        yy, xx = np.mgrid[:size, :size] + 0.5
        for _ in range(n):
            raw = rng.randint(0, 256, (size, size, 3)).astype(np.float32)
            k = rng.randint(1, 4)
            xy1 = rng.randint(0, size // 2, (k, 2))
            xy2 = xy1 + rng.randint(size // 8, size // 2, (k, 2))
            cx, cy = (xy1 + xy2).T / 2
            rx, ry = (xy2 - xy1).T / 2
            masks = ((((xx[None] - cx[:, None, None]) / rx[:, None, None]) ** 2
                      + ((yy[None] - cy[:, None, None]) / ry[:, None, None])
                      ** 2) <= 1).astype(np.float32)
            labels = rng.randint(0, num_classes - 1, k)
            gt = np.hstack([np.hstack([xy1, xy2]) / size, labels[:, None]])
            img = ((raw - np.float32(MEANS)) / np.float32(STD))[..., ::-1]
            self.items.append((np.ascontiguousarray(img, np.float32), gt,
                               masks, size, size, 0))

    def __len__(self):
        return len(self.items)

    def pull_item(self, index):
        return self.items[index]


def eval_phase(sd, dev, card):
    """evaluate_dataset on EVAL_FRAMES in-memory frames, yolact_base sparse
    cell, b8 in the config's dtype: fast NMS with the s2d stem (kernels,
    then plain versions), and traditional NMS with the s2d stem.  Returns
    the steady frames/s of each run (the loop's own average, which skips
    the first two frames, as the reference does)."""
    cfg = get_config('yolact_base').copy(stem_s2d=True)
    data = SyntheticEvalSet(EVAL_FRAMES, cfg.max_size, cfg.num_classes,
                            seed=5)
    wsd = shape_conf(sd, cfg.num_classes, 3.0, 7.0)
    # (tag, fast NMS, kernels, kernels that must run / must not)
    runs = (('fast_nms s2d', True, True, ('stem_s2d', 'fast_nms_iou_max',
                                           'mask_assembly'), ('dcn',)),
            ('fast_nms s2d plain', True, False, (), tuple(KERNELS)),
            ('traditional s2d', False, True, ('stem_s2d',),
             ('fast_nms_iou_max', 'mask_assembly', 'dcn')))
    maps, rates = {}, {}
    for tag, fast, kernels, must, must_not in runs:
        reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            maps[tag] = evaluate_dataset(cfg, wsd, data, dev,
                                         eval_batch_size=8, fast_nms=fast,
                                         use_kernels=kernels)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches(KERNELS)
        out = buf.getvalue()
        rates[tag] = float(re.findall(r'([0-9.]+) fps', out)[-1])
        size = f'{cfg.max_size}x{cfg.max_size}'
        print(f'eval {tag}: {EVAL_FRAMES} frames of {size}, b8: '
              f'{rates[tag]!r} frames/s steady, {secs!r} s in all (pipeline '
              f'build and first batch included); launches '
              f'{json.dumps(launches)} [{card}]')
        print(out.split('\r')[-1].split('\n', 1)[-1].rstrip())
        check(maps[tag] is not None and set(maps[tag]) == {'box', 'mask'},
              f'eval {tag}: no mAP table')
        check(all(np.isfinite(v) for t in maps[tag].values()
                  for v in t.values()), f'eval {tag}: non-finite mAP')
        for kname in must:
            check(launches[kname] > 0, f'eval {tag}: {kname} not launched')
        for kname in must_not:
            check(launches[kname] == 0, f'eval {tag}: {kname} launched')
    check(maps['fast_nms s2d'] == maps['fast_nms s2d plain'],
          'eval: the kernels and their plain versions give other mAPs')
    return rates


def bound(nbytes, ops, ops_per_s):
    """The least time in ms the card could take: the larger of `nbytes`
    over the memory rate and `ops` over `ops_per_s`, with which of the two
    bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def profile_kernels(fn, calls=20, warmup=3):
    """torch.profiler kernel events over `calls` calls: (device busy ms per
    call, idle share of the span from the first kernel's start to the last
    one's end, {kernel name: ms per call}), or None when the profiler
    recorded no kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    by_name = collections.Counter()
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / calls
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events)) / 1e3 / calls
    return busy, 1 - busy / span, dict(by_name)


def device_times(fn, symbol=None):
    """Device ms per call of `fn` by torch.profiler kernel events over 20
    calls: (all its kernels, those whose name holds `symbol`).  Launched
    back to back, a short kernel's calls can outrun CUDA events' view of
    the device (the host is slower than the kernel), so the kernel's own
    events are its time.  Where the profiler records nothing, both are the
    CUDA-event time of device_ms, and say so."""
    prof = profile_kernels(fn)
    if prof is None:
        t = device_ms(fn)
        print('profiler recorded no kernel: CUDA-event time instead')
        return t, t
    return prof[0], sum(v for k, v in prof[2].items()
                        if symbol is not None and symbol in k)


def kernel_names(fn):
    """The names of the kernels the calls of `fn` launch."""
    prof = profile_kernels(fn)
    return sorted(prof[2]) if prof else ['not measured']


def stem_timing(dev, card):
    """The stem kernel's device time against its plain version, cuDNN's
    bf16 4x4 conv of the same function (one call: padding 2, the extra
    last row and column not read) and cuDNN's 7x7/s2 conv on the 3-channel
    image it replaces, bf16, with the kernel's bound; b8 and b1."""
    gen = torch.Generator().manual_seed(6)
    out = {}
    for batch in (8, 1):
        x = torch.randn(batch, 12, 275, 275, generator=gen).to(dev).bfloat16()
        w2 = (torch.randn(64, 12, 4, 4, generator=gen) * 0.1).to(dev)\
            .bfloat16()
        x3 = torch.randn(batch, 3, 550, 550, generator=gen).to(dev).bfloat16()
        w7 = (torch.randn(64, 3, 7, 7, generator=gen) * 0.1).to(dev)\
            .bfloat16()
        fns = {'plain': lambda: stem.stem_conv_s2d_plain(x, w2),
               'kernel': lambda: stem.stem_conv_s2d(x, w2),
               'cudnn_4x4': lambda: F.conv2d(x, w2, padding=2)[..., :275,
                                                                :275],
               'cudnn_7x7': lambda: F.conv2d(x3, w7, stride=2, padding=3)}
        dev_ms = {k: device_times(fn)[0] for k, fn in fns.items()}
        dev_ms['kernel'] = device_times(fns['kernel'],
                                        'stem_s2d_mma_kernel')[1]
        call = {k: time_ms(fns[k]) for k in ('plain', 'kernel')}
        y = fns['kernel']()
        b_ms, b_by = bound(nbytes(x, w2, y), 2 * y.numel() * 12 * 16,
                           BF16_TENSOR_OPS_PER_S)
        print(f'stem b{batch} bf16 x[{batch},12,275,275] -> '
              f'[{batch},64,275,275]: device ms per call (torch.profiler '
              f'kernel events, 20 calls) kernel {dev_ms["kernel"]!r} (bound {b_ms!r} by '
              f'{b_by}: {b_ms / dev_ms["kernel"]!r} of it), plain (float32 '
              f'conv, rounded) {dev_ms["plain"]!r}, cuDNN bf16 4x4 '
              f'{dev_ms["cudnn_4x4"]!r}, cuDNN bf16 7x7/s2 on '
              f'[{batch},3,550,550] {dev_ms["cudnn_7x7"]!r}; call median '
              f'(p90) ms kernel {call["kernel"][0]!r} ({call["kernel"][1]!r}), '
              f'plain {call["plain"][0]!r} ({call["plain"][1]!r}) [{card}]')
        out[batch] = dict(dev_ms, bound=(b_ms, b_by))
    return out


def dcn_timing(dev, card, plus_pipe, frames8):
    """yolact_plus_base's 11 DCN blocks at b8 bf16, each at its shape
    (device time of all the call's kernels, torch.profiler kernel events
    over 20 calls): the sampling kernel on a channels_last x and on an
    NCHW one (the wrapper's NHWC copy), the GEMM
    on its columns against the GEMM in the per-image [Cin*9, Ho*Wo]
    layout and a cuDNN 3x3 conv of the same shape, and the block's tail
    (BN, ReLU, the 1x1 conv) on the GEMM's channels_last output against an
    NCHW copy of it.  Prints the sums per batch and the GEMM kernels'
    names; returns the layers.2 blocks 3-21 times and bound for the kernels
    line."""
    formats = []
    hooks = [m.register_forward_pre_hook(
        lambda _, args: formats.append(
            args[0].is_contiguous(memory_format=torch.channels_last)))
             for m in plus_pipe.model.modules() if isinstance(m, DCNLayer)]
    plus_pipe(frames8)
    for h in hooks:
        h.remove()
    print(f'yolact_plus_base b8: {sum(formats)} of {len(formats)} DCN blocks '
          f'take a channels_last x (the rest pay the wrapper\'s NHWC copy)')
    gen = torch.Generator().manual_seed(7)
    per_batch = collections.Counter()
    line = {}
    for name, count, cin, h, stride in DCN_SHAPES:
        x, offset, mask = dcn_inputs(gen, dev, 8, cin, h, stride,
                                     torch.bfloat16, finite=True)
        x_cl = x.contiguous(memory_format=torch.channels_last)
        ho = offset.shape[-1]
        w = (torch.randn(cin, cin, 3, 3, generator=gen) * 0.02).to(dev)\
            .bfloat16()
        w_t = w.permute(0, 2, 3, 1).reshape(cin, -1).t()
        cols = dcn.dcn_columns(x_cl, offset, mask, 3, stride)
        w_per_image = w.reshape(cin, -1)
        cols_per_image = cols.view(8, ho * ho, -1).transpose(1, 2).contiguous()
        y = torch.matmul(cols, w_t).view(8, ho, ho, cin).permute(0, 3, 1, 2)
        w3 = (torch.randn(4 * cin, cin, 1, 1, generator=gen) * 0.05).to(dev)\
            .bfloat16()
        bn = [torch.rand(cin, generator=gen).to(dev) + 0.5 for _ in range(4)]

        def tail(t):
            t = F.batch_norm(t, bn[0], bn[1], bn[2], bn[3], False, 0.0, 1e-5)
            return F.conv2d(F.relu(t), w3)

        fns = {'sampling': lambda: dcn.dcn_columns(x_cl, offset, mask, 3,
                                                   stride),
               'sampling_nchw_x': lambda: dcn.dcn_columns(x, offset, mask, 3,
                                                          stride),
               'gemm': lambda: torch.matmul(cols, w_t),
               'gemm_per_image_cols': lambda: torch.matmul(w_per_image, cols_per_image),
               'cudnn_3x3': lambda: F.conv2d(x, w, stride=stride, padding=1),
               'tail_channels_last': lambda: tail(y),
               'tail_nchw_copy': lambda: tail(y.contiguous())}
        ms = {k: device_times(fn)[0] for k, fn in fns.items()}
        for k, v in ms.items():
            per_batch[k] += count * v
        b_ms, b_by = bound(nbytes(x, offset, mask, cols), 8 * cols.numel(),
                           FP32_OPS_PER_S)
        per_batch['bound'] += count * b_ms
        print(f'dcn {name} b8 bf16 x[8,{cin},{h},{h}] cols'
              f'{list(cols.shape)} (x{count} per batch): device ms '
              + ', '.join(f'{k} {v!r}' for k, v in ms.items())
              + f'; sampling bound {b_ms!r} by {b_by} ({b_ms / ms["sampling"]!r}'
              f' of it) [{card}]')
        if count == 7:
            kern_ms = device_times(fns['sampling'], 'dcn_im2col_kernel')[1]
            plain_ms = device_times(lambda: dcn.dcn_columns_plain(
                x_cl, offset, mask, 3, stride))[0]
            print(f'dcn {name}: kernel {kern_ms!r} ms, plain {plain_ms!r} '
                  f'ms (torch.profiler kernel events, 20 calls) [{card}]')
            line = dict(ms=kern_ms, plain_ms=plain_ms,
                        bound=(b_ms, b_by),
                        shape=f'{name} x[8,{cin},{h},{h}] bf16 -> cols'
                              f'{list(cols.shape)}')
            for k in ('gemm', 'gemm_per_image_cols', 'cudnn_3x3'):
                print(f'dcn {name}: {k} kernels {kernel_names(fns[k])}')
        del x, x_cl, offset, mask, cols, cols_per_image, y
    print('dcn per yolact_plus_base b8 batch (11 blocks), device ms: '
          + ', '.join(f'{k} {v!r}' for k, v in per_batch.items())
          + f' [{card}]')
    return line


def small_kernel_bounds(margs, boxes):
    """The bounds of the IoU-max and mask-assembly kernels on these inputs:
    {name: (ms, 'bytes' or 'operations')}."""
    n, k = boxes.shape[:2]
    b, d, md = margs[1].shape
    masks_out = b * d * margs[0].shape[1] * margs[0].shape[2]
    return {
        # 13 float32 operations per IoU pair: 4 min/max, 2 subtractions and
        # 2 clamps and a product for the intersection, 2 for the union, the
        # divide, the running max (the per-box areas are O(k))
        'fast_nms_iou_max': bound(nbytes(boxes) + n * k * 4,
                                  13 * n * k * (k - 1) // 2, FP32_OPS_PER_S),
        # the Md-term dot product (2 Md operations) and the sigmoid (3)
        'mask_assembly': bound(nbytes(*margs) + masks_out * 4,
                               masks_out * (2 * md + 3), FP32_OPS_PER_S),
    }


def small_kernel_timing(dev, card):
    """The IoU-max and mask-assembly kernels at the b8 and b1 main-path
    shapes: device and call time against their plain versions, with their
    bounds.  Returns the b8 numbers."""
    gen = torch.Generator().manual_seed(1)
    out = {}
    for batch in (8, 1):
        margs = mask_inputs(gen, dev, batch, 100)
        boxes = iou_inputs(gen, dev, batch * 80, 200)
        bounds = small_kernel_bounds(margs, boxes)
        timed = {
            'fast_nms_iou_max': (
                lambda: nms.nms_iou_max(boxes),
                lambda: nms.nms_iou_max_plain(boxes),
                'fast_nms_iou_max_kernel', f'[{batch * 80},200,4]'),
            'mask_assembly': (
                lambda: mask_assembly.assemble_masks(*margs),
                lambda: mask_assembly.assemble_masks_plain(*margs),
                'mask_assembly_kernel', f'B={batch} D=100 138x138 Md=32'),
        }
        for name, (kern, plain, symbol, shape) in timed.items():
            b_ms, b_by = bounds[name]
            dev_ms = device_times(kern, symbol)[1]
            plain_dev = device_times(plain)[0]
            plain_call, plain_p90 = time_ms(plain)
            call, p90 = time_ms(kern)
            print(f'kernel {name} b{batch} {shape}: device {dev_ms!r} ms '
                  f'(bound {b_ms!r} by {b_by}: {b_ms / dev_ms!r} of it), '
                  f'plain device {plain_dev!r} ms (torch.profiler kernel '
                  f'events, 20 calls); call median {call!r} ms (p90 '
                  f'{p90!r}), plain {plain_call!r} ms (p90 {plain_p90!r}) '
                  f'({RUNS} calls each; call time: wrapper, launch and '
                  f'device) [{card}]')
            if batch == 8:
                out[name] = dict(ms=dev_ms, plain_ms=plain_dev,
                                 bound=(b_ms, b_by))
        del margs, boxes
    return out


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
    pipes, launches, outs, sds = {}, {}, {}, {}
    for name in PATHS:
        config = PATHS[name]['config']
        if config not in sds:
            t0 = time.perf_counter()
            sd = random_state_dict(get_config(config),
                                   torch.Generator().manual_seed(0))
            sds[config] = seed_offsets_state_dict(
                sd, torch.Generator().manual_seed(3))
            print(f'{config} weights: {time.perf_counter() - t0:.2f} s')
        launches[name], outs[name], pipes[name] = main_path(
            name, sds[config], frames8, dev)
    # the s2d stem against the plain stem, same weights and frames
    for cell in ('dense', 'sparse'):
        s2d, plain = (outs[name][cell, 'b1 f32']
                      for name in ('yolact_base_s2d', 'yolact_base'))
        compare(f's2d vs plain stem {cell} b1 f32', s2d, plain, exact=True,
                ties_ok=True)
        s2d, plain = (outs[name][cell, 'b8 bf16']
                      for name in ('yolact_base_s2d', 'yolact_base'))
        match(f's2d vs plain stem {cell} b8 bf16', s2d, plain)
    del outs

    # ---- phase 5: eval ----
    eval_rates = eval_phase(sds['yolact_base'], dev, card)
    del sds

    # ---- phase 6: timing; the s2d A/B in the order plain, s2d, s2d, plain
    order = ('yolact_base', 'yolact_base_s2d', 'yolact_base_s2d',
             'yolact_base', 'yolact_plus_base')
    for batch in (1, 8):
        x = frames8[:batch]
        for name in order:
            ms, p90 = time_ms(lambda: pipes[name](x))
            print(f'e2e {name} 550 bf16 b{batch}: median {ms!r} ms/batch '
                  f'({batch * 1000.0 / ms!r} frames/s), p90 {p90!r} ms '
                  f'({RUNS} calls, CUDA events) [{card}]')
    for batch in (8, 1):
        x = frames8[:batch]
        busy = collections.defaultdict(list)
        for name in order:
            prof = profile_kernels(lambda: pipes[name](x))
            if prof is None:
                print(f'device {name} b{batch}: not measured (the profiler '
                      f'recorded no kernel)')
                continue
            busy[name].append(prof[0])
            top = sorted(prof[2].items(), key=lambda kv: -kv[1])[:6]
            print(f'device {name} 550 bf16 b{batch}: busy {prof[0]!r} ms per '
                  f'batch, idle share {prof[1]!r} (torch.profiler kernel '
                  f'events, 20 batches) [{card}]; top kernels ms per batch: '
                  + '; '.join(f'{n[:60]} {t!r}' for n, t in top))
            if name == 'yolact_plus_base':
                gemm = {n: t for n, t in prof[2].items()
                        if ('gemm' in n or 'nvjet' in n)
                        and not any(c in n for c in ('fprop', 'conv',
                                                     'implicit'))}
                print(f'yolact_plus_base b{batch} per batch: DCN sampling '
                      f'{sum(t for n, t in prof[2].items() if "dcn_im2col" in n)!r}'
                      f' ms; GEMM kernels (not convs) ' + json.dumps(gemm))
        if len(busy['yolact_base']) == 2 and len(busy['yolact_base_s2d']) == 2:
            plain_ms = statistics.mean(busy['yolact_base'])
            s2d_ms = statistics.mean(busy['yolact_base_s2d'])
            print(f's2d A/B b{batch} device busy per batch: plain stem '
                  f'{busy["yolact_base"]} (mean {plain_ms!r}), s2d '
                  f'{busy["yolact_base_s2d"]} (mean {s2d_ms!r}); s2d - plain '
                  f'{s2d_ms - plain_ms!r} ms [{card}]')
    dcn_line = dcn_timing(dev, card, pipes['yolact_plus_base'], frames8)
    del pipes
    stem_ms = stem_timing(dev, card)[8]
    lines = dict(small_kernel_timing(dev, card), dcn=dcn_line,
                 stem_s2d=dict(ms=stem_ms['kernel'], plain_ms=stem_ms['plain'],
                               bound=stem_ms['bound'],
                               library_ms=stem_ms['cudnn_4x4']))
    report = []
    for name, info in KERNELS.items():
        t = lines[name]
        report.append({'name': name, 'route': 'cuda', 'source': info['source'],
                       'replaces': info['replaces'],
                       'launches': launches[info['path']][name],
                       'max_abs_err': errs[name], 'ms': t['ms'],
                       'plain_ms': t['plain_ms'], 'bound_ms': t['bound'][0],
                       'bound_by': t['bound'][1],
                       'library_ms': t.get('library_ms')})
    print(f'eval frames/s: {json.dumps(eval_rates)}')

    print(json.dumps({'kernels': report}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
