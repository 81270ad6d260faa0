#!/usr/bin/env python3
"""The conf-head cells of chip_smoke.py's phase-4b and phase-9 paths and
of its video frames (``--paths video``: yolact_base on
``chip_smoke.video_frames``), of yolact_base's sparse cell, to compare,
and how far each path's detections move under stem noise of the kernels'
size.

    python3 probe_cells.py [--device cpu|cuda] [--paths NAME ...]

Run from the root of a checkout.  On seeded random weights no prior passes
conf_thresh, so chip_smoke.shape_conf scales the conf head and biases its
background logit ("cells"); this script shows the choice of each path's
cell, with chip_smoke's weights (seed 0) and b8 frames (seed 0) at 550 x
550:

- candidates: the priors per image whose best foreground score passes
  conf_thresh, for a grid of (scale, background bias) around the path's
  cell, in float32 and bfloat16 (the cell must keep every image at most
  nms_candidates, the pruned NMS tail, and above 0);
- sensitivity, for the paths with the s2d stem: in bfloat16 at b8, on
  the card the kernel pipeline's matched-set share (chip_smoke.match)
  against the plain one beside chip_smoke.match_calibration's readings on
  the same inputs (the plain pipeline with one bf16 ulp at the share of
  stem outputs where the kernel differs, and with the stem's taps
  mirrored, and the limit read from them), on the CPU the plain pipeline with one bf16 ulp
  at 1 in 10^4 stem outputs; in float32 at b1 the plain pipeline with
  Gaussian stem noise of 3.7e-7 (the float32 kernel's rms error in
  chip_smoke.py's phase 6 calibration) against itself, held to
  chip_smoke.compare.

On the CPU it runs the kernels' plain versions (bfloat16 convolutions on
the CPU are slow: a few minutes a path).  It imports nothing of JAX or of
the JAX package.
"""

import argparse
import json

import numpy as np
import torch

import chip_smoke as cs
from yolact_tpu_torch.infer import (Pipeline, load_model, preprocess_device,
                                    random_state_dict)
from yolact_tpu_torch.kernels import stem

GRID = {
    'yolact_base_s2d': ((3.0, (6.0, 7.0, 8.0)),),
    'yolact_darknet53': ((1.0, (7.75, 7.85, 7.9, 7.95, 8.0)),),
    'yolact_vgg16': ((1.0, (3.75, 4.0, 4.25)),),
    'yolact_base_gn': ((1.0, (11.5, 12.0, 12.5)), (0.5, (6.5, 7.0, 7.5))),
    'yolact_base_direct': ((3.0, (9.0, 9.25, 9.5, 9.75)),),
    'yolact_base_options': ((1.0, (3.5, 4.0, 4.5)),),
    # phase 9's video: yolact_base on chip_smoke.video_frames
    'video': ((3.0, (4.0, 5.0, 5.5, 6.0, 6.5, 7.0)),),
}


def candidates(cfg, sd, frames, dev, dtype, grid):
    """{(scale, bias): per-image candidate counts} over `grid`:
    the conf logits once, then each cell applied to them as shape_conf
    does to the head (scale the logits, add the bias to the background)."""
    model = load_model(cfg, sd, dev, dtype)
    with torch.inference_mode():
        conf = torch.cat([model(preprocess_device(cfg, frames[i:i + 2]))
                          ['conf'].float() for i in range(0, 8, 2)])
    out = {}
    for scale, biases in grid:
        for bias in biases:
            logits = conf * scale
            logits[..., 0] += bias
            best = torch.softmax(logits, -1)[..., 1:].max(-1).values
            out[scale, bias] = (best > cfg.nms_conf_thresh).sum(1).tolist()
    return out


def gaussian_noise(out, sigma=3.7e-7, seed=1):
    g = torch.Generator(device=out.device).manual_seed(seed)
    return out + torch.randn(out.shape, generator=g, device=out.device) \
        * sigma


def sensitivity(cfg, name, sd, frames, dev, cell):
    """The plain pipeline against itself with its stem output moved, in
    bf16 at b8 and f32 at b1, and on the card the kernel pipeline against
    the plain one beside it (see the module docstring)."""
    wsd = cs.shape_conf(sd, cfg.num_classes, *cell)
    lines = {}
    want = Pipeline(cfg, wsd, dev, 'bfloat16', use_kernels=False)(frames)
    tag = f'{cfg.name} {cell} bfloat16 b8'
    try:
        if dev.type == 'cuda':
            got = Pipeline(cfg, wsd, dev, 'bfloat16')(frames)
            kernel = cs.match(tag + ' kernel', got, want, least=0.0)
            lines['bfloat16'] = (f'kernel share {kernel!r}, calibrated limit '
                                 + repr(cs.match_calibration(
                                     tag, name, wsd, frames, dev, want)))
        else:
            with cs.plain_stem_as(cs.ulp_noise(1e-4)):
                noisy = Pipeline(cfg, wsd, dev, 'bfloat16',
                                 use_kernels=False)(frames)
            lines['bfloat16'] = repr(cs.match(tag + ' stem noise', noisy,
                                              want, least=0.0))
    except RuntimeError as e:
        lines['bfloat16'] = str(e)
    pipe = Pipeline(cfg, wsd, dev, 'float32', use_kernels=False)
    want = pipe(frames[:1])
    plain = stem.stem_conv_s2d_plain
    with cs.plain_stem_as(lambda x, w: gaussian_noise(plain(x, w))):
        got = pipe(frames[:1])
    try:
        cs.compare(f'{cfg.name} {cell} float32 b1 stem noise', got, want,
                   exact=True, ties_ok=True)
        lines['float32'] = 'within chip_smoke\'s criteria'
    except RuntimeError as e:
        lines['float32'] = str(e)
    return lines


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--device', default='cuda')
    p.add_argument('--paths', nargs='+', default=list(GRID))
    args = p.parse_args()
    dev = torch.device(args.device)
    if dev.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(torch.cuda.get_device_name(0))
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (8, 550, 550, 3)).astype(np.float32)).to(dev)
    video = torch.from_numpy(cs.video_frames(8).astype(np.float32)).to(dev)
    for name in args.paths:
        cfg = cs.config_named('yolact_base' if name == 'video'
                              else cs.PATHS[name]['config'])
        sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
        for dtype in ('float32', 'bfloat16'):
            for cell, n in candidates(cfg, sd,
                                      video if name == 'video' else frames,
                                      dev, dtype, GRID[name]).items():
                print(f'{name} {dtype} cell {cell}: candidates per image '
                      f'{min(n)}-{max(n)} {json.dumps(n)}')
        if name == 'video':
            continue
        path = cs.PATHS[name]
        if not path.get('plain_stem') and cs.path_config(name).stem_s2d:
            for scale, biases in GRID[name]:
                cell = (scale, biases[len(biases) // 2])
                print(f'{name} cell {cell}: ' + json.dumps(
                    sensitivity(cfg, name, sd, frames, dev, cell)))


if __name__ == '__main__':
    main()
