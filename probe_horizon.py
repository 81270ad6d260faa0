#!/usr/bin/env python3
"""chip_smoke.py's phase 4b registered configs (yolact_im400, yolact_im700,
yolact_resnet50, yolact_resnet50_pascal, yolact_plus_resnet50: inference
at b1 f32 and one b8 f32 train step, kernels against plain versions) and
phase 13 (the horizon tools: two segments of yolact_plus_resnet50_horizon
with --resume latest, --eval, map_ab, flops) alone, with the kernels built
first.

    python3 probe_horizon.py [--skip-a14] [--skip-horizon]

Run from the root of a checkout on a machine with a CUDA card; exits 1
without one.  It imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import sys
import time

import torch

import chip_smoke as cs
from yolact_tpu_torch.kernels import _build
from yolact_tpu_torch.utils.nvinfo import name_and_power_limit


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--skip-a14', action='store_true')
    ap.add_argument('--skip-horizon', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('probe_horizon: torch.cuda.is_available() is False',
              file=sys.stderr)
        sys.exit(1)
    card = name_and_power_limit()
    print(card)
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load()
    print(f'build: {time.perf_counter() - t0:.1f} s')
    out = {}
    if not args.skip_a14:
        t0 = time.perf_counter()
        out['a14_launches'] = cs.a14_phase(dev, card)
        print(f'phase 4b registered configs: {time.perf_counter() - t0:.1f} s')
    if not args.skip_horizon:
        t0 = time.perf_counter()
        out['horizon_launches_per_step'] = cs.horizon_phase(dev, card)
        print(f'phase 13 horizon tools: {time.perf_counter() - t0:.1f} s')
    print(json.dumps(out))


if __name__ == '__main__':
    main()
