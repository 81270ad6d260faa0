#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 10 (data parallelism) alone.

    python3 probe_dp.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the kernels, makes the smoke script's seeded weights of
yolact_base and yolact_plus_base and phase 4's float32 b1 output of
``Pipeline(yolact_base)`` (TF32 off), then runs ``chip_smoke.dp_phase``:
two gloo ranks sharing the card against the one-process b8 step (losses,
first gradients, bit-equal weights, launches, a NaN step, ms per step and
the collectives' share, a control with per-rank batch-norm moments),
``cli/train.py --distributed`` at world size 1 over NCCL, ``n_devices=0``
in ``evaluate_dataset``, and the float32 ``Pipeline`` under PyTorch's
default TF32 flags.  It prints what phase 10 prints (the trainer's time
without phase 8's beside it) and exits 1 when a check fails.  It imports
nothing of JAX or of the JAX package.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as smoke
from yolact_tpu_torch.infer import random_state_dict
from yolact_tpu_torch.kernels import _build


def main():
    if not torch.cuda.is_available():
        print('probe_dp: needs a CUDA device', file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda)
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load()
    print(f'build {time.perf_counter() - t0:.1f} s')
    sds = {}
    for config in ('yolact_base', 'yolact_plus_base'):
        sd = random_state_dict(smoke.config_named(config),
                               torch.Generator().manual_seed(0))
        sds[config] = smoke.seed_offsets_state_dict(
            sd, torch.Generator().manual_seed(3))
    frames8 = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (8, 550, 550, 3)).astype(np.float32)).to(dev)
    want = smoke.make_pipeline('yolact_base_s2d', smoke.shape_conf(
        sds['yolact_base'], 81, 3.0, 7.0), dev, 'float32')(frames8[:1])
    t0 = time.perf_counter()
    launches, _ = smoke.dp_phase(sds, frames8, dev, card, None, want)
    print(f'phase 10: {time.perf_counter() - t0:.1f} s')
    print(json.dumps({'dp_launches_per_rank_step': launches}))


if __name__ == '__main__':
    main()
