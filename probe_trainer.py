#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 8 (the trainer, host and device augment) and
8b (device augmentation and the packed transports) alone.

    python3 probe_trainer.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the kernels, makes the smoke script's seeded weights of
yolact_base and yolact_plus_base, then runs ``chip_smoke.trainer_phase``
(``cli/train.train`` on 24 in-memory frames: yolact_base f32 and bf16
with the s2d stem, yolact_plus_base bf16, and both bf16 models with
``--device_augment``; ms per iteration, loader wait, device busy and
idle, the step alone, host-to-device bytes a batch) and
``chip_smoke.device_augment_phase`` (the augmentation on the card against
the CPU under ``torch.cuda.set_sync_debug_mode('error')``, packed train
steps against unpacked ones).  It prints what those phases print and
exits 1 when a check fails.  It imports nothing of JAX or of the JAX
package.
"""

import json
import subprocess
import sys
import time

import torch

import chip_smoke as smoke
from yolact_tpu_torch.infer import random_state_dict
from yolact_tpu_torch.kernels import _build


def main():
    if not torch.cuda.is_available():
        print('probe_trainer: needs a CUDA device', file=sys.stderr)
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
    t0 = time.perf_counter()
    _, timing, per_step = smoke.trainer_phase(sds, dev, card)
    print(f'phase 8: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    smoke.device_augment_phase(sds, dev, card)
    print(f'phase 8b: {time.perf_counter() - t0:.1f} s')
    print(json.dumps({'launches_per_step': per_step}))


if __name__ == '__main__':
    main()
