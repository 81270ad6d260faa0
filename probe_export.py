#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 11 (export) and 11b (deformable PSRoI
pooling) alone.

    python3 probe_export.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the kernels, makes the smoke script's seeded yolact_plus_base
weights (seeded DCN offset convs), then runs ``chip_smoke.export_phase``:
the b1 float32 and b8 bfloat16 artifacts exported on the card, loaded in a
fresh process that imports torch and the port only, held against
``Pipeline`` (outputs and each kernel's launches per call), the artifact's
and ``Pipeline``'s ms a batch, export, save and load seconds, and each
custom op's call against its bare ctypes launch; then
``chip_smoke.psroi_phase``.  It prints what those phases print and exits
1 when a check fails.  It imports nothing of JAX or of the JAX package.
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
        print('probe_export: needs a CUDA device', file=sys.stderr)
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
    sd = smoke.seed_offsets_state_dict(
        random_state_dict(smoke.config_named('yolact_plus_base'),
                          torch.Generator().manual_seed(0)),
        torch.Generator().manual_seed(3))
    frames8 = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (8, 550, 550, 3)).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    launches = smoke.export_phase(sd, frames8, dev, card)
    print(f'phase 11: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    smoke.psroi_phase(dev, card)
    print(f'phase 11b: {time.perf_counter() - t0:.1f} s')
    print(json.dumps({'export_launches': launches}))


if __name__ == '__main__':
    main()
