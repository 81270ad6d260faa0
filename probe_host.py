#!/usr/bin/env python3
"""Host time of the port's inference calls, for one tree or for two.

    python3 probe_host.py [--parent DIR] [--calls 200] [--rounds 3]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Inference at b1 waits for the host, not the card, so what a wrapper adds on
the host (an ``autograd.Function``, a device guard, a check) shows in the
wall time of ``Pipeline.__call__`` while the device time does not move.
Each tree is measured in a process of its own, started in that tree's root
so that it imports that tree's package and builds that tree's kernels.  With
``--parent`` (a checkout of an earlier commit, e.g. ``git archive`` of it
unpacked under ``build/``) the order per round is parent, this tree, this
tree, parent.  Per process, with seeded random weights (the smoke script's
sparse conf cell, DCN offset convs seeded non-zero), bf16, 550 x 550:

- ``Pipeline(yolact_plus_base)`` and ``Pipeline(yolact_base)`` at b8 and b1:
  median and 10th percentile of the wall ms per call (time.perf_counter
  around the call, which ends in its own host read), frames on the card;
- the DCN wrapper alone: host microseconds per ``dcn_columns`` call on a
  small input under ``inference_mode``, 2000 calls without a sync (the
  kernel is shorter than the call, so the launch queue stays empty).

It imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def worker(calls):
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    import chip_smoke as cs
    from yolact_tpu_torch.infer import random_state_dict
    from yolact_tpu_torch.kernels import _build, dcn

    dev = torch.device('cuda', 0)
    _build.load()
    out = {}
    rng = np.random.RandomState(0)
    frames8 = torch.from_numpy(rng.randint(0, 256, (8, 550, 550, 3))
                               .astype(np.float32)).to(dev)
    for name in ('yolact_plus_base', 'yolact_base_s2d'):
        cfg = cs.get_config(cs.PATHS[name]['config'])
        sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
        if cfg.use_maskiou:
            sd = cs.seed_offsets_state_dict(
                sd, torch.Generator().manual_seed(1))
        _, scale, bias, _ = cs.PATHS[name]['cells'][1]
        pipe = cs.make_pipeline(
            name, cs.shape_conf(sd, cfg.num_classes, scale, bias), dev,
            'bfloat16')
        for frames in (frames8, frames8[:1]):
            for _ in range(10):
                pipe(frames)
            torch.cuda.synchronize()
            times = []
            for _ in range(calls):
                t0 = time.perf_counter()
                pipe(frames)
                times.append((time.perf_counter() - t0) * 1e3)
            times.sort()
            out[f'{name} b{frames.shape[0]} ms'] = (
                statistics.median(times), times[len(times) // 10])
        del pipe
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, 8, 8, 8, generator=gen).to(dev, torch.bfloat16)
    offset = torch.randn(1, 18, 8, 8, generator=gen).to(dev)
    mask = torch.rand(1, 9, 8, 8, generator=gen).to(dev, torch.bfloat16)
    with torch.inference_mode():
        for _ in range(100):
            dcn.dcn_columns(x, offset, mask, 3, 1)
        torch.cuda.synchronize()
        n = 2000
        t0 = time.perf_counter()
        for _ in range(n):
            dcn.dcn_columns(x, offset, mask, 3, 1)
        host = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    out['dcn_columns host us per call'] = (host, host)
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', help='checkout of an earlier commit')
    ap.add_argument('--calls', type=int, default=200)
    ap.add_argument('--rounds', type=int, default=3)
    ap.add_argument('--worker', action='store_true', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.calls)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {'this tree': here}
    order = ['this tree']
    if args.parent:
        trees['parent'] = os.path.abspath(args.parent)
        order = ['parent', 'this tree', 'this tree', 'parent']
    runs = {tree: [] for tree in trees}
    for r in range(args.rounds):
        for tree in order:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--worker',
                 '--calls', str(args.calls)], cwd=trees[tree],
                capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                sys.exit(f'{tree}: worker failed\n{res.stdout}{res.stderr}')
            got = json.loads(res.stdout.strip().splitlines()[-1])
            runs[tree].append(got)
            print(f'round {r} {tree}: ' + '; '.join(
                f'{k} median {v[0]!r} p10 {v[1]!r}' for k, v in got.items()),
                flush=True)
    for key in runs['this tree'][0]:
        for tree, rs in runs.items():
            meds = sorted(run[key][0] for run in rs)
            print(f'{key}, {tree}: median of {len(meds)} process medians '
                  f'{statistics.median(meds)!r}, range {meds[0]!r}-'
                  f'{meds[-1]!r} ({args.calls} calls each) [{card}]')


if __name__ == '__main__':
    main()
