"""The readings the correctness limits are set from (not run by the
benchmark's own runs).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out readings.jsonl]

For each seed of ``--seeds``: the cell's set-up from that seed and what
its timed entry produces held against the reference, as a run's check
does (the program's readings: the lower ends of the limits).  For each
seed of ``--control-seeds``: the control, the reference itself put in the
program's place one precision below the configuration's bfloat16 (fp8
operands), judged the same way (the upper ends), beside it the reference
in bfloat16, the program's own precision, and for a training cell the
program with each fault of ``modes/train.py:FAULTS`` planted.  Each mode
gives its readings (``modes/<mode>.py:calibrate``).  One JSON line a
reading, and each number's least and largest reading by side at the
end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from benchmark import cells


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('calibrate: no CUDA device', file=sys.stderr)
        return 3
    cell = cells.load_cell(args.workload)
    mode = cells.load_mode(cell.mode)
    lines = []

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
            with open(args.out, 'a') as f:
                f.write(json.dumps(line) + '\n')

    seeds = [int(s) for s in args.seeds.split(',') if s]
    controls = [int(s) for s in args.control_seeds.split(',') if s]
    for seed in seeds + [s for s in controls if s not in seeds]:
        t = time.perf_counter()
        for side, numbers in mode.calibrate(cell, seed, seed in controls):
            if side == 'program' and seed not in seeds:
                continue
            emit(dict(cell=cell.name, side=side, seed=seed,
                      seconds=time.perf_counter() - t, **numbers))
        torch.cuda.empty_cache()
    names = sorted({k for line in lines for k, v in line.items()
                    if isinstance(v, float) and k != 'seconds'})
    sides = sorted({line['side'] for line in lines})
    for name in names:
        parts = []
        for side in sides:
            vals = [line[name] for line in lines
                    if line['side'] == side and name in line]
            if vals:
                parts.append(f'{side} min {min(vals)!r} max {max(vals)!r} '
                             f'(n {len(vals)})')
        print(f'{name}: ' + '; '.join(parts))
    return 0


if __name__ == '__main__':
    sys.exit(main())
