"""One run of one benchmark cell of the PyTorch / CUDA port.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with CUDA cards.  One process:
set-up (weights and inputs made on the card from the seed, the program
built, every shape the cell uses warmed up), a measured window of
``--seconds``, then the check of what the window produced against the
frozen plain reference (``reference/``), once the program is freed.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics of
``BENCHMARK.json``, or with ``--trace 1`` its per-layer ones, read after
an untraced window and a profiled slice), ``device`` and, traced,
``breakdown``; ``compared`` comes last, each compared number beside its
limit, and the same lines end standard error.

Exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), on an unknown name, and when ``jax``,
``jaxlib``, ``flax`` or ``yolact_tpu`` is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()    # set-up is timed from here, torch's import in it

import argparse             # noqa: E402
import json                 # noqa: E402
import sys                  # noqa: E402

from benchmark import cells  # noqa: E402
from benchmark.record import Run  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'yolact_tpu')


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``yolact_tpu_torch`` is neither)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fail(msg: str, code: int) -> int:
    print(f'benchmark: {msg}', file=sys.stderr, flush=True)
    return code


def measure(cell, mode, readers, metrics, seed: int, seconds: float,
            trace: bool, chips: int, device=None):
    """Set-up, window, metrics and check of one run: the result's dict,
    or a message where an end-to-end metric has no reading.  `device`
    (default the first card) is for the tests, which drive a run on the
    CPU."""
    import torch
    on_card = device is None or torch.device(device).type == 'cuda'
    run = Run(cell=cell.name, mode=cell.mode, seed=seed, seconds=seconds,
              trace=trace, t0=T0)
    state = mode.setup(cell, seed, run, device)
    run.setup_s = time.perf_counter() - T0
    mode.window(state, run)
    if trace:
        mode.traced_slice(state, run)
    if on_card:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    values = {}
    for m in metrics:
        value = readers[m['name']](run)
        if value is not None:
            values[m['name']] = {'value': value, 'unit': m['unit']}
    if on_card and not trace:
        missing = [m['name'] for m in metrics if m['name'] not in values]
        if missing:
            return f'end-to-end metrics with no reading: {missing}'

    correct, compared = mode.check(state, run)
    device = {'platform': 'gpu' if on_card else 'cpu',
              'kind': torch.cuda.get_device_name(0) if on_card else 'cpu',
              'count': chips, 'memory_peak_bytes': run.memory_peak_bytes}
    result = {'correct': correct, 'attempted': run.attempted,
              'failed': run.failed, 'metrics': values, 'device': device}
    if trace and run.device_trace is not None:
        device['busy_s'] = run.device_trace.busy_s
        device['window_s'] = run.device_trace.window_s
        result['breakdown'] = run.device_trace.breakdown()
    result['compared'] = {name: {'value': v, 'limit': lim}
                          for name, v, lim in compared}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    bench = cells.benchmark_json()
    try:
        cell = cells.load_cell(args.workload)
        entry = next((w for w in bench['workloads']
                      if w['name'] == args.workload), None)
        if entry is None:
            raise cells.UnknownName(f'{args.workload!r} is not a workload '
                                    'of BENCHMARK.json')
        metrics = cells.cell_metrics(bench, cell.name, bool(args.trace))
        readers = {m['name']: cells.load_reader(m['name']) for m in metrics}
        mode = cells.load_mode(cell.mode)
    except cells.UnknownName as e:
        return fail(str(e), 2)

    import torch
    chips = entry['chips']
    if not torch.cuda.is_available():
        return fail('no CUDA device: torch.cuda.is_available() is False; '
                    'the benchmark measures the card and has no CPU '
                    'fallback', 3)
    if torch.cuda.device_count() < chips:
        return fail(f'{args.workload} needs {chips} CUDA devices, '
                    f'{torch.cuda.device_count()} visible', 3)

    result = measure(cell, mode, readers, metrics, args.seed, args.seconds,
                     bool(args.trace), chips)
    if isinstance(result, str):
        return fail(result, 5)
    bad = forbidden_modules()
    if bad:
        return fail(f'forbidden modules loaded: {bad}', 4)
    compared = [(k, v['value'], v['limit'])
                for k, v in result['compared'].items()]
    for name, v, lim in compared:
        print(f'compared {name} {v!r} limit {lim!r}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
